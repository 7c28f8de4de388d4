"""Start the ranks of one program, each in a process of its own, joined by a
``torch.distributed`` process group: what the gspmd step needs to run
sharded over a process mesh (``launch.mesh.make_process_mesh``).

    results = run(fn, 4, rdv_dir=tmp, device="cpu")

calls ``fn(rank, device, *args)`` in each of 4 spawned processes after
``init_process_group``, and returns what each returned, by rank.  The
rendezvous is a file under ``rdv_dir`` (``file://``), so runs side by side
share no TCP port.  ``backend`` is the group's (``"gloo"`` carries CPU
tensors, and some of CUDA tensors' collectives through host memory) or
:data:`STAGED`, whose group stages every collective's tensors through
pinned host memory into gloo (:class:`HostStagedGroup`, which counts the
bytes it stages, and carries point-to-point ``send`` / ``recv`` the same
way).  Every rank
gets the same ``device``: several ranks may share one card.  Every wait has
a timeout; a rank that raises makes :func:`run` stop the others and raise
with that rank's traceback.  The ranks talk over the loopback interface
(``GLOO_SOCKET_IFNAME=lo`` unless the caller set it): they share one host.
"""
from __future__ import annotations

import collections
import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


STAGED = "gloo_host_staged"

# bytes and calls by collective that HostStagedGroup carried, this process
_staged = collections.Counter()


def staged_counts() -> dict:
    """``{"<collective>_bytes": n, "<collective>_calls": n}`` this process's
    :class:`HostStagedGroup` carried since the last reset (``send`` and
    ``recv`` among them); the bytes are those copied between the device
    and the host (inputs out, outputs back, both ways for an in-place
    collective)."""
    return dict(_staged)


def reset_staged_counts() -> None:
    _staged.clear()


def _as_done_work(result):
    from torch._C._distributed_c10d import _create_work_from_future
    from torch.futures import Future
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class HostStagedGroup(dist.ProcessGroup):
    """A process group for CUDA tensors that runs each collective on gloo
    through host memory: the inputs are copied into pinned host buffers, a
    gloo group of the same ranks runs the collective on them, the outputs
    are copied back, and the call returns a finished work.  The
    collectives DTensor redistributes with (all-gather, reduce-scatter,
    all-reduce, all-to-all), those that place tensors (broadcast,
    scatter, barrier) and point-to-point ``send`` / ``recv`` (a message
    matched by its tag, as gloo matches it) are carried; each counts the
    bytes it staged, and waits at most the group's timeout.  On CPU
    tensors the staging is a copy, which is how the tests drive it."""

    def __init__(self, opts, _backend_options=None):
        super().__init__(opts.group_rank, opts.group_size)
        self._name = opts.group_id
        self._timeout = opts.timeout
        self._gloo = dist.ProcessGroupGloo(
            dist.PrefixStore("host_staged/", opts.store), opts.group_rank,
            opts.group_size, opts.timeout)

    @property
    def group_name(self) -> str:
        return self._name

    def getBackendName(self):                      # noqa: N802 (torch's)
        return STAGED

    @staticmethod
    def _pinned(t: torch.Tensor) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=t.device.type == "cuda")

    def _run(self, name: str, outs, ins, call, in_place: bool = False):
        """``call(host outputs, host inputs)`` on host copies: the inputs
        (and, for an in-place collective, the outputs) are copied to the
        host, the outputs copied back.  Counts those bytes."""
        h_in = [self._pinned(t).copy_(t) for t in ins]
        h_out = [self._pinned(t).copy_(t) if in_place else self._pinned(t)
                 for t in outs]
        call(h_out, h_in).wait(self._timeout)
        for t, h in zip(outs, h_out):
            t.copy_(h)
        moved = list(ins) + list(outs) * (2 if in_place else 1)
        _staged[f"{name}_calls"] += 1
        _staged[f"{name}_bytes"] += sum(t.numel() * t.element_size()
                                        for t in moved)
        return _as_done_work(list(outs))

    def allreduce(self, tensors, opts):
        return self._run("all_reduce", tensors, [],
                         lambda o, _: self._gloo.allreduce(o, opts),
                         in_place=True)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts):
        return self._run("all_gather", outputs, inputs, lambda o, i: _last(
            [self._gloo._allgather_base(a, b, opts) for a, b in zip(o, i)]))

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts):
        return self._run("reduce_scatter", outputs, inputs, lambda o, i: _last(
            [self._gloo._reduce_scatter_base(a, b, opts)
             for a, b in zip(o, i)]))

    def _allgather_base(self, output, input, opts):   # noqa: A002
        return self.allgather_into_tensor_coalesced([output], [input], opts)

    def _reduce_scatter_base(self, output, input, opts):   # noqa: A002
        return self.reduce_scatter_tensor_coalesced([output], [input], opts)

    all_gather_single = _allgather_base
    reduce_scatter_single = _reduce_scatter_base

    def all_to_all_single(self, output, input, out_splits, in_splits,  # noqa: A002
                          opts):
        return self._run("all_to_all", [output], [input],
                         lambda o, i: self._gloo.alltoall_base(
                             o[0], i[0], out_splits, in_splits, opts))

    alltoall_base = all_to_all_single

    def broadcast(self, tensors, opts):
        return self._run("broadcast", tensors, [],
                         lambda o, _: self._gloo.broadcast(o, opts),
                         in_place=True)

    def allgather(self, output_lists, inputs, opts):
        flat = [t for lst in output_lists for t in lst]
        n = len(output_lists[0])

        def call(o, i):
            return self._gloo.allgather(
                [o[k * n:(k + 1) * n] for k in range(len(output_lists))],
                i, opts)
        return self._run("all_gather", flat, inputs, call)

    def scatter(self, outputs, input_lists, opts):
        flat = [t for lst in input_lists for t in lst]
        return self._run("scatter", outputs, flat,
                         lambda o, i: self._gloo.scatter(
                             o, [i] if flat else [], opts))

    def send(self, tensors, dst, tag):
        return self._run("send", [], tensors,
                         lambda _, i: self._gloo.send(i, dst, tag))

    def recv(self, tensors, src, tag):
        return self._run("recv", tensors, [],
                         lambda o, _: self._gloo.recv(o, src, tag))

    def barrier(self, opts):
        self._gloo.barrier(opts).wait()
        return _as_done_work(None)


def _last(works):
    for w in works[:-1]:
        w.wait()
    return works[-1]


def _register_staged() -> None:
    """Make :data:`STAGED` a backend torch knows, for CUDA tensors and
    (to drive it on a host without a card) CPU tensors."""
    if STAGED.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(STAGED, HostStagedGroup,
                                      extended_api=True,
                                      devices=["cpu", "cuda"])


def _rank_main(fn, rank, world, init_method, backend, device, timeout,
               args, out):
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if backend == STAGED:
            _register_staged()
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        # the host's cores shared out among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:                       # noqa: BLE001
        out.put((rank, False, traceback.format_exc()))


def _failures(world: int, failed: dict, out, grace: float = 3.0) -> str:
    """The tracebacks of the ranks that failed within ``grace`` seconds of
    the first, by rank: a rank that raises breaks its peers' collectives,
    and the report names it beside them."""
    end = time.monotonic() + grace
    while time.monotonic() < end:
        try:
            rank, ok, value = out.get(timeout=max(0.01,
                                                  end - time.monotonic()))
        except queue_mod.Empty:
            break
        if not ok:
            failed[rank] = value
    return "\n".join(f"spmd: rank {r} of {world} failed:\n{failed[r]}"
                     for r in sorted(failed))


def run(fn: Callable[..., Any], world: int, *, rdv_dir: str,
        backend: str = "gloo", device: DeviceLike = "cuda",
        timeout: float = 600.0, args: Sequence[Any] = ()) -> List[Any]:
    """``fn(rank, device, *args)`` on ``world`` ranks; their results by
    rank.  ``fn`` and ``args`` must pickle (``fn`` a module-level
    function).  ``timeout`` bounds the process group's collectives and the
    whole run.  A rank that raises makes it
    raise ``RuntimeError`` with the traceback of every rank that failed."""
    os.makedirs(rdv_dir, exist_ok=True)
    rdv = tempfile.mkdtemp(prefix="rdv-", dir=rdv_dir)
    init_method = f"file://{os.path.join(rdv, 'store')}"
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, init_method, backend,
                               str(device), timeout, tuple(args),
                               out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spmd: {world - len(results)} of {world} "
                                   f"ranks gave no result in {timeout} s")
            try:
                rank, ok, value = out.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"spmd: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(_failures(world, {rank: value}, out))
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        out.close()
    return [results[r] for r in range(world)]
