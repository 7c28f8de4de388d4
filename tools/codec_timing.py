#!/usr/bin/env python3
"""Host time of the codec wrappers, and device time by kind of input, on
a CUDA card.

    python3 tools/codec_timing.py [--src DIR] [--reps N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``;
point it at another tree's ``src`` to measure that tree's wrappers, built
into that tree's ``build/``) and prints one JSON object:

- ``host_us``: the host time in microseconds per call of each of the five
  wrappers, and of each step a wrapper call has taken, timed alone:
  ``perf_counter_ns`` around ``--reps`` calls enqueued back to back at the
  training path's boundary shape ``(8, 128, 1600)`` fp32 with k = 41 a
  block; the card is synchronised before and after the loop, not inside
  it.  The ctypes steps call the tree's own library (the launch included),
  with the argument list its entries take.
- ``device_us``: the kernels' device time per launch (profiler) of
  ``encode_topk`` and ``blockwise_topk_mask`` at ``(8, 128, 1600)`` and
  ``(8, 128, 50432)`` fp32, k = 41, on normal values and on inputs whose
  blocks select differently: all zeros, five levels (-1, -0.5, 0, 0.5, 1:
  heavy ties), and 1 + i ulp (4096 distinct magnitudes sharing their top
  20 bits).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path


def per_call_us(fn, reps: int) -> float:
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / reps / 1e3


def kernel_us(fn, pattern: str, reps: int = 20) -> float:
    """Device time per launch of the kernel whose name holds ``pattern``,
    from the profiler's CUDA activity (``nan`` where it saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = getattr(ev, "cuda_time_total", 0)
        if pattern in ev.key and total and ev.count:
            return total / ev.count
    return float("nan")


def by_input(tk, dev) -> dict:
    """Kernel device time per launch by kind of input (see the module
    note)."""
    import torch
    out = {}
    for shape in ((8, 128, 1600), (8, 128, 50432)):
        n = math.prod(shape)
        gen = torch.Generator(device=dev).manual_seed(0)
        inputs = {
            "normal": torch.randn(shape, device=dev, generator=gen),
            "zeros": torch.zeros(shape, device=dev),
            "ties": torch.randint(0, 5, shape, device=dev,
                                  generator=gen).float() * 0.5 - 1.0,
            "ulp": 1 + (torch.arange(n, device=dev) % 4096).float()
            .reshape(shape) * 2.0 ** -23}
        for name, x in inputs.items():
            key = f"{shape[2]}/{name}"
            out[key] = {
                "encode_topk": kernel_us(lambda: tk.encode_topk(x, 41),
                                         "encode_kernel"),
                "blockwise_topk_mask": kernel_us(
                    lambda: tk.blockwise_topk_mask(x, 41), "dense_kernel")}
        del inputs
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=500)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("codec_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ref, topk_compress as tk

    shape = (8, 128, 1600)
    block, k = 4096, 41
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(shape, device=dev)
    r = torch.randn(shape, device=dev)
    n = math.prod(shape)
    nb = -(-n // block)
    v, m = tk.encode_topk(x, k, block)
    out = torch.empty_like(x)
    lib = tk.load_library()
    index = x.get_device()
    stream = torch.cuda.current_stream().cuda_stream

    def c_args(fn, ptrs):
        """The tree's entry takes the device index before the stream or
        not: its argument count says."""
        tail = [n, nb, block, k, 0]
        if len(fn.argtypes) == len(ptrs) + len(tail) + 2:
            tail.append(index)
        return [*ptrs, *tail, stream]

    enc_args = c_args(lib.topk_encode, [x.data_ptr(), v.data_ptr(),
                                        m.data_ptr()])
    dec_args = c_args(lib.topk_decode, [v.data_ptr(), m.data_ptr(),
                                        out.data_ptr()])

    def guard():
        with torch.cuda.device(x.device):
            pass

    steps = {
        "wrapper encode_topk": lambda: tk.encode_topk(x, k, block),
        "wrapper decode_topk": lambda: tk.decode_topk(v, m, shape),
        "wrapper ef_encode_topk": lambda: tk.ef_encode_topk(x, r, k, block),
        "wrapper blockwise_topk_mask":
            lambda: tk.blockwise_topk_mask(x, k, block),
        "wrapper ef_topk": lambda: tk.ef_topk(x, r, k, block),
        "ctypes call + launch, encode": lambda: lib.topk_encode(*enc_args),
        "ctypes call + launch, decode": lambda: lib.topk_decode(*dec_args),
        "dtype and block checks, k clamp": lambda: (
            ref.check_codec_dtype(x), tk._check_block(block),
            tk._clamp_k(k, block)),
        "x.device.type == 'cpu'": lambda: x.device.type == "cpu",
        "x.is_cuda": lambda: x.is_cuda,
        "x.reshape(-1).contiguous()": lambda: x.reshape(-1).contiguous(),
        "x.contiguous()": lambda: x.contiguous(),
        "torch.empty x2 (dtype, device=x.device)": lambda: (
            torch.empty((nb, k), dtype=x.dtype, device=x.device),
            torch.empty((nb, block // 32), dtype=torch.int32,
                        device=x.device)),
        "x.new_empty x2": lambda: (
            x.new_empty((nb, k)),
            x.new_empty((nb, block >> 5), dtype=torch.int32)),
        "torch.cuda.device(x.device) guard": guard,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "x.get_device() + raw stream": lambda: torch._C.
            _cuda_getCurrentRawStream(x.get_device()),
        "data_ptr x3": lambda: (x.data_ptr(), v.data_ptr(), m.data_ptr()),
        "out.reshape(shape)": lambda: out.reshape(shape),
        "tuple(int(s) for s in shape)": lambda: tuple(int(s) for s in shape),
        "empty loop": lambda: None,
    }
    result = {"src": str(Path(args.src).resolve()), "shape": list(shape),
              "k_per_block": k, "reps": args.reps,
              "device": torch.cuda.get_device_name(0),
              "host_us": {name: per_call_us(fn, args.reps)
                          for name, fn in steps.items()},
              "device_us": by_input(tk, dev)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
