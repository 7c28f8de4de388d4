"""AdamW's update as one fused multi-tensor pass on the card, its plain
version, and the written-out formula for the leaves the kernel does not
take.

:func:`update` takes a step's leaves, each a (parameter, gradient, first
moment, second moment), and routes each by what it is:

* all four fp32 on a CUDA device: the kernel (``csrc/adamw.cu``; the design
  note is at its top), many leaves a launch, each element read and written
  once: 28 bytes a parameter;
* all four fp32 on the CPU: :func:`plain`, eager ops with the kernel's
  arithmetic, op for op;
* a DTensor, or a leaf of another dtype: :func:`written_out`, the JAX
  package's formula in new memory.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into ``build/``
at first use (:func:`repro_torch.kernels.topk_compress.build_library`,
cached by the source's digest) and loaded with ``ctypes``; nothing is
built when this module is imported.  A CUDA leaf the kernel does not take
(devices or shapes that differ, moments it cannot write in place) raises.

:func:`update` counts what it did in its attributes: ``launches``;
``fused_leaves`` and ``fused_params`` through the kernel; ``written_leaves``
and ``written_params`` through :func:`plain` or :func:`written_out`.
:func:`reset_counts` sets them to 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import is_dtensor

from . import topk_compress

#: elements a CUDA block takes (the kernel's kChunk, which checks it)
CHUNK = 16384
#: leaves a launch can carry in its parameters (the kernel's kCap)
CAPACITY = 672

_SOURCE = Path(__file__).resolve().parent / "csrc" / "adamw.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of ``adamw_step``: ptrs, n, chunk0, count, scalars,
#: device, stream
SIGNATURE = (_P, _P, _P, _I, _P, _I, _P)
_lib: Optional[ctypes.CDLL] = None

Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Hyper(NamedTuple):
    """A step's scalars as the optimizer computes them: the learning rate
    and the bias corrections ``1 - b ** t`` as 0-dim float32 tensors on the
    CPU, the rest as Python floats."""
    lr: torch.Tensor
    b1: float
    b2: float
    eps: float
    weight_decay: float
    bc1: torch.Tensor
    bc2: torch.Tensor


# ----------------------------------------------------------- formulas --
def plain(p, g, m, v, h: Hyper, in_place: bool):
    """One fp32 leaf's ``(p', m', v')`` as eager ops.  ``in_place``: p' in
    ``g``'s memory, m' and v' in ``m``'s and ``v``'s; otherwise its inputs
    stay as they were.  The kernel's arithmetic, op for op: its reference
    on the card, and the CPU's path."""
    if not in_place:
        g, m, v = g.clone(), m.clone(), v.clone()
    m.mul_(h.b1).add_(torch.mul(g, 1 - h.b1))
    v.mul_(h.b2).add_(torch.square(g, out=g).mul_(1 - h.b2))
    upd = torch.div(m, h.bc1)
    upd.div_(torch.div(v, h.bc2, out=g).sqrt_().add_(h.eps))
    upd.add_(torch.mul(p, h.weight_decay)).mul_(h.lr)
    return torch.sub(p, upd, out=g), m, v


def written_out(p, g, m, v, h: Hyper):
    """The JAX package's formula in new memory, for any dtype and for
    DTensors: ``(p', m', v')`` with p' in ``p``'s dtype, the moments in
    fp32."""
    g32 = g.to(torch.float32)
    m = h.b1 * m + (1 - h.b1) * g32
    v = h.b2 * v + (1 - h.b2) * torch.square(g32)
    upd = (m / h.bc1) / (torch.sqrt(v / h.bc2) + h.eps)
    new_p = (p - h.lr * (upd + h.weight_decay * p.to(torch.float32))
             ).to(p.dtype)
    return new_p, m, v


# ------------------------------------------------------------ planning --
@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch: positions of its leaves in the list planned, and the
    first chunk of each (``chunk0[-1]``: the launch's blocks)."""
    leaves: List[int]
    chunk0: List[int]


def plan_launches(sizes: Sequence[int]) -> List[Launch]:
    """The launches that cover leaves of ``sizes`` elements, in order, at
    most ``CAPACITY`` leaves each; a leaf of no elements is in none."""
    out: List[Launch] = []
    for i, n in enumerate(sizes):
        if not n:
            continue
        if not out or len(out[-1].leaves) == CAPACITY:
            out.append(Launch([], [0]))
        out[-1].leaves.append(i)
        out[-1].chunk0.append(out[-1].chunk0[-1] + -(-n // CHUNK))
    return out


# -------------------------------------------------------------- library --
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the AdamW library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(topk_compress.build_library(_SOURCE)))
        lib.adamw_step.argtypes = SIGNATURE
        lib.adamw_step.restype = _I
        _lib = lib
    return _lib


def _scalars(h: Hyper) -> np.ndarray:
    """The kernel's ``Hyper``: each scalar rounded to float32 as PyTorch's
    ops round it; the bias corrections as their float32 reciprocals (a CUDA
    division by a CPU scalar multiplies by that)."""
    f = np.float32
    return np.array([float(h.lr), h.b1, 1 - h.b1, h.b2, 1 - h.b2,
                     f(1) / f(float(h.bc1)), f(1) / f(float(h.bc2)), h.eps,
                     h.weight_decay], dtype=np.float32)


def _launch(launch: Launch, rows, scalars: np.ndarray, index: int) -> None:
    """Launch the kernel over ``launch``'s rows of ``rows`` (each a leaf's
    p, g, m, v) on ``index``'s current stream."""
    ptrs = np.array([[t.data_ptr() for t in rows[i]] for i in launch.leaves],
                    dtype=np.int64)
    n = np.array([rows[i][0].numel() for i in launch.leaves], dtype=np.int64)
    chunk0 = np.array(launch.chunk0, dtype=np.int64)
    rc = _lib.adamw_step(ptrs.ctypes.data, n.ctypes.data, chunk0.ctypes.data,
                         len(launch.leaves), scalars.ctypes.data, index,
                         torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"adamw_step failed: CUDA error {rc}")


def _check_card_leaf(p, g, m, v, in_place: bool) -> None:
    if not (p.get_device() == g.get_device() == m.get_device()
            == v.get_device() and p.shape == g.shape == m.shape == v.shape):
        raise ValueError(
            f"AdamW's kernel takes a leaf's parameter, gradient and moments "
            f"on one device with one shape, got "
            f"{[(str(t.device), tuple(t.shape)) for t in (p, g, m, v)]}")
    if in_place and not (m.is_contiguous() and v.is_contiguous()):
        raise ValueError("AdamW's kernel updates the moments in their own "
                         "memory, which must be contiguous")


def _on_card(leaves: List[Leaf], h: Hyper, in_place: bool, index: int):
    """``(p', m', v')`` of fp32 leaves on CUDA device ``index``: in place,
    or into copies of the gradients and moments."""
    if _lib is None:
        load_library()
    rows = []
    for p, g, m, v in leaves:
        _check_card_leaf(p, g, m, v, in_place)
        if in_place:
            rows.append((p.contiguous(), g.contiguous(), m, v))
        else:
            rows.append((p.contiguous(), *(
                t.clone(memory_format=torch.contiguous_format)
                for t in (g, m, v))))
    scalars = _scalars(h)
    for launch in plan_launches([r[0].numel() for r in rows]):
        _launch(launch, rows, scalars, index)
        update.launches += 1
    return [r[1:] for r in rows]


def _takes_written_out(p, g, m, v) -> bool:
    return not p.dtype == g.dtype == m.dtype == v.dtype == torch.float32 \
        or any(map(is_dtensor, (p, g, m, v)))


# --------------------------------------------------------------- update --
def update(leaves: Sequence[Leaf], h: Hyper, in_place: bool
           ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(p', m', v')`` of each ``(p, g, m, v)`` in ``leaves``, routed as
    the module's docstring says.  ``in_place`` (gradients of distinct
    memory that the caller does not read again, moments it gives up): an
    fp32 leaf's p' goes into its gradient's memory and m', v' over m and v,
    so nothing parameter-sized is allocated; otherwise, and always on the
    written-out path, the results are new tensors and the inputs stay as
    they were."""
    out: list = [None] * len(leaves)
    cards: dict = {}
    for i, (p, g, m, v) in enumerate(leaves):
        if _takes_written_out(p, g, m, v):
            out[i] = written_out(p, g, m, v, h)
        elif p.device.type == "cuda":
            cards.setdefault(p.get_device(), []).append(i)
            update.fused_leaves += 1
            update.fused_params += p.numel()
            continue
        elif p.device.type == "cpu":
            out[i] = plain(p, g, m, v, h, in_place)
        else:
            raise ValueError(f"AdamW's update takes CPU or CUDA leaves, "
                             f"got one on {p.device}")
        update.written_leaves += 1
        update.written_params += p.numel()
    for index, where in cards.items():
        done = _on_card([leaves[i] for i in where], h, in_place, index)
        for i, res in zip(where, done):
            out[i] = res
    return out


_COUNTS = ("launches", "fused_leaves", "fused_params", "written_leaves",
           "written_params")


def reset_counts() -> None:
    for name in _COUNTS:
        setattr(update, name, 0)


reset_counts()
