"""Hopper blockwise Top-K kernels: the wire codec (encode, error-feedback
encode, decode) and the dense masks (plain and error-feedback).

The port's counterparts of the five Pallas kernels in the JAX package's
``kernels/topk_compress.py``: ``encode_topk``, ``ef_encode_topk``,
``decode_topk``, ``blockwise_topk_mask`` and ``ef_topk``.  The CUDA source
is ``csrc/topk_codec.cu`` (one CTA per 4096-element block; the design note
is at its top).  It is compiled with ``nvcc`` for ``sm_90a``
into ``build/`` at the repository root on first use and loaded with
``ctypes``; nothing is built when this module is imported.

Each wrapper takes the plain version in :mod:`repro_torch.kernels.ref` for a
tensor on the CPU, and only then.  For a CUDA tensor it launches its kernel
on the current stream or raises; a failed build or launch raises.  Each
wrapper counts its launches in its ``launches`` attribute
(:func:`reset_launch_counts` sets them to 0).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import ref

DEFAULT_BLOCK = 4096        # elements per block, as in the JAX package
MAX_BLOCK = 4096            # the CUDA kernels stage one block in shared memory

_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SOURCE = Path(__file__).resolve().parent / "csrc" / "topk_codec.cu"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lib: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    """``build/`` at the repository root (``src/repro_torch/kernels`` up
    three levels)."""
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build_library(source: Path = _SOURCE) -> Path:
    """Compile ``source`` (by default ``csrc/topk_codec.cu``) unless a
    library built from the same source bytes is already in ``build/``.
    Returns the library's path; the compiler's resource report (``-Xptxas
    -v``) goes to the ``.log`` beside it."""
    src = source.read_bytes()
    digest = hashlib.sha1(src).hexdigest()[:12]
    out = build_dir() / f"lib{source.stem}-{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)            # atomic: concurrent builds agree
    return out


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GEOMETRY = (_LL, _I, _I, _I, _I, _I, _P)   # n, nb, block, k, kind,
#                                             device, stream
#: argument types of the C entries of ``csrc/topk_codec.cu``, in the order
#: of their prototypes: the tensors' pointers, then ``_GEOMETRY``.  Each
#: returns a C int (0 or a CUDA error code).
SIGNATURES = {"topk_encode": (_P, _P, _P) + _GEOMETRY,
              "topk_ef_encode": (_P, _P, _P, _P, _P) + _GEOMETRY,
              "topk_decode": (_P, _P, _P) + _GEOMETRY,
              "topk_mask_dense": (_P, _P) + _GEOMETRY,
              "topk_ef_dense": (_P, _P, _P, _P) + _GEOMETRY}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the codec library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = _I
        _lib = lib
    return _lib


def _clamp_k(k_per_block: int, block: int) -> int:
    return int(min(max(k_per_block, 1), block))


def _check_block(block: int) -> None:
    if block % 32:
        raise ValueError(f"block must be a multiple of 32, got {block}")


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{what} must be a CPU or CUDA tensor, got "
                         f"{t.device}")
    return False


def _check_card_block(block: int) -> None:
    if block > MAX_BLOCK:
        raise ValueError(f"the CUDA kernels take blocks of at most "
                         f"{MAX_BLOCK} elements, got {block}")


def _check_residual(x: torch.Tensor, residual: torch.Tensor) -> None:
    """On the card the residual must be laid out as ``x`` is: the kernels
    read both with one dtype and one index."""
    if residual.dtype != x.dtype or residual.shape != x.shape \
            or residual.get_device() != x.get_device():
        raise ValueError(
            f"residual must have x's dtype, shape and device "
            f"({x.dtype} {tuple(x.shape)} on {x.device}), got "
            f"{residual.dtype} {tuple(residual.shape)} on {residual.device}")


def _launch(name: str, t: torch.Tensor, *args) -> None:
    """Call the C entry ``name`` with ``args``, then the dtype kind, the
    device index of ``t`` and the raw handle of that device's current
    stream; raise on a non-zero return code."""
    lib = _lib if _lib is not None else load_library()
    index = t.get_device()
    rc = getattr(lib, name)(*args, _KIND[t.dtype], index,
                            torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def encode_topk(x: torch.Tensor, k_per_block: int,
                block: int = DEFAULT_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wire encode: (values (nb, k) in index order, bitmap (nb, B/32) int32
    words carrying the uint32 bits).  Exactly k slots per block."""
    ref.check_codec_dtype(x)
    _check_block(block)
    k = _clamp_k(k_per_block, block)
    if not _on_card(x, "x"):
        return ref.encode_topk_ref(x, k, block)
    _check_card_block(block)
    x = x.contiguous()
    n = x.numel()
    nb = -(-n // block)
    values = x.new_empty((nb, k))
    bitmap = x.new_empty((nb, block >> 5), dtype=torch.int32)
    if n:
        _launch("topk_encode", x, x.data_ptr(), values.data_ptr(),
                bitmap.data_ptr(), n, nb, block, k)
        encode_topk.launches += 1
    return values, bitmap


def ef_encode_topk(x: torch.Tensor, residual: torch.Tensor, k_per_block: int,
                   block: int = DEFAULT_BLOCK
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback wire encode of ``c = x + residual`` (rounded to the
    storage dtype): (values, bitmap) as :func:`encode_topk` gives for ``c``,
    and the new residual, ``c`` where not kept and +0 where kept, shaped
    like ``x``."""
    ref.check_codec_dtype(x)
    _check_block(block)
    k = _clamp_k(k_per_block, block)
    if not _on_card(x, "x"):
        return ref.ef_encode_topk_ref(x, residual, k, block)
    _check_card_block(block)
    _check_residual(x, residual)
    x, residual = x.contiguous(), residual.contiguous()
    n = x.numel()
    nb = -(-n // block)
    values = x.new_empty((nb, k))
    bitmap = x.new_empty((nb, block >> 5), dtype=torch.int32)
    new_r = torch.empty_like(x)
    if n:
        _launch("topk_ef_encode", x, x.data_ptr(), residual.data_ptr(),
                values.data_ptr(), bitmap.data_ptr(), new_r.data_ptr(), n,
                nb, block, k)
        ef_encode_topk.launches += 1
    return values, bitmap, new_r


def decode_topk(values: torch.Tensor, bitmap: torch.Tensor,
                shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`encode_topk`: dense tensor of ``shape``."""
    ref.check_codec_dtype(values)
    if not _on_card(values, "values"):
        return ref.decode_topk_ref(values, bitmap, tuple(shape))
    nb, k = values.shape
    bnb, words = bitmap.shape
    block = words * 32
    n = math.prod(shape)
    if bitmap.get_device() != values.get_device() \
            or bitmap.dtype != torch.int32 or bnb != nb:
        raise ValueError(f"bitmap must be int32 ({nb}, B/32) on "
                         f"{values.device}, got {bitmap.dtype} "
                         f"{tuple(bitmap.shape)} on {bitmap.device}")
    if block > MAX_BLOCK or not 1 <= k <= block or n > nb * block:
        raise ValueError(f"bad codec geometry: nb={nb} k={k} block={block} "
                         f"for shape {tuple(shape)}")
    out = values.new_empty(shape)
    if n:
        values, bitmap = values.contiguous(), bitmap.contiguous()
        _launch("topk_decode", values, values.data_ptr(), bitmap.data_ptr(),
                out.data_ptr(), n, nb, block, k)
        decode_topk.launches += 1
    return out


def blockwise_topk_mask(x: torch.Tensor, k_per_block: int,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Dense blockwise Top-K: ``x`` with every element below its block's
    k-th largest magnitude zeroed (threshold ties all kept)."""
    ref.check_codec_dtype(x)
    _check_block(block)
    k = _clamp_k(k_per_block, block)
    if not _on_card(x, "x"):
        return ref.blockwise_topk_mask_ref(x, k, block)
    _check_card_block(block)
    x = x.contiguous()
    n = x.numel()
    out = torch.empty_like(x)
    if n:
        _launch("topk_mask_dense", x, x.data_ptr(), out.data_ptr(), n,
                -(-n // block), block, k)
        blockwise_topk_mask.launches += 1
    return out


def ef_topk(x: torch.Tensor, residual: torch.Tensor, k_per_block: int,
            block: int = DEFAULT_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback dense Top-K of ``c = x + residual`` (rounded to the
    storage dtype): ``(sent, c - sent)``, ``sent`` as
    :func:`blockwise_topk_mask` gives for ``c``."""
    ref.check_codec_dtype(x)
    _check_block(block)
    k = _clamp_k(k_per_block, block)
    if not _on_card(x, "x"):
        return ref.ef_topk_ref(x, residual, k, block)
    _check_card_block(block)
    _check_residual(x, residual)
    x, residual = x.contiguous(), residual.contiguous()
    n = x.numel()
    sent, new_r = torch.empty_like(x), torch.empty_like(x)
    if n:
        _launch("topk_ef_dense", x, x.data_ptr(), residual.data_ptr(),
                sent.data_ptr(), new_r.data_ptr(), n, -(-n // block), block,
                k)
        ef_topk.launches += 1
    return sent, new_r


#: every kernel's wrapper, by name; each counts its launches
KERNELS = {"encode_topk": encode_topk, "ef_encode_topk": ef_encode_topk,
           "decode_topk": decode_topk,
           "blockwise_topk_mask": blockwise_topk_mask, "ef_topk": ef_topk}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


reset_launch_counts()
