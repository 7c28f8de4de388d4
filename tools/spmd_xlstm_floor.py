#!/usr/bin/env python3
"""``chip_smoke.py``'s spmd-xlstm phase at another depth, with the fp32
floor of step 1 as well, or with a fault planted, on a CUDA card.

    python3 tools/spmd_xlstm_floor.py [--layers N] [--train-floor]
        [--control tf32-serving] [--control b-rows]

The phase (``chip_smoke.run_spmd_xlstm_path``: xlstm-1.3b at full width
on 4 ranks of a ``(2, 2)`` process mesh that share the card) runs at
``--layers`` of its 48 layers (default ``chip_smoke.SPMD_XLSTM_LAYERS``),
its rank 0 serving in float64 as the phase does.  ``--train-floor`` has
rank 0 also run step 1 unsharded in float64, so the report holds step 1's
fp32 floor (``train_floor``: the unsharded fp32 step's loss, ``grad_norm``
and parameters against float64) and the sharded step's own distance from
float64 (``rel_gaps64``).  A ``--control`` plants a fault in the ranks'
sharded run (the unsharded reference runs as it is), to show that a gate
fails a program less exact than the phase's:

- ``tf32-serving``: the sharded prefill and decode steps run their fp32
  matmuls in TF32 (``torch.backends.cuda.matmul.allow_tf32``), which the
  float64 criterion of the served numbers (``chip_smoke.within``) must
  fail;
- ``b-rows``: the sLSTM's time loop takes each rank's gradient of the
  bias ``b`` as the whole gradient where it covers only the rank's batch
  rows (its ``Partial`` on ``data`` read as ``Replicate``), which the
  bias leaf's gate (``chip_smoke.SPMD_NOISE_RESIDUAL``) must fail.

It prints the phase's report line (``spmd-xlstm path: {...}``), then
``gates passed`` or ``gates failed: ...``, and exits 0 when the gates
passed without a control or failed with one, 1 otherwise, 2 without a
card.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

# the options reach the spawned ranks through the environment
LAYERS = int(os.environ.get("SPMD_XLSTM_FLOOR_LAYERS",
                            chip_smoke.SPMD_XLSTM_LAYERS))
FLOORS = tuple(os.environ.get("SPMD_XLSTM_FLOOR_FLOORS", "serve").split(","))
CONTROLS = tuple(c for c in os.environ.get("SPMD_XLSTM_FLOOR_CONTROLS",
                                           "").split(",") if c)
chip_smoke.SPMD_XLSTM_LAYERS = LAYERS


def tf32_serving() -> None:
    """``build_jitted``'s prefill and decode steps with TF32 matmuls."""
    import torch
    from repro_torch.distributed import steps
    build = steps.build_jitted

    def planted(cfg, mesh, shape, *args, **kwargs):
        fn, fn_args, meta = build(cfg, mesh, shape, *args, **kwargs)
        if shape.kind == "train":
            return fn, fn_args, meta

        def in_tf32(*xs):
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn(*xs)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return in_tf32, fn_args, meta
    steps.build_jitted = planted


def b_rows() -> None:
    """The sLSTM loop's gradient of ``b`` (its third argument) read as
    whole where each rank's covers only its rows."""
    from torch.distributed.tensor import Replicate
    from repro_torch.distributed import sharding
    from repro_torch.models import xlstm
    on_shards = sharding.on_shards

    def planted(fn, out_placements, *args, in_grad_placements=None):
        if fn is xlstm._slstm_loop and in_grad_placements is not None:
            grads = list(in_grad_placements)
            grads[2] = [Replicate() if p.is_partial() else p
                        for p in grads[2]]
            in_grad_placements = grads
        return on_shards(fn, out_placements, *args,
                         in_grad_placements=in_grad_placements)
    sharding.on_shards = planted


def rank(rank, dev):
    """One rank of the phase, with the controls planted."""
    for name in CONTROLS:
        {"tf32-serving": tf32_serving, "b-rows": b_rows}[name]()
    return chip_smoke.spmd_lm_rank(
        rank, dev, chip_smoke.spmd_xlstm_cfg(),
        (chip_smoke.XLSTM_TRAIN_BATCH, chip_smoke.XLSTM_TRAIN_SEQ),
        {"default": (None, chip_smoke.SPMD_XLSTM_STEPS)},
        (chip_smoke.SPMD_SERVE_BATCH, chip_smoke.SPMD_PROMPT,
         chip_smoke.SPMD_CACHE_LEN, chip_smoke.SPMD_NEW),
        noise=(chip_smoke.SPMD_XLSTM_NOISE_LEAF,
               chip_smoke.SPMD_XLSTM_NOISE_ROW), floors=FLOORS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=LAYERS)
    ap.add_argument("--train-floor", action="store_true")
    ap.add_argument("--control", action="append", default=[],
                    choices=("tf32-serving", "b-rows"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("spmd_xlstm_floor: no CUDA device", file=sys.stderr)
        return 2
    os.environ["SPMD_XLSTM_FLOOR_LAYERS"] = str(args.layers)
    os.environ["SPMD_XLSTM_FLOOR_FLOORS"] = \
        "train,serve" if args.train_floor else "serve"
    os.environ["SPMD_XLSTM_FLOOR_CONTROLS"] = ",".join(args.control)
    chip_smoke.SPMD_XLSTM_LAYERS = args.layers
    from repro_torch.device import resolve_device
    print(chip_smoke.card_line())
    print(f"xlstm-1_3b at {args.layers} of 48 layers; floors "
          f"{os.environ['SPMD_XLSTM_FLOOR_FLOORS']}; controls "
          f"{args.control or 'none'}", flush=True)
    cfg = chip_smoke.spmd_xlstm_cfg()
    try:
        chip_smoke.run_spmd_lm_path(
            resolve_device("cuda"), "spmd-xlstm", rank,
            (chip_smoke.XLSTM_TRAIN_BATCH, chip_smoke.XLSTM_TRAIN_SEQ),
            (chip_smoke.SPMD_SERVE_BATCH, chip_smoke.SPMD_PROMPT,
             chip_smoke.SPMD_CACHE_LEN, chip_smoke.SPMD_NEW),
            f"{cfg.n_layers} of 48 layers; full width")
    except AssertionError as e:
        print(f"gates failed: {e}")
        return 0 if args.control else 1
    print("gates passed")
    return 1 if args.control else 0


if __name__ == "__main__":
    sys.exit(main())
