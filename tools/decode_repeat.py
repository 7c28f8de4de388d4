#!/usr/bin/env python3
"""The ``decode_topk`` kernel on one case, thousands of times, on a CUDA
card.

    python3 tools/decode_repeat.py [--runs N] [--seed S]

The case is the one ``chip_smoke.check_kernels`` once saw fail: fp32,
shape (9000,), k = 4096 a block of 4096, normal values, so every element
is kept and the third block is partial (808 elements; the encode fills its
4096 slots with those values and the padding zeros).  Two modes, ``--runs``
times each:

- ``fresh``: the sequence ``check_kernels`` runs, from a new draw each
  time: encode, decode, error-feedback encode, dense mask and
  error-feedback dense mask enqueued back to back, each into the buffers
  its wrapper allocates, then the card synchronised;
- ``reused``: one wire (encoded once) decoded into one output buffer
  reused every time, filled with NaN before each decode so that an
  element the kernel leaves unwritten shows.

Each run holds the kernel's decode and the card's plain decode
(``ref.decode_topk_ref`` on the card) against a CPU ``decode_topk_ref`` of
the same wire, and the kernel's wire against the CPU's encode.  It prints
the card, then one JSON object: runs and mismatches by mode and side, and
for the first mismatch of each mode the index, its block, the values and
which side differs from the CPU (``chip_smoke.decode_mismatch``).  It
exits 1 if any run mismatched, 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE, K, BLOCK = (9000,), 4096, 4096


def first_difference(got, want) -> dict:
    """Index, block and both values of the first element where ``got``
    and ``want`` (CPU tensors of one shape) differ bit for bit."""
    import torch
    g, w = got.reshape(-1), want.reshape(-1)
    i = int((g.view(torch.int32) != w.view(torch.int32)).nonzero()[0])
    return {"index": i, "block": i // BLOCK, "got": float(g[i]),
            "cpu": float(w[i])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("decode_repeat: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ref, topk_compress as tk

    dev = torch.device("cuda", 0)
    print(cs.card_line())
    gen = torch.Generator().manual_seed(args.seed)
    out = {"case": {"dtype": "float32", "shape": list(SHAPE), "k": K,
                    "block": BLOCK, "regime": "normal"}, "runs": args.runs}

    def check(mode, d, dp, v, m, tally):
        """Tally the kernel decode ``d`` and the card's plain ``dp`` of the
        wire (v, m) against the CPU's decode of that wire."""
        cpu = ref.decode_topk_ref(v.cpu(), m.cpu(), SHAPE)
        for side, t in (("kernel", d), ("plain", dp)):
            if not cs.bits_equal(t.cpu(), cpu):
                tally[side] += 1
                if tally.get("first") is None:
                    tally["first"] = {"side": side,
                                      **first_difference(t.cpu(), cpu),
                                      "both": cs.decode_mismatch(
                                          d, dp, v, m, SHAPE)}

    t0 = time.perf_counter()
    fresh = {"kernel": 0, "plain": 0, "wire": 0, "first": None}
    for _ in range(args.runs):
        x = torch.randn(SHAPE, generator=gen).to(dev)
        r = torch.randn(SHAPE, generator=gen).to(dev)
        v, m = tk.encode_topk(x, K, BLOCK)
        d = tk.decode_topk(v, m, SHAPE)
        tk.ef_encode_topk(x, r, K, BLOCK)
        tk.blockwise_topk_mask(x, K, BLOCK)
        tk.ef_topk(x, r, K, BLOCK)
        torch.cuda.synchronize()
        dp = ref.decode_topk_ref(v, m, SHAPE)
        vc, mc = ref.encode_topk_ref(x.cpu(), K, BLOCK)
        if not (cs.bits_equal(v.cpu(), vc) and torch.equal(m.cpu(), mc)):
            fresh["wire"] += 1
        check("fresh", d, dp, v, m, fresh)
    out["fresh"] = fresh
    out["fresh_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    reused = {"kernel": 0, "plain": 0, "first": None}
    x = torch.randn(SHAPE, generator=gen).to(dev)
    v, m = tk.encode_topk(x, K, BLOCK)
    buf = torch.empty(SHAPE, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = tk.load_library()
    for _ in range(args.runs):
        buf.fill_(float("nan"))
        rc = lib.topk_decode(v.data_ptr(), m.data_ptr(), buf.data_ptr(),
                             buf.numel(), v.shape[0], BLOCK, K, 0,
                             dev.index, stream)
        if rc != 0:
            raise RuntimeError(f"topk_decode failed: CUDA error {rc}")
        dp = ref.decode_topk_ref(v, m, SHAPE)
        torch.cuda.synchronize()
        check("reused", buf, dp, v, m, reused)
    out["reused"] = reused
    out["reused_s"] = time.perf_counter() - t0
    out["card"] = cs.card_line()
    out["torch"] = torch.__version__
    print(json.dumps(out))
    bad = fresh["kernel"] + fresh["plain"] + fresh["wire"] \
        + reused["kernel"] + reused["plain"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
