"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``src/``
and ``portbench/``.  It needs as many CUDA devices as the cell asks for;
it exits 2 without a result if it finds fewer, if the program is absent,
or if JAX or the JAX package was loaded.  The last line of standard
output is the result, one JSON object; the numbers of the check, each
beside its limit, are the last lines of standard error.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fail(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(2)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout")
    from portbench.harness import cell, manifest
    entry = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    chips = entry["workload"]["chips"]
    if torch.cuda.device_count() < chips:
        fail(f"{args.workload} needs {chips} CUDA devices, found "
             f"{torch.cuda.device_count()}")
    from repro_torch.device import resolve_device
    device = resolve_device("cuda")
    seed = args.seed % (2 ** 63)
    out = cell.run(args.workload, seed, args.seconds, bool(args.trace),
                   device, T_START, cell=entry)
    found = cell.forbidden_modules()
    if found:
        fail(f"loaded modules that a run may not load: {found}")
    print(json.dumps({"setup_parts": out.pop("setup_parts"),
                      "numbers": out.pop("numbers")}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
