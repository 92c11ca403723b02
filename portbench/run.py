#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card it is started on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic mix,
reference, limits and metrics are found by name from ``BENCHMARK.json``
(``harness/cell.py``). The last line of standard output is the result's
JSON object; the numbers the check compared, each beside its limit, are the
last lines of standard error. It exits non-zero and prints no result when
there is no CUDA device or fewer than the cell asks for, when the program
is missing, or when JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"
# every cache a run may fill lives at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(CACHE / "torch_kernels"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(2)  # the card does the work: few host threads to contend
    from portbench.harness.cell import resolve
    from portbench.harness.runner import guard, power_limit, run_cell

    cell = resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = guard()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"portbench: {cell.name} seed {args.seed} on {power_limit()}", file=sys.stderr)
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
