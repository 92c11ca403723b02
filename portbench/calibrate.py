#!/usr/bin/env python3
"""Readings from which a cell's correctness limits are set, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--controls 3]

For every seed: set-up as a run makes it, the checked part of a run (a
training cell's three steps; a generate cell's greedy and sampled calls),
then the numbers of ``limits/<cell>.json`` for the program against the
reference.
For the first ``--controls`` seeds also the control (the reference in the
precision the configuration names under ``control``, put in the program's
place) and, for a training cell, the reference with its loss taken over
half of each batch. One JSON line a seed on standard output. It also
takes the cells of ``pending.json``. Not run by the benchmark's runs; ``tests/test_portbench_control.py`` drives it on the
card."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def detail(prog: dict, ref: dict, k: int = 4) -> dict:
    """Where a training cell's numbers come from: each step's loss on both
    sides, and the leaves with the widest gaps (program norm, reference
    norm, gap)."""
    import statistics

    out = {"losses": [prog["losses"], ref["losses"]]}
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        gaps = sorted(((abs(prog[key].get(n, 0.0) - r) / max(r, med), n, prog[key].get(n), r)
                       for n, r in ref[key].items()), reverse=True)[:k]
        out[key] = {"median": med, "worst": gaps}
    return out


def readings(cell, seed: int, device: str, controls: bool, details: bool = False) -> dict:
    import torch

    from portbench.entries.training import compare
    from portbench.harness.runner import Ctx

    ctx = Ctx(device=device, seed=seed, config=cell.config, traffic=cell.traffic)
    sess = cell.entry().Session(ctx)
    sess.warm()
    ctrl = cell.config["control"]
    out = {"seed": seed}
    if sess.kind == "train":
        sess.release()
        ref = sess.reference_readings()
        out["program"] = compare(sess.prog, ref)
        if details:
            out["detail"] = detail(sess.prog, ref)
        if controls:
            out["control"] = compare(sess.reference_readings(ctrl), ref)
            out["half_batch"] = compare(sess.reference_readings(half=True), ref)
    else:
        every = cell.traffic["greedy_every"]
        for i in range(cell.traffic["check_calls"]):  # a greedy and a sampled call each
            sess.step(i * every)
            sess.step(i * every + 1)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        sess.release()
        got = sess.readings((ctrl,) if controls else ())
        out["program"] = {k: v for k, v in got.items() if "." not in k}
        if controls:
            out["control"] = {k.split(".")[0]: v for k, v in got.items() if "." in k}
    del sess
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--detail", action="store_true",
                    help="a training cell's losses and widest leaves too")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(2)
    from portbench.harness.cell import resolve, with_pending

    cell = resolve(args.workload, with_pending())
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(cell, seed, args.device, i < args.controls, args.detail)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
