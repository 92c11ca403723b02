"""Every card check of the port, then its kernels' times, in one run on a
CUDA card:

    python chip_smoke.py

Runs the ``cuda`` tests (``tests/test_torch_*_cuda.py``,
``tests/test_torch_token_graph.py``, ``tests/test_torch_deepseek_v2.py``)
without the repo's conftest, which imports JAX, then
``cli.time_kernels``, and prints one ``kernels`` line: for each kernel the
launches that the main paths' tests counted in this run (each test's count
of the path it drives, read after its assertions held), beside the rows that
``time_kernels`` measured in this run, ``bound_us`` worked out from their
inputs. Exits non-zero without a card, and if any test fails, errors or
skips. ``pytest -m cuda <file> -k <name>`` runs one area alone.
"""

from __future__ import annotations

import gc
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = ["tests/test_torch_token_graph.py", "tests/test_torch_deepseek_v2.py"]
# each kernel's rows in time_kernels and its launch counters
KERNELS = {"K1": ("decode_attention",), "K2": ("flash_attention_fwd",),
           "K3": ("flash_attention_bwd",), "K4": ("nearest_code",),
           "K5": ("latent_decode",), "K6": ("moe_dispatch", "moe_combine")}


class Tally:
    """Outcomes of the tests, and the launch counts they record."""

    def __init__(self):
        self.passed, self.bad, self.launches = 0, [], {}

    def pytest_runtest_logreport(self, report):
        if report.failed or report.skipped:
            self.bad.append(f"{report.nodeid} {report.when} {report.outcome}")
        elif report.when == "call":
            self.passed += 1
            self.launches.update({report.nodeid: v for k, v in report.user_properties
                                  if k == "launches"})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    tests = os.path.join(ROOT, "tests")
    files = sorted(os.path.join("tests", f) for f in os.listdir(tests)
                   if f.startswith("test_torch_") and f.endswith("_cuda.py")) + TESTS
    import pytest

    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    tally = Tally()
    code = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-m", "cuda", "-q", *files],
                       plugins=[tally])
    print(json.dumps({"tests": files, "exit": int(code), "passed": tally.passed,
                      "failed_or_skipped": tally.bad}), flush=True)
    if code != 0 or tally.bad or not tally.passed:
        return 1
    gc.collect()
    torch.cuda.empty_cache()
    from dyadic_interaction_modeling_tpu_torch.cli import time_kernels

    rows = time_kernels.measure()
    line = [{"kernel": k, "launches_by_test": {
                test: {c: counts[c] for c in counters}
                for test, counts in tally.launches.items() if any(counts[c] for c in counters)},
             "rows": [r for r in rows if r["kernel"].split()[0] == k]}
            for k, counters in KERNELS.items()]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
