"""The harness end to end on the CPU at tiny widths, and ``run.py`` where
it must refuse: no card, or a directory that holds only the benchmark."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import CELLS, ROOT, tiny_cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_on_the_cpu(name, trace):
    from portbench.harness.runner import guard, run_cell

    cell = tiny_cell(name)
    out = run_cell(cell, 2 ** 31 + 77, 0.3, trace, "cpu", time.perf_counter())
    assert out["correct"] is True, out["check"]
    assert list(out)[-1] == "check"
    assert set(out["check"]) == set(cell.limits["numbers"])
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(out["metrics"])
    # on the CPU the trace holds no device operation: the kernel rooflines
    # find nothing to read and are left out
    assert got <= want and ("setup_s" in got or trace)
    assert all(v["value"] >= 0 for v in out["metrics"].values())
    json.dumps(out)
    assert guard() == []


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_run_without_a_card_refuses():
    proc = _run(ROOT)
    assert proc.returncode != 0 and _no_result(proc)
    assert "CUDA device" in proc.stderr


def test_run_with_the_benchmark_alone_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and _no_result(proc)
