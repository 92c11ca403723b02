"""BENCHMARK.json against the benchmark's contract, ``pending.json``'s
entries under the same rules of names, and every workload of both
resolved to its files."""

from __future__ import annotations

import json
import re

import pytest

from conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(spec):
    assert set(spec) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) for p in spec["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in spec["paths"])
    assert len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    named = [w for w in spec["command"] if w.endswith(".py")]
    assert all(any(w.startswith(p + "/") for p in spec["paths"]) for w in named)


@pytest.mark.parametrize("which", ["manifest", "with_pending"])
def test_names_units_and_lines(spec, which):
    if which == "with_pending":
        from portbench.harness.cell import with_pending

        spec = with_pending()
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert m["bound"] is None if m in pending_e2e() else 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in spec[group]]
        assert len(seen) == len(set(seen))
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(spec["workloads"])


def test_every_cell_reports_what_it_must(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] == 0.25
    for w in spec["workloads"]:
        mine = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layers = [m for m in spec["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:
            moved = e2e[m["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]])
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


def pending_e2e() -> list:
    with open(ROOT / "portbench" / "pending.json") as f:
        return json.load(f)["end_to_end"]


def test_pending_cells_are_apart_from_the_manifest(spec):
    from portbench.harness.cell import GROUPS, with_pending

    pending = with_pending()
    for g in GROUPS:
        names = {x["name"] for x in spec[g]}
        assert not names & {x["name"] for x in pending[g][len(spec[g]):]}
    assert {w["name"] for w in spec["workloads"]} < set(CELLS)
    assert set(CELLS) == {w["name"] for w in pending["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_workload_resolves(name, spec):
    from portbench.harness.cell import BENCH, resolve, with_pending

    spec = with_pending()
    cell = resolve(name, spec)
    conf = {c["name"]: c for c in spec["configs"]}[cell.workload["config"]]
    assert (ROOT / conf["file"]).is_file() and conf["file"].startswith("portbench/")
    assert cell.config["name"] == conf["name"] and conf["reduced"] == []
    assert hasattr(cell.entry(), "Session")
    assert hasattr(cell.counts(), "work") and cell.reference() is not None
    assert set(cell.limits["numbers"])
    for trace in (False, True):
        readers = cell.readers(trace)
        assert set(readers) == {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
        assert all(callable(r.read) for r in readers.values())
    assert (BENCH / "traffic" / f"{cell.workload['traffic']}.json").is_file()


def test_no_file_is_named_outside_the_name_alphabet():
    from portbench.harness.cell import BENCH

    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
