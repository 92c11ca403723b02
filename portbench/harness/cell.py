"""What a cell is made of, found by name from ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the entry that mix drives
(``entries/<entry>.py``), the configuration's plain reference
(``reference/<config>.py``) and work counts (``counts/<config>.py``), the
limits of its correctness check (``limits/<cell>.json``) and one reader
per metric (``metrics/<metric>.py``). ``pending.json`` holds cells built
but not yet in the manifest; ``run.py`` runs only the manifest's."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
PENDING = BENCH / "pending.json"
GROUPS = ("configs", "workloads", "end_to_end", "per_layer")


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def with_pending() -> dict:
    """The manifest with the entries of ``pending.json`` added."""
    spec, pending = manifest(), read_json(PENDING)
    return dict(spec, **{g: spec[g] + pending[g] for g in GROUPS})


def package_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` imported as ``portbench.<kind>.<name>``
    (entries, references and counts may import their neighbours)."""
    return importlib.import_module(f"{BENCH.name}.{kind}.{name}")


def file_module(path: Path) -> ModuleType:
    """A reader whose file name holds dots (``metrics/mfu.gen.py``)."""
    spec = importlib.util.spec_from_file_location(
        f"{BENCH.name}_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def entry(self) -> ModuleType:
        return package_module("entries", self.traffic["entry"])

    def reference(self) -> ModuleType:
        return package_module("reference", self.config["name"])

    def counts(self) -> ModuleType:
        return package_module("counts", self.config["name"])

    def readers(self, trace: bool) -> Dict[str, ModuleType]:
        metrics = self.per_layer if trace else self.end_to_end
        return {m["name"]: file_module(BENCH / "metrics" / f"{m['name']}.py") for m in metrics}


def resolve(name: str, spec: dict = None) -> Cell:
    """The cell named ``name`` of the manifest (or of ``spec``)."""
    spec = manifest() if spec is None else spec
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name}")
    w = work[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = read_json(BENCH / "limits" / f"{name}.json")
    return Cell(name=name, workload=w, config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])
