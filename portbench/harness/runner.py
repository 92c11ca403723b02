"""One run of one cell: set-up, the measured (or traced) window, the check
against the reference, and the result line. ``run.py`` calls ``run_cell``
on the card; the tests call it on the CPU at small widths."""

from __future__ import annotations

import math
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from . import imports
from .cell import Cell
from .trace import Trace, collect


@dataclass
class Ctx:
    """What an entry is given: the device, the seed, the configuration and
    the traffic mix (both as read from their files)."""

    device: str
    seed: int
    config: dict
    traffic: dict


@dataclass
class Measured:
    """What a metric's reader reads."""

    kind: str
    setup_s: float
    units: int
    frames: float
    window_s: float
    work: dict
    trace: Optional[Trace] = None


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def window(sess, device: str, seconds: float):
    """Units (calls, steps) a unit after another until ``seconds`` have
    passed at a unit's end; the window closes when the card has finished the
    last. Returns (units, frames, seconds)."""
    units, frames, ends = 0, 0.0, []
    t0 = time.perf_counter()
    while True:
        frames += sess.step(units)
        units += 1
        if sess.sync_each:
            _sync(device)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    _sync(device)
    span = time.perf_counter() - t0
    gaps = [round(b - a, 4) for a, b in zip([0.0] + ends, ends)]
    log(f"units' host times (s): first {gaps[:3]}, last {gaps[-3:]}")
    return units, frames, span


def traced_window(sess, device: str, units: int, host: bool):
    """``units`` units under ``torch.profiler``: device activity alone
    (``host`` False; the window the per-layer metrics read), or with the
    host's operators too (``host`` True; recording them slows a host-bound
    loop, so that window serves only to name the idle gaps). Returns
    (frames, Trace)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.startswith("cuda") else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    frames = 0.0
    _sync(device)
    with profile(activities=acts) as prof:
        start = time.time_ns()
        for i in range(units):
            frames += sess.step(i)
            if sess.sync_each:
                _sync(device)
        _sync(device)
        end = time.time_ns()
    return frames, collect(prof, start, end)


def log(*parts) -> None:
    print(f"portbench: [{time.perf_counter():.3f}]", *parts, file=sys.stderr, flush=True)


def card(device: str) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> Dict:
    """The result line's object; ``t_start`` is ``time.perf_counter()`` at
    the process's start, from which set-up is counted."""
    ctx = Ctx(device=device, seed=seed, config=cell.config, traffic=cell.traffic)
    log(f"imports {time.perf_counter() - t_start:.3f} s")
    sess = cell.entry().Session(ctx)
    _sync(device)
    log(f"model, weights, inputs {time.perf_counter() - t_start:.3f} s")
    sess.warm()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"warm-up done, set-up {setup_s:.3f} s")
    tr = gaps = None
    if trace:
        units = int(cell.traffic["trace_units"])
        frames, tr = traced_window(sess, device, units, host=False)
        window_s = tr.window_s
        gaps = traced_window(sess, device, units, host=True)[1] if tr.device else tr
    else:
        units, frames, window_s = window(sess, device, seconds)
    log(f"window {window_s:.3f} s, {units} units")
    peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
    sess.release()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    numbers = sess.check()
    limits = cell.limits["numbers"]
    check = {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in check.values())
    m = Measured(kind=sess.kind, setup_s=setup_s, units=units, frames=frames,
                 window_s=window_s, work=cell.counts().work(cell.config, cell.traffic), trace=tr)
    metrics = {}
    readers = cell.readers(trace)
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = readers[spec["name"]].read(m)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    dev = card(device)
    dev["memory_peak_bytes"] = int(peak)
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
    out = {"correct": correct, "attempted": units, "failed": 0, "metrics": metrics,
           "device": dev}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": gaps.idle_gaps(10)}
    out["check"] = check
    return out


def guard() -> list:
    """The forbidden modules loaded in this process (see ``imports``)."""
    return imports.forbidden_loaded(sys.modules)
