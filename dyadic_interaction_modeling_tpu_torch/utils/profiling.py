"""Step timing and tracing.

Counterpart of ``dyadic_interaction_modeling_tpu/utils/profiling.py``:

* ``StepTimer``: per-phase meters (data / step / eval) with an ETA; a phase
  given ``sync`` tensors waits for the card before it stops its clock,
* ``trace``: a ``torch.profiler`` window over the CPU and, where there is
  one, the card, written as a Chrome trace (``chrome://tracing``, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from .logging import AverageMeter


def fence(tree) -> None:
    """Wait for the card on each CUDA device that holds a tensor of ``tree``
    (a tensor, or lists, tuples and dicts of them); CPU tensors need no
    wait."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Per-phase meters (data / forward+backward / eval) with ETA."""

    def __init__(self, max_iter: Optional[int] = None):
        self.meters: Dict[str, AverageMeter] = {}
        self.max_iter = max_iter
        self._t0 = time.perf_counter()
        self.iteration = 0

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            fence(sync)
        self.meters.setdefault(name, AverageMeter()).update(time.perf_counter() - t0)

    def tick(self) -> None:
        self.iteration += 1

    def summary(self) -> str:
        parts = [f"{k} {m.avg * 1000:.1f}ms" for k, m in self.meters.items()]
        if self.max_iter and self.iteration:
            per_iter = (time.perf_counter() - self._t0) / self.iteration
            remain = per_iter * (self.max_iter - self.iteration)
            parts.append(f"eta {remain / 60:.1f}min")
        return " | ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; yields the profiler (its
    ``key_averages()`` has the sums by op and kernel) and writes
    ``{log_dir}/trace.json`` at the end."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
