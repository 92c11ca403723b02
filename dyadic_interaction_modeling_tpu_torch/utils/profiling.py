"""Spans of the program's stages, and the profiler's trace.

* ``span(name, **counts)``: a stage of the program, as a context manager
  whose ``set(**counts)`` sets counters known only at its end.
  Off (the default) it returns one shared object that does nothing. Inside
  ``recording()`` it records a ``Span`` whose times come from
  ``time.time_ns()``, the clock of ``torch.profiler``'s event timestamps, so
  each device operation can be placed under the stage that launched it;
* ``recording()``: the only switch; turns the recorder on for a block;
* ``self_ns``: a span's time less its children's;
* ``trace``: a ``torch.profiler`` window with the recorder on, written as a
  Chrome trace (Perfetto, ``chrome://tracing``) with the spans as a track of
  their own above the kernels.

The spans of the generate path (``engine/pt_engine.py``,
``models/xtrans.py``), all read by ``cli/profile_generate``, which also
holds the analysis that places the profiler's device operations and the
card's idle time under them: ``generate``, ``encode``, ``token_loop``
(counters ``graphed``, the token steps replayed from a CUDA graph, and
``captured``, 1 when the call captured one) with ``loop_setup``, one
``token_step`` a sampled token (counter ``t``, the cache position it decodes
at) and ``capture`` (a graph's capture, in a token step), ``vq_decode``; in
``evaluate_test_epoch`` ``to_host`` and ``fd_pick``. A context-free decoder's
call (``make_lm_generator``, ``models/deepseek_v2.py``) has ``generate``
(with ``expert_load_pm``, read only while recording: the largest expert's
token count over its layer's mean in the call's decode steps, per mille),
``token_loop``, ``loop_setup`` holding ``prefill`` (counter ``tokens``), one
``moe`` an expert layer an eager forward, and the ``token_step`` spans.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

# the spans' process in the Chrome trace: above every Linux pid (2**22)
SPAN_PID = 1 << 23

_record: Optional[List["Span"]] = None  # the list ``recording()`` fills
_ids = itertools.count(1)
_local = threading.local()


@dataclass
class Span:
    """One stage of one call. ``parent_id`` is the innermost span open on
    the same thread at its start (0: none). Times are ``time.time_ns()``;
    ``end_ns`` is 0 while it is open."""

    id: int
    parent_id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    counts: Dict[str, int] = field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts: int) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "counts", "out", "span")

    def __init__(self, name: str, counts: Dict[str, int], out: List[Span]):
        self.name, self.counts, self.out = name, counts, out

    def __enter__(self):
        stack = _stack()
        self.span = Span(next(_ids), stack[-1].id if stack else 0, self.name,
                         time.time_ns(), 0, threading.get_ident(), self.counts)
        stack.append(self.span)
        self.out.append(self.span)
        return self

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        _stack().pop()
        return False

    def set(self, **counts: int) -> None:
        """Sets counters known only once the block has run."""
        self.span.counts.update(counts)


def span(name: str, **counts: int):
    """A stage named ``name`` with counters ``counts``, over a ``with``
    block; recorded only inside ``recording()``."""
    if _record is None:
        return _OFF
    return _On(name, counts, _record)


def is_recording() -> bool:
    """Whether spans are being recorded (inside ``recording()``): counters
    that cost a host sync are read only then."""
    return _record is not None


@contextlib.contextmanager
def recording():
    """The recorder on over the block; yields the list of the spans it
    records, in the order they open. It collects the garbage first: the
    spans it keeps set off the cyclic collector, which would otherwise
    sweep older garbage (a finished profiler's events) inside the block."""
    global _record
    gc.collect()
    prev, spans = _record, []
    _record = spans
    try:
        yield spans
    finally:
        _record = prev


def self_ns(sp: Span, spans: List[Span]) -> int:
    """``sp``'s time less the time its child spans take (they run on its
    thread, one after another)."""
    return sp.ns - sum(c.ns for c in spans if c.parent_id == sp.id)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, on the CPU and, where there is
    one, the card, with the recorder on; yields the profiler (its
    ``key_averages()`` has the sums by op and kernel) and writes
    ``{log_dir}/trace.json`` at the end: the profiler's Chrome trace and the
    block's spans, a row a thread under a process named ``spans``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with recording() as spans, profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)  # the trace's ts: microseconds from it
    doc["traceEvents"].append({"ph": "M", "name": "process_name", "pid": SPAN_PID,
                               "tid": 0, "args": {"name": "spans"}})
    doc["traceEvents"] += [
        {"ph": "X", "cat": "span", "name": sp.name, "pid": SPAN_PID, "tid": sp.thread,
         "ts": (sp.start_ns - base) / 1e3, "dur": sp.ns / 1e3,
         "args": dict(sp.counts, id=sp.id, parent_id=sp.parent_id)}
        for sp in spans]
    with open(path, "w") as f:
        json.dump(doc, f)
