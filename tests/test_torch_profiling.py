"""The port's span recorder (``utils/profiling.py``) on the CPU: off it
records nothing; on, spans nest on one thread and carry their counters;
they share the clock of ``torch.profiler``'s events (as
``portbench/harness/trace.collect`` places them); ``cli/profile_generate``'s
split of device and idle time by stage and by position on hand-built
operations; and the generate path's spans, whose outputs the recorder
leaves bitwise as they are."""

import gc
import sys
import threading
import time
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import profile_generate as PG
from dyadic_interaction_modeling_tpu_torch.engine import pt_engine as TE
from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT
from dyadic_interaction_modeling_tpu_torch.utils import profiling as TP

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(dim=32, dim_audio=16, enc_depth=1, dec_depth=2, enc_heads=2,
             dec_heads=2, num_tokens=64, enc_max_seq_len=64, dec_max_seq_len=64)
B0, N, L = 3, 2, 12


def test_off_records_nothing_and_returns_the_shared_noop():
    class Cycle:
        pass

    gc.disable()  # only recording() may collect it
    try:
        garbage = Cycle()
        garbage.me = garbage
        ref = weakref.ref(garbage)
        del garbage
        with TP.recording() as spans:
            assert ref() is None
    finally:
        gc.enable()
    a, b = TP.span("x", n=1), TP.span("y")
    assert a is b
    with a as got:
        pass
    assert got is a and spans == []


def test_nesting_parent_call_counts_and_self_time():
    with TP.recording() as spans:
        with TP.span("call", clips=2):
            with TP.span("a"):
                time.sleep(0.002)
            with TP.span("b", t=5):
                time.sleep(0.002)
        with TP.span("next"):
            pass
    call, a, b, nxt = spans
    assert [s.name for s in spans] == ["call", "a", "b", "next"]
    assert call.parent_id == nxt.parent_id == 0 and a.parent_id == b.parent_id == call.id
    assert len({s.id for s in spans}) == 4
    assert call.counts == {"clips": 2} and a.counts == {} and b.counts == {"t": 5}
    assert call.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= call.end_ns
    assert TP.self_ns(call, spans) == call.ns - a.ns - b.ns
    assert TP.self_ns(a, spans) == a.ns and len({s.thread for s in spans}) == 1
    assert TP.span("z") is TP.span("w")  # off again after the block


def test_spans_of_another_thread_open_their_own_call():
    def worker():
        with TP.span("worker"):
            pass

    with TP.recording() as spans:
        with TP.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
    assert not t.is_alive()
    main, worker = spans
    assert worker.parent_id == 0 and worker.thread != main.thread


def test_aten_operators_fall_inside_their_span_on_the_profilers_clock():
    """The spans and ``collect``'s events on one clock: an operator run
    inside a span starts and ends inside it. The host sleeps 0.1 ms on
    either side of it, so the check holds the two clocks within that of
    each other, and no closer."""
    sys.path.insert(0, str(ROOT))
    from portbench.harness.trace import collect
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    with TP.recording() as spans, profile(activities=[ProfilerActivity.CPU]) as prof:
        start = time.time_ns()
        for i in range(5):
            with TP.span("mm", i=i):
                time.sleep(1e-4)
                torch.mm(x, x)
                time.sleep(1e-4)
        end = time.time_ns()
    tr = collect(prof, start, end)
    mms = sorted((s, e) for n, s, e in tr.host if n == "aten::mm")
    assert len(mms) == len(spans) == 5
    for sp, (s, e) in zip(spans, mms):
        lo, hi = (sp.start_ns - start) * 1e-9, (sp.end_ns - start) * 1e-9
        assert lo <= s <= e <= hi


def _span(i, parent, name, s, e, **counts):
    return TP.Span(i, parent, name, s, e, 0, counts)


def test_stages_split_host_device_and_idle_by_span():
    """Window 0-100 ns; spans gen 10-90 (loop 20-60 (step 30-40, step
    40-50)); operations (name, start, end, launch), one unlinked. The card
    is busy 46 ns; its gaps, placed on the host's clock by the launch that
    ends each, are 0-2, 7-11, 14-31, 45-65 and, the rest, 89-100."""
    spans = [_span(1, 0, "gen", 10, 90), _span(2, 1, "loop", 20, 60),
             _span(3, 2, "step", 30, 40), _span(4, 2, "step", 40, 50)]
    ops = [("a", 5, 8, 2),      # launched before gen: outside
           ("b", 12, 15, 11),   # in gen
           ("c", 32, 42, 31),   # in the first step
           ("d", 40, 45, None),  # no launch found
           ("e", 42, 50, 40),   # at the second step's start: that step
           ("f", 70, 80, 65),   # after loop's end: gen again
           ("g", 80, 92, 79)]
    window = (0, 100)
    assert PG.host_idle(ops, window) == [(0, 2), (7, 11), (14, 31), (45, 65), (89, 100)]
    rows = PG.stages(spans, ops, window)
    # host self time: gen 80 - 40, loop 40 - 20, the steps 10 + 10, outside 100 - 80;
    # idle: outside 0-2, 7-10, 90-100; gen 10-11, 14-20, 60-65, 89-90; loop 20-30,
    # 50-60; the steps 30-31, 45-50
    want = {"gen": (1, 40, 3 + 10 + 12, 13), "loop": (1, 20, 0, 20),
            "step": (2, 20, 10 + 8, 6), "outside": (0, 20, 3, 15), "unlinked": (0, 0, 5, 0)}
    ns = 1e-9
    for name, (n, host, dev, idle) in want.items():
        r = rows[name]
        assert r["n"] == n, name
        assert r["host_s"] == pytest.approx(host * ns), name
        assert r["device_s"] == pytest.approx(dev * ns), name
        assert r["idle_s"] == pytest.approx(idle * ns), name
    assert set(rows) == set(want)
    assert PG.span_kernels(spans, ops, window, "step") == {"c": 10, "e": 8}
    # the card's clock standing off the host's moves nothing
    off = [(n, s + 1000, e + 1000, launch) for n, s, e, launch in ops]
    assert PG.stages(spans, off, window) == rows
    # a span of no length, one the wall clock stepped back in, and one still
    # open (it counts up to the window's end) take nothing from the others
    more = spans + [_span(5, 2, "tick", 55, 55), _span(6, 2, "back", 57, 56),
                    _span(7, 0, "open", 95, 0)]
    rows2 = PG.stages(more, ops, window)
    assert rows2["tick"] == rows2["back"] == {"n": 1, "host_s": 0.0, "device_s": 0.0,
                                              "idle_s": 0.0}
    assert rows2["open"] == pytest.approx({"n": 1, "host_s": 5 * ns, "device_s": 0.0,
                                           "idle_s": 5 * ns})
    assert rows2["outside"] == pytest.approx({"n": 0, "host_s": 15 * ns, "device_s": 3 * ns,
                                              "idle_s": 10 * ns})
    for name in ("gen", "loop", "step", "unlinked"):
        assert rows2[name] == pytest.approx(rows[name]), name


def test_token_numbers_and_steps_by_position():
    """One call on a window of 0-200 ns: generate 0-100 (encode, token_loop
    (loop_setup, steps at t = 1, 64, 65), vq_decode), to_host 100-120,
    fd_pick 120-200; each operation launched at its start."""
    spans = [_span(1, 0, "generate", 0, 100), _span(2, 1, "encode", 0, 10),
             _span(3, 1, "token_loop", 10, 90), _span(4, 3, "loop_setup", 10, 20),
             _span(5, 3, "token_step", 20, 40, t=1), _span(6, 3, "token_step", 40, 60, t=64),
             _span(7, 3, "token_step", 60, 90, t=65), _span(8, 1, "vq_decode", 90, 100),
             _span(9, 0, "to_host", 100, 120), _span(10, 0, "fd_pick", 120, 200)]
    ops = [("enc", 0, 10, 0), ("setup", 10, 20, 10), ("s1", 25, 40, 25),
           ("s64", 40, 55, 40), ("s65", 60, 90, 60), ("dec", 90, 100, 90),
           ("copy", 100, 110, 100)]
    window = (0, 200)
    # idle: 20-25 in the first step, 55-60 in the second, 110-120 in to_host,
    # 120-200 in fd_pick
    rows = PG.stages(spans, ops, window)
    assert PG.token_numbers(spans, rows) == pytest.approx({
        "host_us_per_token": 0.020, "device_us_per_token": 0.020, "loop_idle_ms": 1e-5,
        "loop_share_of_call_idle": 50.0, "call_idle_share": 100 * 20 / 120})
    got = PG.by_position(spans, ops, window)
    assert list(got) == [0, 64]
    assert got[0] == pytest.approx({"n": 1, "host_us": 0.020, "device_us": 0.015,
                                    "idle_us": 0.005})
    assert got[64] == pytest.approx({"n": 2, "host_us": 0.025, "device_us": 0.0225,
                                     "idle_us": 0.0025})


def test_graph_numbers_count_replayed_steps_and_captures():
    """Two calls: the first captured (one eager step, one captured, one
    replayed of its 3 token steps), the second replayed 2 of 3."""
    spans = [_span(1, 0, "token_loop", 0, 100, graphed=1, captured=1),
             *[_span(2 + i, 1, "token_step", 10 * i, 10 * i + 10, t=1 + i) for i in range(3)],
             _span(5, 3, "capture", 12, 18),
             _span(6, 0, "token_loop", 100, 200, graphed=2, captured=0),
             *[_span(7 + i, 6, "token_step", 100 + 10 * i, 110 + 10 * i, t=1 + i)
               for i in range(3)]]
    assert PG.graph_numbers(spans) == pytest.approx(
        {"graphed": 3, "token_steps": 6, "captured": 1, "capture_ms": 6e-6})
    assert PG.graph_numbers(spans[5:]) == pytest.approx(
        {"graphed": 2, "token_steps": 3, "captured": 0, "capture_ms": 0.0})


def test_device_ops_link_each_operation_to_its_launch():
    from torch.autograd import DeviceType

    def ev(name, dev, corr, start, dur):
        return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                               correlation_id=lambda: corr, start_ns=lambda: start,
                               duration_ns=lambda: dur)

    # an operator's correlation ids are of another sequence than the runtime's
    events = [ev("aten::mm", DeviceType.CPU, 7, 100, 50),
              ev("cudaLaunchKernel", DeviceType.CPU, 7, 110, 5),
              ev("cuLaunchKernelEx", DeviceType.CPU, 8, 120, 5),
              ev("aten::copy_", DeviceType.CPU, 9, 125, 5),
              ev("gemm", DeviceType.CUDA, 7, 130, 20),
              ev("decode", DeviceType.CUDA, 8, 150, 10),
              ev("memcpy", DeviceType.CUDA, 9, 160, 4)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert PG.device_ops(prof) == [("gemm", 130, 150, 110), ("decode", 150, 160, 120),
                                   ("memcpy", 160, 164, None)]


@pytest.fixture(scope="module")
def small_slmft():
    cfg = TC.slm_defaults()
    cfg.update(SMALL)
    torch.manual_seed(0)
    model = SLMFT(cfg, TC.vq_cfg_for(cfg, True)).eval()
    g = torch.Generator().manual_seed(1)
    mask = torch.arange(L)[None, :] < torch.tensor([12, 9, 5])[:, None]
    batch = (torch.randn(B0, L, 56, generator=g), torch.randn(B0, L, 56, generator=g),
             torch.randn(B0, L, 16, generator=g), mask)
    return model, batch


def test_generate_spans_and_bitwise_outputs_with_the_recorder_on(small_slmft):
    model, batch = small_slmft
    gen = TE.make_slmft_generator(model)

    def call():
        return gen(batch, torch.Generator().manual_seed(5), N, return_tokens=True)

    cands_off, tokens_off = call()
    with TP.recording() as spans:
        cands_on, tokens_on = call()
        call()
    assert torch.equal(cands_on, cands_off) and torch.equal(tokens_on, tokens_off)
    roots = [s for s in spans if s.parent_id == 0]
    assert [s.name for s in roots] == ["generate", "generate"]
    assert roots[0].counts == {}
    for root in roots:
        mine = [s for s in spans if root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns]
        names = [s.name for s in mine]
        for stage in ("encode", "token_loop", "loop_setup", "vq_decode"):
            assert names.count(stage) == 1, stage
        steps = [s for s in mine if s.name == "token_step"]
        assert len(steps) == L - 1
        loop = next(s for s in mine if s.name == "token_loop")
        assert all(s.parent_id == loop.id for s in steps)
        assert [s.counts for s in steps] == [{"t": 1 + i} for i in range(L - 1)]
        assert loop.counts == {"graphed": 0, "captured": 0}  # the CPU loop runs eagerly
    rows = PG.stages(spans, [], (spans[0].start_ns, spans[-1].end_ns))
    assert rows["token_step"]["n"] == 2 * (L - 1)


def test_evaluate_test_epoch_spans_the_copy_and_the_pick(small_slmft):
    model, batch = small_slmft
    gen = TE.make_slmft_generator(model)
    with TP.recording() as spans:
        TE.evaluate_test_epoch(model, gen, [tuple(x.numpy() for x in batch)],
                               torch.Generator().manual_seed(0), beam_size=N, device="cpu")
    names = [s.name for s in spans if s.parent_id == 0]
    assert names == ["generate", "to_host", "fd_pick"]
    assert all(s.counts == {} for s in spans if s.name not in ("token_step", "token_loop"))
    assert [s.counts for s in spans if s.name == "token_loop"] == [{"graphed": 0, "captured": 0}]
