"""Where the time of one best-of-N eval batch goes, on the GPU, by stage.

    python -m dyadic_interaction_modeling_tpu_torch.cli.profile_generate

Builds SLMFT at full width (``slm_defaults()`` + ``vq_listener_defaults()``,
random init from seed 0, bf16) and the benchmark's generation batch (256
synthetic clips of L = 256, best-of-10), runs one warm-up generate (which
captures the CUDA graph of a sampled token step), then one batch of
``engine.pt_engine.evaluate_test_epoch`` (generate, the candidates to the
host, the FD pick) under ``torch.profiler`` (the card alone, so the host
keeps its pace), both with the span recorder of ``utils/profiling.py`` on.
Prints the card's name and power limit, the batch's wall time and the
card's busy share, the kernels with the most device time, and for each
stage (span name, and ``outside``) its host self time, the device time of
the operations launched in it and the card's idle time while the host was
in it; then a token step's host time (median of the ``token_step`` spans)
and device time, the token loop's share of the card's idle time in the
call (``generate`` and ``to_host``, what one call of the benchmark's gen
cell holds) and that call's idle share; then the token steps by cache
position ``t``, 64 positions a row; then the profiled call's token steps
replayed from a CUDA graph, and the graphs the warm-up call captured with
their capture's host time. Needs a CUDA device.

    python -m dyadic_interaction_modeling_tpu_torch.cli.profile_generate --lm CONFIG.json

does the same for a context-free decoder (``models/deepseek_v2.py``, the
DeepSeek-V2 keys of ``CONFIG.json``, e.g. ``portbench/configs/dsv2_lite.json``,
the decoder's ``init_weights``, the benchmark cell's seeded weights, bf16)
through ``engine.pt_engine.make_lm_generator`` at the benchmark's shape:
512 prompts of 512 random ids, 256 tokens sampled a sequence at top-k 50;
besides the stages it prints the prefill's tokens, the ``moe`` spans, the
token loop's counters (``graphed``, ``captured``) and the call's
``expert_load_pm``; then the expert layers' device time outside their
grouped GEMMs, by operation: the profiled call's prefill, and
``LM_EAGER_STEPS`` decode steps run eagerly after a prefill (a replayed step
has no spans), with their sum over a call.

The analysis (``device_ops``, ``host_idle``, ``stages``, ``by_position``,
``graph_numbers``) runs on the CPU too, on any profile and spans.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import re
import statistics
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import torch

CLIPS, SAMPLES, LENGTH, SEED = 256, 10, 256, 0
# the context-free decoder's call: sequences, prompt ids, sampled tokens, top-k
LM_SEQUENCES, LM_PROMPT, LM_TOKENS, LM_TOP_K = 512, 512, 256, 50
LM_EAGER_STEPS = 8  # decode steps run eagerly, for their ``moe`` spans
LOOP = ("token_loop", "loop_setup", "token_step")
# the stages of one generate call and of the wait for its candidates
CALL = ("generate", "encode", "vq_decode", "to_host") + LOOP
BUCKET = 64  # cache positions a row of the by-position split
# name of the row that takes what happens outside every span
OUTSIDE = "outside"
# name of the row that takes the device operations no runtime call launched
UNLINKED = "unlinked"
# the CUDA API calls (``cuda*``, ``cu*``) among the profiler's host events
RUNTIME = re.compile(r"cu(da)?[A-Z]")
# the grouped GEMMs of ``torch._grouped_mm`` (CUTLASS) among the kernels' names
GROUPED_GEMM = re.compile(r"GroupProblemShape|grouped_gemm|GroupedGemm|grouped_mm", re.I)


def device_ops(prof) -> List[Tuple[str, int, int, Optional[int]]]:
    """The device operations of a finished ``torch.profiler.profile`` that
    recorded ``ProfilerActivity.CUDA``: (name, start_ns, end_ns, launch_ns)
    on ``time.time_ns()``'s clock, where ``launch_ns`` is the start of the
    CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaMemcpyAsync``, ...) that launched the operation (the two share the
    profiler's correlation id), None where the trace holds no such call.
    The operations of a replayed CUDA graph all link to its one
    ``cudaGraphLaunch``."""
    from torch.autograd import DeviceType

    launch, ops = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            start = ev.start_ns()
            ops.append((ev.name(), start, start + ev.duration_ns(), ev.correlation_id()))
        elif RUNTIME.match(ev.name()):
            launch[ev.correlation_id()] = ev.start_ns()
    return [(name, s, e, launch.get(c)) for name, s, e, c in ops]


def host_idle(ops, window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The card's idle time in ``window`` (start_ns, end_ns) as intervals of
    the host's clock, from ``ops`` ((name, start_ns, end_ns, launch_ns), as
    ``device_ops`` gives them). The card's timestamps can stand off the
    host's clock by milliseconds, so only their differences are used: a gap
    between two operations ends at the launch of the one that ends it, the
    window's first gap at the first launch, and the rest of the window's
    idle time (the window less the union of the operations) ends with the
    window."""
    lo, hi = window
    out, busy, first, end = [], 0, None, None
    for _, s, e, launch in sorted(ops, key=lambda op: op[1]):
        t = s if launch is None else launch
        if end is None:
            out.append((lo, max(lo, min(t, hi))))
        elif s > end:
            busy += end - first
            out.append((t - (s - end), t))
        else:
            end = max(end, e)
            continue
        first, end = s, e
    if end is not None:
        busy += end - first
    rest = hi - lo - busy - sum(b - a for a, b in out)
    if rest > 0:
        out.append((hi - rest, hi))
    return out


def _closed(spans, hi: int):
    """The spans with each still open closed at ``hi``, and none ending
    before it starts (``time.time_ns()`` is the wall clock, which can step
    back)."""
    return [dataclasses.replace(sp, end_ns=max(sp.start_ns, sp.end_ns or hi)) for sp in spans]


class _Timeline:
    """The innermost span open at each moment of the host's clock (a span
    covers [start_ns, end_ns)); at one time a span opens before it, or
    another it encloses, closes."""

    def __init__(self, spans):
        marks = sorted([(sp.start_ns, 0, i) for i, sp in enumerate(spans)]
                       + [(sp.end_ns, 1, -i) for i, sp in enumerate(spans)])
        open_, self.times, self.owners = [], [], []
        for t, ends, i in marks:
            if ends:
                open_.remove(-i)
            else:
                open_.append(i)
            owner = spans[open_[-1]] if open_ else None
            if self.times and self.times[-1] == t:
                self.owners[-1] = owner
            else:
                self.times.append(t)
                self.owners.append(owner)

    def at(self, t: int):
        k = bisect.bisect_right(self.times, t) - 1
        return self.owners[k] if k >= 0 else None

    def split(self, a: int, b: int):
        """(span or None, ns) for each piece of [a, b) under one innermost span."""
        k = bisect.bisect_right(self.times, a) - 1
        while a < b:
            nxt = min(b, self.times[k + 1]) if k + 1 < len(self.times) else b
            yield (self.owners[k] if k >= 0 else None), nxt - a
            a, k = nxt, k + 1


def per_span(spans, ops, window: Tuple[int, int]):
    """The device time of the ``ops`` launched, and the card's idle time,
    while each span of ``spans`` (closed, as ``_closed`` leaves them) was the
    innermost open: two dicts of ns by span id, where 0 is outside every
    span and -1 (device time only) the operations with no launch."""
    line = _Timeline(spans)
    dev: Dict[int, int] = {}
    idle: Dict[int, int] = {}
    for _, s, e, launch in ops:
        sp = None if launch is None else line.at(launch)
        k = -1 if launch is None else (sp.id if sp else 0)
        dev[k] = dev.get(k, 0) + e - s
    for a, b in host_idle(ops, window):
        for sp, ns in line.split(a, b):
            k = sp.id if sp else 0
            idle[k] = idle.get(k, 0) + ns
    return dev, idle


def span_kernels(spans, ops, window: Tuple[int, int], name: str) -> Dict[str, int]:
    """The device time (ns) by operation name of the ``ops`` launched while
    a span named ``name`` was the innermost open."""
    line = _Timeline(_closed(spans, window[1]))
    out: Dict[str, int] = {}
    for op, s, e, launch in ops:
        sp = None if launch is None else line.at(launch)
        if sp is not None and sp.name == name:
            out[op] = out.get(op, 0) + e - s
    return out


def stages(spans, ops, window: Tuple[int, int]) -> Dict[str, Dict[str, float]]:
    """Time by span name over a traced window (start_ns, end_ns): for each,
    ``n`` spans, ``host_s`` their self time, ``device_s`` the device time
    of the ``ops`` (``device_ops``) launched while it was the innermost open
    span, ``idle_s`` the card's idle time (``host_idle``) while it was. The
    row ``outside`` takes the window's time outside every span and what was
    launched or idle then; ``unlinked`` the operations with no launch. A span
    still open counts up to the window's end."""
    from ..utils.profiling import self_ns

    lo, hi = window
    spans = _closed(spans, hi)
    rows: Dict[str, Dict[str, float]] = {}

    def row(name: str) -> Dict[str, float]:
        return rows.setdefault(name, {"n": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0})

    for sp in spans:
        r = row(sp.name)
        r["n"] += 1
        r["host_s"] += self_ns(sp, spans) * 1e-9
    roots = sum(max(0, min(sp.end_ns, hi) - max(sp.start_ns, lo))
                for sp in spans if sp.parent_id == 0)
    row(OUTSIDE)["host_s"] = (hi - lo - roots) * 1e-9
    names = {0: OUTSIDE, -1: UNLINKED, **{sp.id: sp.name for sp in spans}}
    dev, idle = per_span(spans, ops, window)
    for k, ns in dev.items():
        row(names[k])["device_s"] += ns * 1e-9
    for k, ns in idle.items():
        row(names[k])["idle_s"] += ns * 1e-9
    return rows


def by_position(spans, ops, window: Tuple[int, int]) -> Dict[int, Dict[str, float]]:
    """The ``token_step`` spans by cache position, ``BUCKET`` positions a
    row keyed by its first: ``n`` steps, ``host_us`` their median time,
    ``device_us`` and ``idle_us`` the device time launched in them and the
    card's idle time while the host was in them, a step."""
    spans = _closed(spans, window[1])
    dev, idle = per_span(spans, ops, window)
    rows: Dict[int, Dict[str, list]] = {}
    for sp in spans:
        if sp.name == "token_step":
            r = rows.setdefault(sp.counts["t"] // BUCKET * BUCKET,
                                {"ns": [], "dev": 0, "idle": 0})
            r["ns"].append(sp.ns)
            r["dev"] += dev.get(sp.id, 0)
            r["idle"] += idle.get(sp.id, 0)
    return {t: {"n": len(r["ns"]), "host_us": statistics.median(r["ns"]) / 1e3,
                "device_us": r["dev"] / 1e3 / len(r["ns"]),
                "idle_us": r["idle"] / 1e3 / len(r["ns"])}
            for t, r in sorted(rows.items())}


def token_numbers(spans, rows) -> dict:
    """From the spans and their ``stages`` rows: a token step's host time
    (median of the ``token_step`` spans) and device time (that launched in
    them, over their number), in µs; the card's idle time in the token loop,
    in ms, and as a share of its idle time in the call (the ``CALL``
    stages), in %; and that idle time as a share of the ``generate`` and
    ``to_host`` spans' time, in %."""
    steps = [sp.ns for sp in spans if sp.name == "token_step"]
    idle = {k: rows[k]["idle_s"] if k in rows else 0.0 for k in CALL}
    loop, call = sum(idle[k] for k in LOOP), sum(idle.values())
    call_s = sum(sp.ns for sp in spans if sp.name in ("generate", "to_host")) * 1e-9
    return {"host_us_per_token": statistics.median(steps) / 1e3,
            "device_us_per_token": rows["token_step"]["device_s"] * 1e6 / len(steps),
            "loop_idle_ms": loop * 1e3,
            "loop_share_of_call_idle": 100.0 * loop / call if call else 0.0,
            "call_idle_share": 100.0 * call / call_s if call_s else 0.0}


def graph_numbers(spans) -> dict:
    """From the spans of generate calls: the token steps replayed from a
    CUDA graph (the ``token_loop`` spans' ``graphed``) and all token steps,
    the graphs captured (``captured``) and the host time of their captures
    (the ``capture`` spans), in ms."""
    loops = [sp for sp in spans if sp.name == "token_loop"]
    return {"graphed": sum(sp.counts.get("graphed", 0) for sp in loops),
            "token_steps": sum(1 for sp in spans if sp.name == "token_step"),
            "captured": sum(sp.counts.get("captured", 0) for sp in loops),
            "capture_ms": sum(sp.ns for sp in spans if sp.name == "capture") / 1e6}


def _print_profile(spans, ops, window: Tuple[int, int]) -> Dict[str, Dict[str, float]]:
    """The window's wall time and busy share, the kernels with the most
    device time and the stages; returns the stages' rows."""
    t0, t1 = window
    rows = stages(spans, ops, window)
    wall = (t1 - t0) * 1e-9
    idle = sum(r["idle_s"] for r in rows.values())
    print(f"profiled batch: wall {wall * 1e3:.1f} ms, device busy {(wall - idle) * 1e3:.1f} ms "
          f"({100 * (1 - idle / wall):.1f}%), {len(ops)} device operations, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    by_name = {}
    for name, s, e, _ in ops:
        tot, cnt = by_name.get(name, (0, 0))
        by_name[name] = (tot + e - s, cnt + 1)
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot / 1e6:9.2f} ms  {cnt:6d} x  {name[:100]}")
    print(f"{'stage':<12} {'spans':>6} {'host self ms':>13} {'device ms':>10} {'idle ms':>9}")
    for name, r in rows.items():
        print(f"{name:<12} {r['n']:>6} {r['host_s'] * 1e3:>13.2f} {r['device_s'] * 1e3:>10.2f} "
              f"{r['idle_s'] * 1e3:>9.2f}")
    return rows


def profile_lm(config: str) -> int:
    """One warm-up call and one profiled call of ``make_lm_generator`` on a
    DeepSeek-V2 decoder built from ``config``."""
    from torch.profiler import ProfilerActivity, profile

    from ..engine.pt_engine import make_lm_generator
    from ..models.deepseek_v2 import DeepseekV2Config, DeepseekV2Decoder
    from ..utils.profiling import recording

    with open(config) as f:
        cfg = DeepseekV2Config.from_dict(json.load(f))
    model = DeepseekV2Decoder.empty(cfg, "cuda", torch.bfloat16).eval()
    rng = torch.Generator(device="cuda").manual_seed(SEED)
    model.init_weights(rng)
    ids = torch.randint(0, cfg.vocab_size, (LM_SEQUENCES, LM_PROMPT), device="cuda",
                        generator=rng)
    gen = make_lm_generator(model)
    frac = LM_TOP_K / cfg.vocab_size
    with recording() as warm:
        gen(ids, rng, LM_TOKENS, filter_frac=frac)  # warm-up: captures the graph
        torch.cuda.synchronize()
    with recording() as spans, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        gen(ids, rng, LM_TOKENS, filter_frac=frac)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    _print_profile(spans, device_ops(prof), (t0, t1))
    (pre,) = [sp for sp in spans if sp.name == "prefill"]
    (call,) = [sp for sp in spans if sp.name == "generate"]
    (loop,) = [sp for sp in spans if sp.name == "token_loop"]
    moe = [sp for sp in spans if sp.name == "moe"]
    print(f"prefill: {pre.counts['tokens']} tokens in {pre.ns / 1e6:.1f} ms of host time, "
          f"{len(moe)} moe spans (the prefill's: the decode steps replay from the graph)")
    print(f"token loop: {loop.counts}, expert_load_pm {call.counts['expert_load_pm']}; "
          f"the warm-up call captured "
          f"{graph_numbers(warm)['captured']} graph(s)")
    prefill_rest = _print_moe("prefill", spans, device_ops(prof), (t0, t1))
    # a replayed step records no span: the decode's expert layers, eagerly
    cache = model.init_cache(LM_SEQUENCES, LM_PROMPT + LM_TOKENS, torch.bfloat16, "cuda")
    with torch.no_grad():
        model.prefill(ids, cache)
        with recording() as spans, profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time_ns()
            for t in range(LM_PROMPT, LM_PROMPT + LM_EAGER_STEPS):
                model.decode_step(ids[:, -1:], cache, t)
            torch.cuda.synchronize()
            t1 = time.time_ns()
    decode_rest = _print_moe("eager decode", spans, device_ops(prof), (t0, t1))
    steps = LM_TOKENS - 1
    print(f"the expert layers outside the grouped GEMMs, a call: prefill "
          f"{prefill_rest * 1e-9:.3f} s + decode {decode_rest * 1e-9 * steps / LM_EAGER_STEPS:.3f}"
          f" s ({steps} steps at the eager steps' device time)")
    return 0


def _print_moe(phase: str, spans, ops, window: Tuple[int, int]) -> int:
    """The device time of the ``moe`` spans by operation, the grouped GEMMs
    apart; returns the rest, in ns."""
    by_op = span_kernels(spans, ops, window, "moe")
    gemm = sum(ns for op, ns in by_op.items() if GROUPED_GEMM.search(op))
    rest = sum(by_op.values()) - gemm
    n = sum(1 for sp in spans if sp.name == "moe")
    print(f"{phase}: {n} moe spans, {sum(by_op.values()) / 1e6:.2f} ms of device time: grouped "
          f"GEMMs {gemm / 1e6:.2f} ms, the rest {rest / 1e6:.2f} ms "
          f"({rest / 1e3 / max(1, n):.1f} us a span)")
    rows = sorted(((ns, op) for op, ns in by_op.items() if not GROUPED_GEMM.search(op)),
                  reverse=True)
    for ns, op in rows[:14]:
        print(f"  {ns / 1e6:9.3f} ms  {op[:100]}")
    return rest


def main(argv=None) -> int:
    from torch.profiler import ProfilerActivity, profile

    from ..config import slm_defaults, vq_listener_defaults
    from ..data.loader import PaddedBatchLoader, slm_batch_from_collated
    from ..data.synthetic import synthetic_vico_dataset
    from ..engine.pt_engine import evaluate_test_epoch, make_slmft_generator
    from ..models.slm import SLMFT
    from ..utils.profiling import recording

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lm", help="a DeepSeek-V2 config.json: profile make_lm_generator")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    if args.lm:
        return profile_lm(args.lm)

    torch.manual_seed(SEED)
    model = SLMFT(slm_defaults(), vq_listener_defaults()).to("cuda", torch.bfloat16).eval()
    ds = synthetic_vico_dataset(n_clips=CLIPS, min_len=LENGTH, max_len=LENGTH, seed=3)
    batch = slm_batch_from_collated(next(iter(PaddedBatchLoader(ds, CLIPS, shuffle=False))))
    gen = make_slmft_generator(model)
    rng = torch.Generator(device="cuda").manual_seed(SEED)

    with recording() as warm:
        gen(tuple(torch.as_tensor(x, device="cuda") for x in batch), rng, SAMPLES)  # warm-up
        torch.cuda.synchronize()
    with recording() as spans, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        evaluate_test_epoch(model, gen, [batch], rng, beam_size=SAMPLES, device="cuda")
        torch.cuda.synchronize()
        t1 = time.time_ns()
    ops = device_ops(prof)
    rows = _print_profile(spans, ops, (t0, t1))
    nums = token_numbers(spans, rows)
    print(f"token step: host {nums['host_us_per_token']:.1f} us (median), device "
          f"{nums['device_us_per_token']:.1f} us; token loop's idle "
          f"{nums['loop_idle_ms']:.2f} ms, {nums['loop_share_of_call_idle']:.1f}% of the "
          f"card's idle in the call, which idles {nums['call_idle_share']:.2f}% of its time")
    print(f"{'positions':<10} {'steps':>6} {'host us (median)':>17} {'device us':>10} "
          f"{'idle us':>8}")
    for t, r in by_position(spans, ops, (t0, t1)).items():
        print(f"{t:>4}-{t + BUCKET - 1:<5} {r['n']:>6} {r['host_us']:>17.1f} "
              f"{r['device_us']:>10.1f} {r['idle_us']:>8.1f}")
    got, cap = graph_numbers(spans), graph_numbers(warm)
    print(f"CUDA graphs: {got['graphed']} of the profiled call's {got['token_steps']} token "
          f"steps replayed from a graph ({100 * got['graphed'] / max(1, got['token_steps']):.2f}"
          f"%), {got['captured']} captured in it; the warm-up call captured "
          f"{cap['captured']} in {cap['capture_ms']:.1f} ms of host time")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
