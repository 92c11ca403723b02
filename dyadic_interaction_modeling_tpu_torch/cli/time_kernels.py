"""Time the port's hand-written kernels on the card at the main paths'
shapes: one JSON line a row.

    python -m dyadic_interaction_modeling_tpu_torch.cli.time_kernels

Builds the extension, prints the card's name and power limit (``nvidia-smi``)
and then a row for each kernel and shape: K1 ``decode_attention`` (the
generate call's self step swept over t = 0..255, its cross step and the
grouped-query cross step), K2/K3 ``flash_attention`` forward and backward (in
bf16 the mean launch of an SLM training step's 20, in fp32 at the VQ-VAEs'
head widths D = 48 and 96), K4 ``nearest_code``, K5 ``latent_decode`` and
K6 ``moe_dispatch`` / ``moe_combine`` (DeepSeek-V2-Lite's decode step and
prefill chunk). Each row holds, in µs a launch:

- ``events_us``: one launch between a pair of CUDA events, the median of
  20 pairs, so the host's path to the launch is in it (K1's self row: its
  sweep t = 0..255 between a pair, over 256);
- ``graph_us``: the launches replayed from a CUDA graph, the card alone
  (K1's rows rotate over 4 input sets, so the caches do not sit in L2);
- ``plain_us``: the kernel's plain PyTorch version on the same inputs, one
  call between a pair of events, as ``events_us`` (K6: ``plain_graph_us``,
  from a graph);
- ``library_us``: one PyTorch library call on the same inputs, from a graph
  (SDPA; none for K4 and K6, which no single call computes);
- ``bound_us`` and ``bound_by``: the larger of the bytes over the HBM's
  rate and the operations over the peak (``PEAKS``).

Last, the VQ attention by both routes (``ops.transformer.attend`` and
K2/K3), forward and backward from a graph, at 8 rows and L = 256 to 1024:
the rows that set ``ops.transformer.FLASH_MIN_LEN``. Needs a CUDA device;
without one it exits non-zero and prints no row. ``measure()`` returns the
rows it prints.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

# the H100 SXM's published peaks: HBM bytes/s, and operations/s in bf16 on
# the tensor cores, in fp32 off them (K4), and in 3xTF32 (fp32 K2/K3: three
# TF32 products of 495 TFLOP/s for each fp32 one)
PEAKS = {"hbm": 3.35e12, "bf16": 989e12, "fp32": 67e12, "3xtf32": 495e12 / 3}
L = 256  # the generate call's cache length
VQ_SCALE, SPK_SCALE = 384 ** -0.5, 768 ** -0.5  # the VQ-VAEs' (reference quirk)
# DeepSeek-V2-Lite: hidden 2048, 64 experts top-6, norm_topk_prob false,
# routed_scaling_factor 1; the dsv2_lite cell's 512 rows and 65,536-token
# prefill chunks; its latent cache of 768 rows
DSV2 = dict(hidden=2048, experts=64, top_k=6, rows=512, prefill=65536, cache=768)


def events_ms(fn, reps: int = 20) -> float:
    """Median ms of ``fn(i)``, each call between its own pair of CUDA events,
    after 3 warm-ups."""
    for i in range(3):
        fn(i)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    for i, (start, end) in enumerate(pairs):
        start.record()
        fn(i)
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def graph_ms(fn, stream=None, inner: int = 10, reps: int = 7) -> float:
    """Median ms of one ``fn()`` on the card alone: ``inner`` calls captured
    into a CUDA graph, each of ``reps`` replays between its own pair of
    events. ``stream`` is the capture stream: autograd runs a backward on
    its forward's stream, so a captured backward needs its forward made on
    that stream."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(inner):
            fn()
    graph.replay()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / inner


def autograd_pair(f, inputs, grad_out):
    """``f`` on leaves of its own made on the current stream, as (forward,
    backward) closures."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = f(*leaves)
    return (lambda: f(*leaves),
            lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True))


def backward_on_side(f, inputs, grad_out):
    """(backward closure, its stream): a forward made on a side stream, so
    that its backward can be captured there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _, bwd = autograd_pair(f, inputs, grad_out)
    torch.cuda.current_stream().wait_stream(side)
    return bwd, side


def bound(nbytes: float, ops: float, peak: str):
    t_bytes, t_ops = nbytes / PEAKS["hbm"] * 1e6, ops / PEAKS[peak] * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(kernel, case, fn, plain=None, library=None, bounds=None, per=1, sets=1, inner=10,
        plain_graph=False, **extra):
    """One row: ``fn(i)`` and ``plain(i)`` run ``per`` launches on input set
    ``i % sets``, timed one call a pair of events; the graphs replay all
    ``sets`` calls. ``library`` is a callable of no arguments or (callable,
    capture stream); ``bounds`` (bytes, operations, peak) of one launch."""
    def all_sets(f):
        return lambda: [f(i) for i in range(sets)]

    out = {"kernel": kernel, "case": case,
           "events_us": events_ms(fn) / per * 1e3,
           "graph_us": graph_ms(all_sets(fn), inner=inner) / (per * sets) * 1e3}
    if plain is not None and plain_graph:
        out["plain_graph_us"] = graph_ms(all_sets(plain), inner=inner) / (per * sets) * 1e3
    elif plain is not None:
        out["plain_us"] = events_ms(plain) / per * 1e3
    if library is not None:
        lib, stream = library if isinstance(library, tuple) else (library, None)
        out["library_us"] = graph_ms(lib, stream, inner=inner) / (per * sets) * 1e3
    if bounds is not None:
        out["bound_us"], out["bound_by"] = bound(*bounds)
    out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def k1_rows(g) -> list:
    from ..kernels.decode import decode_attention, decode_attention_plain

    bf = torch.bfloat16
    # the self step: 25 clips x 10 samples x 12 heads over the cache, the mean
    # launch of a call's sweep t = 0..255 (4 input sets, one a decoder layer,
    # so the 196 MB of caches do not sit in L2)
    sets = [[torch.randn(3000, n, 64, device="cuda", generator=g).to(bf) for n in (1, L, L)]
            for _ in range(4)]

    def sweep(f):
        return lambda i=0: [f(*sets[t % 4], t) for t in range(L)]

    nbytes = sum(3000 * 64 * 2 * 2 * (t + 1) for t in range(L)) / L + 2 * 3000 * 64 * 2
    ops = sum(4 * 3000 * 64 * (t + 1) for t in range(L)) / L
    out = [row("K1", "self (3000,1,64) L=256 t=0..255 bf16",
        sweep(lambda q, k, v, t: decode_attention(q, k, v, t, scale=0.125)),
        sweep(lambda q, k, v, t: decode_attention_plain(q, k, v, t, scale=0.125)),
        sweep(lambda q, k, v, t: F.scaled_dot_product_attention(
            q[:, None], k[:, None, : t + 1], v[:, None, : t + 1], scale=0.125)),
        (nbytes, ops, "bf16"), per=L, inner=1)]
    del sets
    # the cross step over the context of L with its key mask: best-of-10
    # (a mask row for 12 heads) and grouped-query best-of-10 (NQ = 120)
    for name, rows, nq, group in (("cross", 300, 10, 12), ("MQA cross", 25, 120, 1)):
        sets = []
        for _ in range(4):
            q, k, v = (torch.randn(rows, n, 64, device="cuda", generator=g).to(bf)
                       for n in (nq, L, L))
            mask = torch.rand(rows // group, L, device="cuda", generator=g) < 0.8
            mask[:, 0] = True
            sets.append((q, k, v, None, mask, mask.repeat_interleave(group, 0)[:, None, None, :]))
        nbytes = rows * L * 64 * 2 * 2 + 2 * rows * nq * 64 * 2 + (rows // group) * L
        out.append(row(
            "K1", f"{name} ({rows},{nq},64) L=256 masked bf16",
            lambda i, sets=sets: decode_attention(*sets[i % 4][:4], scale=0.125),
            lambda i, sets=sets: decode_attention_plain(*sets[i % 4][:4], scale=0.125),
            lambda sets=sets: [F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], attn_mask=m4, scale=0.125)
                for q, k, v, _, _, m4 in sets],
            (nbytes, 4 * rows * nq * L * 64, "bf16"), sets=4))
    return out


def attn_bound(rows, l, d, dtype, mask, causal, bwd):
    """Bytes each input is read and each output written once, of K and V
    only the rows the key mask keeps (no query needs the others); operations
    of the (query, key) pairs this data attends: 4 D per pair forward (Q Kᵀ,
    P V), 10 D backward (Q Kᵀ, dO Vᵀ, Pᵀ dO, dS K, dSᵀ Q), at the bf16 rate
    or in fp32 at the 3xTF32 one."""
    es = torch.finfo(dtype).bits // 8
    if mask is not None:  # key j is attended by l - j queries under causal, else l
        w = l - torch.arange(l, device=mask.device) if causal else l
        pairs = (rows // mask.shape[0]) * float((mask.long() * w).sum())
    elif causal:
        pairs = rows * l * (l + 1) / 2
    else:
        pairs = rows * l * l
    extra = rows * l * 4 + (0 if mask is None else mask.numel())
    io = rows * l * d * es  # one (rows, L, D) tensor
    kv = io if mask is None else (rows // mask.shape[0]) * float(mask.sum()) * d * es
    peak = "3xtf32" if dtype == torch.float32 else "bf16"
    if bwd:  # q, o, dO, dq, dk, dv whole; k, v as kept
        return 6 * io + 2 * kv + extra, 10 * d * pairs, peak
    return 2 * io + 2 * kv + extra, 4 * d * pairs, peak


def k23_rows(g) -> list:
    """Each case's forward and backward; the SLM step's four bf16 cases
    also as their mean over the step's 20 launches."""
    from ..kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    bf, f32 = torch.bfloat16, torch.float32
    # (case, rows, L, D, heads, ragged key mask, causal, scale, dtype, launches an
    # SLM training step); rows are batch x heads
    cases = (("encoder_s/l (384,256,64)", 384, 256, 64, 12, True, False, 0.125, bf, 8),
             ("encoder_joint 2L (384,512,64)", 384, 512, 64, 12, True, False, 0.125, bf, 4),
             ("marginal joint (768,256,64)", 768, 256, 64, 12, True, False, 0.125, bf, 4),
             ("decoder self (768,255,64) causal", 768, 255, 64, 12, False, True, 0.125, bf, 4),
             ("VQ train (8,1024,48)", 8, 1024, 48, 8, False, False, VQ_SCALE, f32, 0),
             ("speaker VQ train (8,1024,96)", 8, 1024, 96, 8, False, False, SPK_SCALE, f32, 0))
    step, out = {"K2": [], "K3": []}, []
    for name, rows, l, d, heads, ragged, causal, scale, dt, per_step in cases:
        q, k, v, do = (torch.randn(rows, l, d, device="cuda", generator=g).to(dt)
                       for _ in range(4))
        mask = m4 = None
        if ragged:  # lengths from L/2 to L
            lens = torch.randint(l // 2, l + 1, (rows // heads,), device="cuda", generator=g)
            mask = torch.arange(l, device="cuda")[None, :] < lens[:, None]
            m4 = mask[:, None, None, :]
        kw = dict(causal=causal, scale=scale)
        o, lse = flash_attention_fwd(q, k, v, mask, **kw)
        b = rows // heads

        def sdpa(q4, k4, v4):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, is_causal=causal,
                                                  scale=scale)

        as4 = [x.view(b, heads, l, d) for x in (q, k, v)]
        sdpa_fwd, _ = autograd_pair(sdpa, as4, do.view(b, heads, l, d))
        tag = f"{name} {str(dt)[6:]}"
        for kernel, fn, plain, lib, bwd in (
                ("K2", lambda _: flash_attention_fwd(q, k, v, mask, **kw),
                 lambda _: flash_attention_fwd_plain(q, k, v, mask, **kw), sdpa_fwd, False),
                ("K3", lambda _: flash_attention_bwd(q, k, v, o, do, lse, mask, **kw),
                 lambda _: flash_attention_bwd_plain(q, k, v, o, do, lse, mask, **kw),
                 backward_on_side(sdpa, as4, do.view(b, heads, l, d)), True)):
            r = row(kernel, tag, fn, plain, lib, attn_bound(rows, l, d, dt, mask, causal, bwd))
            out.append(r)
            if per_step:
                step[kernel].append((per_step, r))
    for kernel, runs in step.items():
        n = sum(c for c, _ in runs)
        mean = {key: sum(c * r[key] for c, r in runs) / n
                for key in ("events_us", "graph_us", "plain_us", "library_us", "bound_us")}
        out.append({"kernel": kernel, "case": f"SLM training step, the mean of its {n} bf16 "
                    "launches", **mean, "bound_by": max((r for _, r in runs),
                                                        key=lambda r: r["bound_us"])["bound_by"]})
        print(json.dumps(out[-1]), flush=True)
    return out


def k4_rows(g) -> list:
    from ..kernels.vq import nearest_code, nearest_code_plain

    # (n, 128) latents x (512, 128) codes: a generate call's encode, a VQ
    # training step's clip, a speaker VQ training step's 8 codes a frame
    out = []
    for n in (6400, 1024, 8192):
        z = torch.randn(n, 128, device="cuda", generator=g)
        e = torch.randn(512, 128, device="cuda", generator=g)
        out.append(row("K4", f"({n},128) x (512,128) fp32", lambda _: nearest_code(z, e),
                       lambda _: nearest_code_plain(z, e),
                       bounds=(n * 128 * 4 + 512 * 128 * 4 + n * 4, 2 * n * 512 * 128,
                               "fp32")))
    return out


def k5_rows(g) -> list:
    from ..kernels.latent_decode import DK, DV, HEADS, latent_decode, latent_decode_plain

    rows, length, scale = DSV2["rows"], DSV2["cache"], 0.1
    q = torch.randn(rows, HEADS, DK, device="cuda", generator=g).bfloat16()
    cache = torch.randn(rows, length, DK, device="cuda", generator=g).bfloat16()
    out = []
    for t in (511, 640, 766):  # the first decode step, mid-call, the last
        mask = (torch.arange(length, device="cuda") <= t).view(1, 1, 1, length)

        def sdpa(mask=mask):  # the cache as one key/value head, values a view
            return F.scaled_dot_product_attention(q[:, None], cache[:, None],
                                                  cache[:, None, :, :DV], attn_mask=mask,
                                                  scale=scale)

        nbytes = rows * ((t + 1) * DK + HEADS * (DK + DV)) * 2
        out.append(row("K5", f"({rows},{HEADS},{DK}) over L={length} t={t} bf16",
                       lambda _, t=t: latent_decode(q, cache, t, scale=scale),
                       lambda _, t=t: latent_decode_plain(q, cache, t, scale=scale), sdpa,
                       (nbytes, 2 * rows * HEADS * (t + 1) * (DK + DV), "bf16"), inner=1))
    return out


def k6_rows(g) -> list:
    from ..kernels.moe_route import (
        moe_combine, moe_combine_plain, moe_dispatch, moe_dispatch_plain)

    h, e, k = DSV2["hidden"], DSV2["experts"], DSV2["top_k"]
    out = []
    for n in (DSV2["rows"], DSV2["prefill"]):
        x = torch.randn(n, h, generator=g, device="cuda").bfloat16()
        gate = (torch.randn(e, h, generator=g, device="cuda") * h ** -0.5).bfloat16()
        shared = torch.randn(n, h, generator=g, device="cuda").bfloat16()
        ys = torch.randn(n * k, h, generator=g, device="cuda").bfloat16()
        load = torch.zeros(e, dtype=torch.int64, device="cuda")
        w, _, _, pos, _ = moe_dispatch(x, gate, k, False, 1.0, load)
        inner = 1 if n > DSV2["rows"] else 10
        case = f"{n} tokens, hidden {h}, {e} experts top-{k} bf16"
        # logits and x read; the routed rows, weights, experts and positions written
        out.append(row(
            "K6 moe_dispatch", case, lambda _: moe_dispatch(x, gate, k, False, 1.0, load),
            lambda _: moe_dispatch_plain(x, gate, k, False, 1.0, load),
            bounds=(n * e * 4 + n * h * 2 + n * k * (h * 2 + 12), 0, "bf16"), inner=inner,
            plain_graph=True, gate_logits_graph_us=graph_ms(
                lambda: F.linear(x.float(), gate.float()), inner=inner) * 1e3))
        # the expert rows, weights and positions, the shared rows read; y written
        out.append(row(
            "K6 moe_combine", case, lambda _: moe_combine(ys, w, pos, shared),
            lambda _: moe_combine_plain(ys, w, pos, shared),
            bounds=(n * k * (h * 2 + 8) + 2 * n * h * 2, 0, "bf16"), inner=inner,
            plain_graph=True))
        del x, shared, ys, w, pos
    return out


def vq_route_rows(g) -> list:
    from ..kernels.attention import flash_attention
    from ..ops.transformer import attend

    out = []
    for (d, scale), dt, l in itertools.product(((48, VQ_SCALE), (96, SPK_SCALE)),
                                               (torch.float32, torch.bfloat16),
                                               (256, 512, 768, 1024)):
        q, k, v, do = (torch.randn(1, 8, l, d, device="cuda", generator=g).to(dt)
                       for _ in range(4))
        routes = {"attend": lambda q, k, v, scale=scale: attend(q, k, v, scale, None),
                  "flash": lambda q, k, v, scale=scale: flash_attention(
                      q[0], k[0], v[0], scale=scale)[None]}
        for route, f in routes.items():
            fwd, _ = autograd_pair(f, (q, k, v), do)
            bwd, side = backward_on_side(f, (q, k, v), do)
            out.append({"kernel": "VQ attention", "case": f"{route} (8,{l},{d}) "
                        f"{str(dt)[6:]}", "fwd_graph_us": graph_ms(fwd) * 1e3,
                        "bwd_graph_us": graph_ms(bwd, stream=side) * 1e3})
            print(json.dumps(out[-1]), flush=True)
    return out


def measure() -> list:
    """The card's line, then every row, each printed as it is measured;
    returns the rows."""
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA device")
    from ..kernels.build import extension

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    extension()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for rows in (k1_rows, k23_rows, k4_rows, k5_rows, k6_rows, vq_route_rows):
        out += rows(g)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    measure()
    return 0


if __name__ == "__main__":
    sys.exit(main())
