#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version, drive SLMFT best-of-10 listener generation
(multi-head and grouped-query), the SLM pretraining step, the VQ-VAE
tokenizer's training step and the SLMFT finetune step at full width, and
time it all.

    python3 chip_smoke.py            # needs one CUDA card

Phases (each prints its own lines; any failure exits 1 without the final
line):

1. device: the card's name and power limit as nvidia-smi prints them;
2. build: ``torch.utils.cpp_extension.load`` of every source in ``csrc/``
   (sm_90a), timed;
3. K4 ``nearest_code`` at (6400, 128) x (512, 128) fp32: exact indices on
   inputs with a margin, >= 99.9% agreement on plain random inputs, a NaN
   latent gets code 0; the same at the SLM training step's (8192, 128), at
   the VQ training and finetune steps' (1024, 128), and at N and n_e that
   are not multiples of the kernel's tiles;
4. K1 ``decode_attention`` in fp32 (tolerance 1e-5) and bf16 (2e-2): the
   self case (3000, 1, 64) x L=256, MQA self (250, 12, 64) and GQA
   (750, 4, 64) at t on both sides of every key-split boundary (Python int
   and device tensor); cross (300, 10, 64) and MQA cross (25, 120, 64) with
   a key mask holding one fully masked row (exactly 0), and in bf16 three
   more calls bitwise equal to the first;
5. K2/K3 ``flash_attention_fwd``/``_bwd`` in fp32 (the CUDA-core kernels)
   and bf16 (the tensor-core kernels) at the training step's four shapes, one
   D = 128 case and L = 2048 (``enc_max_seq_len`` as the joint encoder
   reaches it), ragged key masks (one batch entry fully masked at
   (384, 512, 64): zero output and gradients), a causal tail tile at
   L = 255; the VQ-VAEs' head width D = 48 at scale 384 ** -0.5, (8, 1024,
   48) unmasked (VQ training, one clip) and (32, 512, 48) with ragged
   lengths (four clips tokenized); causal plus the finetune's corruption key
   mask at (48, 255, 64). Tolerances: output fp32 2e-5, bf16 2e-2 (absolute and
   relative); gradients 1e-4 (fp32) and 2e-2 (bf16) of the reference's
   largest magnitude. One bf16 case runs K2 and K3 twice: o, lse, dq, dk, dv
   bitwise equal (no atomics, a fixed order of sums);
6. generation at full width (``slm_defaults()`` + ``vq_listener_defaults()``,
   random init from a seed, bf16): 25 synthetic clips of L=256, best-of-10
   through ``make_slmft_generator`` and ``evaluate_test_epoch`` with every
   launch count set to 0 just before and read just after (K1 2040, K4 2,
   K2/K3 0); then in fp32 at B0=4, N=2 one token sequence teacher-forced
   through ``decode_step`` with the kernels and with the plain versions
   (``plain_attention``; logits within 1e-3), and the VQ codes on the card
   against the CPU's;
7. times of generation and of K1/K4 (below), then grouped-query generation:
   the same with ``attn_kv_heads=1`` (one K/V head; cross attention folds
   G = 12 heads x N = 10 samples into NQ = 120 query rows), one generate
   call with the same launch counts, then its fp32 teacher-forced check at
   B0=2, N=10;
8. training at full width: SLM, fp32 parameters under bf16 autocast, AdamW
   (1e-5, weight decay 0.01) with clip 1.0 and the VQ encoders and
   quantizers frozen, 32 synthetic CANDOR clips of L=256 (``bench.py:54``):
   3 warmup steps, then 10 steps, each between its own pair of CUDA events,
   with every launch count set to 0 just before and read just after (20
   K2, 20 K3 and 2 K4 a step), finite losses, frozen parameters bitwise
   unchanged and every trainable transformer parameter moved; then one fp32
   step at B=4 with ragged lengths (128-256) with the kernels and with the
   plain versions on the card (equal VQ codes, losses within 1e-5 relative,
   gradients of the non-VQ leaves within 1e-3 of each leaf's largest
   magnitude), and K4's codes in that step against the plain version on the
   latents it was given (``k4_on_path``; likewise in 10 and 11);
9. times after warmup: the median of 3 best-of-10 generate calls (host
   clock); for each kernel at the main paths' shapes (K2/K3 in bf16, and
   the D = 48 shapes in fp32 too), its plain version and
   one PyTorch library call on the same inputs where there is one
   (yardstick only, never on the port's path): ``ms``, the median of single
   launches each between its own pair of CUDA events (for K1 self, the
   median over sweeps t = 0..255 of a sweep's mean launch), which also
   times the host's path to the launch; ``graph_ms``, the same launches
   replayed from a CUDA graph between a pair of events, the card alone
   (K1 self, cross and MQA cross, K4, K2/K3, and SDPA beside K1-K3 as
   ``library_graph_ms``); the training step's median, and three steps under
   ``torch.profiler`` tracing the card only (device busy share of that
   window, top device kernels);
10. VQ-VAE tokenizer training at full width (``vq_listener_defaults()``:
    hidden 384, 6 + 6 layers, 8 heads of 48, 512 x 128 codes), fp32, one
    synthetic clip of 1024 frames, AdamW (1e-4, weight decay 0.01): steps
    timed and traced as in 8 and 9, with 12 K2, 12 K3 and 1 K4 a step,
    finite metrics and every parameter moved; then one fp32 step with the kernels and with the
    plain versions (equal codes, metrics within 1e-5 relative, gradients
    within 1e-3 of each leaf's largest magnitude);
11. the SLMFT finetune at full width, fp32 parameters under bf16 autocast,
    4 synthetic ViCo clips of L = 256, AdamW (1e-5, weight decay 0.01), clip
    1.0, both VQs frozen: steps timed and traced as in 8 and 9, with 4 K2,
    4 K3 (the decoder's causal self-attention under the 15% corruption key
    mask) and 2 K4 a step, frozen VQs bitwise unchanged, every trainable
    transformer tensor moved; then one fp32 step at ragged lengths (128-256) against the
    plain versions, as in 10, on clips whose speaker moves
    (``_finetune_batch`` says why); and on the ViCo-shaped clips, the fp32
    runs with the kernels and with the plain versions against the plain
    versions in fp64: on each leaf the kernels' error within 1e-3 or 4x the
    plain fp32 run's;
12. the VQ attention at D = 48 by both routes (``attend`` and K2/K3),
    forward and backward, graph-timed at L = 256 and 1024 in fp32 and bf16;
    then the ``kernels`` JSON line and, last, the device JSON line.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on tensor cores, 67 TFLOP/s fp32 on CUDA cores.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
B0, N, L = 25, 10, 256
FAILURES = []


def say(*parts):
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    say(("ok   " if ok else "FAIL ") + what)
    if not ok:
        FAILURES.append(what)


def phase(fn):
    def run(*args, **kwargs):
        say(f"== {fn.__name__}")
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        except Exception:  # report the phase as failed, keep the others going
            traceback.print_exc(file=sys.stdout)
            FAILURES.append(f"{fn.__name__} raised")
            return None
        finally:
            say(f"   {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return run


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn(i)`` over ``reps`` calls, each between its own pair
    of CUDA events, after 3 warmups."""
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
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def graph_ms(fn, stream=None, reps: int = 7, inner: int = 10) -> float:
    """Median ms of one ``fn()`` on the card alone: ``inner`` calls are
    captured into a CUDA graph and each of ``reps`` replays is timed between
    its own pair of CUDA events, so the host's launch path, which can cost
    more than a short kernel, is not in the number. ``stream`` is the capture
    stream: autograd runs a backward on its forward's stream, so a captured
    backward needs its forward made on that stream."""
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


def _autograd_pair(f, inputs, grad_out):
    """``f`` on leaves of its own made on the current stream, as (forward,
    backward) closures: autograd runs a backward on its forward's stream, so
    a backward captured in a graph needs its forward made on that stream."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = f(*leaves)
    return (lambda: f(*leaves),
            lambda: torch.autograd.grad(out, leaves, grad_out, retain_graph=True))


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_attention():
    """Inside, the x-transformers stack and the VQ-VAEs' attention call the
    plain versions of K1 (``decode_attention``) and K2/K3
    (``flash_attention``) on the card, so a path can be held against itself
    without the kernels."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.attention import flash_attention_plain
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention_plain
    from dyadic_interaction_modeling_tpu_torch.models import xtrans
    from dyadic_interaction_modeling_tpu_torch.ops import transformer

    with mock.patch.multiple(xtrans, decode_attention=decode_attention_plain,
                             flash_attention=flash_attention_plain), \
            mock.patch.object(transformer, "flash_attention", flash_attention_plain):
        yield


@contextlib.contextmanager
def k4_calls():
    """Inside, every K4 launch of the model (``ops.quantizer``'s) is recorded
    as (latents, codebook, codes), so that the codes a path took can be held
    against the plain version on the same latents afterwards."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.ops import quantizer

    calls, kernel = [], quantizer._nearest_code

    def record(z, e):
        idx = kernel(z, e)
        calls.append((z.detach().clone(), e.detach().clone(), idx))
        return idx

    with mock.patch.object(quantizer, "_nearest_code", record):
        yield calls


def k4_on_path(calls, what):
    """Recorded K4 codes against ``nearest_code_plain`` on the same latents:
    equal, but for rows whose two codes' fp64 distances tie to 1e-5 of
    |z|^2 + |e|^2 (the rounding of two fp32 sums in different orders), and
    at most 0.1% of the rows (the random-input rule of ``k4_check``)."""
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code_plain

    rows = differ = 0
    worst = 0.0
    for z, e, got in calls:
        ref = nearest_code_plain(z, e)
        diff = got != ref
        scale = (z.double() ** 2).sum(1) + (e.double()[ref.long()] ** 2).sum(1)
        gap = (_dist64(z, e, got) - _dist64(z, e, ref)).abs() / scale
        worst = max(worst, float(gap[diff].max()) if bool(diff.any()) else 0.0)
        rows, differ = rows + got.numel(), differ + int(diff.sum())
    shapes = sorted({(tuple(z.shape), tuple(e.shape)) for z, e, _ in calls})
    check(bool(calls) and worst <= 1e-5 and differ <= rows // 1000,
          f"K4 on {what}'s own latents ({len(calls)} launches at {shapes}): "
          f"{rows - differ} of {rows} codes equal to the plain version's, the others "
          f"ties (largest relative distance gap {worst:.3g}, tol 1e-5)")
    return {"launches": len(calls), "rows": rows, "differ": differ, "tie_gap": worst}


@phase
def device():
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    say(line)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return line


@phase
def build():
    from dyadic_interaction_modeling_tpu_torch.kernels import build as B

    t0 = time.perf_counter()
    B.extension()
    secs = time.perf_counter() - t0
    say(f"built {', '.join(B.SOURCES)} with torch.utils.cpp_extension.load in "
        f"{secs:.1f} s (nvcc {' '.join(B.CUDA_FLAGS)})")
    return secs


def _dist64(z, e, idx):
    z, e = z.double(), e.double()
    return ((z - e[idx.long()]) ** 2).sum(1)


@phase
def k4_check():
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    g = torch.Generator(device="cuda").manual_seed(1)
    e = torch.randn(512, 128, device="cuda", generator=g)
    want = torch.randint(0, 512, (6400,), device="cuda", generator=g)
    z = e[want] + 0.01 * torch.randn(6400, 128, device="cuda", generator=g)
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    check(bool((got == want.int()).all()) and bool((nearest_code_plain(z, e) == got).all()),
          "K4 margin inputs: exact indices (kernel == plain == truth)")
    z = torch.randn(6400, 128, device="cuda", generator=g)
    e = torch.randn(512, 128, device="cuda", generator=g)
    got, ref = nearest_code(z, e), nearest_code_plain(z, e)
    agree = float((got == ref).float().mean())
    gap = float((_dist64(z, e, got) - _dist64(z, e, ref)).abs().max())
    check(agree >= 0.999, f"K4 random inputs: {agree:.5f} of rows agree (>= 0.999), "
          f"max distance gap {gap:.3g}")
    zn = z[:64].clone()
    zn[5] = float("nan")
    got = nearest_code(zn, e)
    check(bool((got == nearest_code_plain(zn, e)).all()) and int(got[5]) == 0,
          "K4 NaN latent: code 0, other rows as the plain version")
    # the SLM training step's shape, the VQ training and finetune steps' (one
    # clip of 1024 frames; 4 clips of 256), and ragged N and n_e against the
    # kernel's tiles
    for n, n_e, d in ((8192, 512, 128), (1024, 512, 128), (6401, 500, 128), (70, 130, 20)):
        e = torch.randn(n_e, d, device="cuda", generator=g)
        want = torch.randint(0, n_e, (n,), device="cuda", generator=g)
        z = e[want] + 0.01 * torch.randn(n, d, device="cuda", generator=g)
        got = nearest_code(z, e)
        exact = bool((got == want.int()).all()) and bool((nearest_code_plain(z, e) == got).all())
        z = torch.randn(n, d, device="cuda", generator=g)
        a = float((nearest_code(z, e) == nearest_code_plain(z, e)).float().mean())
        check(exact and a >= 0.999, f"K4 ({n}, {d}) x ({n_e}, {d}): exact on margin "
              f"inputs {exact}, {a:.5f} of random rows agree (>= 0.999)")
        agree = min(agree, a)
    return {"max_abs_err": gap, "agree": agree}


def _k1_inputs(rows, nq, dtype, g, masked=False, n_sets=1, group=12):
    """q, k, v at L and, with ``masked``, a (rows // group, L) key mask whose
    row 3 is fully masked (cache rows [3 group, 4 group))."""
    sets = []
    for _ in range(n_sets):
        q = torch.randn(rows, nq, 64, device="cuda", generator=g).to(dtype)
        k = torch.randn(rows, L, 64, device="cuda", generator=g).to(dtype)
        v = torch.randn(rows, L, 64, device="cuda", generator=g).to(dtype)
        mask = None
        if masked:
            mask = torch.rand(rows // group, L, device="cuda", generator=g) < 0.8
            mask[:, 0] = True
            mask[3] = False  # one fully masked context row
        sets.append((q, k, v, mask))
    return sets


# t on both sides of the key splits' boundaries (chunks of 16, 32 or 64 keys)
SPLIT_TS = (0, 1, 15, 16, 31, 32, 63, 64, 127, 128, 191, 192, 200, 255)


@phase
def k1_check():
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}

    def err(out, ref):
        return float((out.float() - ref.float()).abs().max())

    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        errs = []
        # (name, rows, NQ): self, MQA self (G = 12), GQA (G = 4), under t bounds
        for name, rows, nq in (("self", 3000, 1), ("MQA self", 250, 12), ("GQA", 750, 4)):
            (q, k, v, _), = _k1_inputs(rows, nq, dtype, g)
            e = 0.0
            for t in SPLIT_TS:
                ref = decode_attention_plain(q, k, v, t, scale=0.125)
                for tt in (t, torch.tensor(t, dtype=torch.int32, device="cuda")):
                    e = max(e, err(decode_attention(q, k, v, tt, scale=0.125), ref))
            check(e <= tol, f"K1 {name} {tag} ({rows},{nq},64) L=256, t in {SPLIT_TS} as "
                  f"int and device tensor: max abs err {e:.3g} (tol {tol})")
            errs.append(e)
        # cross attention with a key mask holding one fully masked context row:
        # best-of-10 (300, 10) and MQA best-of-10 (25, 120)
        for name, rows, nq, group in (("cross", 300, 10, 12), ("MQA cross", 25, 120, 1)):
            (q, k, v, mask), = _k1_inputs(rows, nq, dtype, g, masked=True, group=group)
            out = decode_attention(q, k, v, None, mask, scale=0.125)
            e = err(out, decode_attention_plain(q, k, v, None, mask, scale=0.125))
            zero = float(out[3 * group:4 * group].float().abs().max())
            same = True
            if dtype == torch.bfloat16:
                same = all(torch.equal(out, decode_attention(q, k, v, None, mask, scale=0.125))
                           for _ in range(3))
            check(e <= tol and zero == 0.0 and same,
                  f"K1 {name} {tag} ({rows},{nq},64) masked, one fully masked row: max abs "
                  f"err {e:.3g} (tol {tol}), masked row max {zero}"
                  + (f", three more calls bitwise equal: {same}" if dtype == torch.bfloat16
                     else ""))
            errs.append(e)
        worst[tag] = max(errs)
    torch.cuda.synchronize()
    return worst


HEADS = 12
VQ_SCALE = 384 ** -0.5  # the VQ-VAEs' full-width scale (reference quirk), D = 384 / 8
# (name, rows, L, D, heads, key mask, causal, scale, launches per SLM training
# step); rows are batch x heads, a key mask (rows / heads, L): "prefix"
# ragged lengths from L/2 to L, "random" the finetune's corruption (15% of
# the keys a row, never key 0)
K23_CASES = (
    ("encoder_s/l (384,256,64) masked", 384, 256, 64, HEADS, "prefix", False, 0.125, 8),
    ("encoder_joint 2L (384,512,64) masked", 384, 512, 64, HEADS, "prefix", False, 0.125, 4),
    ("marginal joint (768,256,64) masked", 768, 256, 64, HEADS, "prefix", False, 0.125, 4),
    ("decoder self (768,255,64) causal", 768, 255, 64, HEADS, None, True, 0.125, 4),
    ("D=128 (192,512,128) masked", 192, 512, 128, HEADS, "prefix", False, 128 ** -0.5, 0),
    ("enc_max_seq_len (24,2048,64) masked", 24, 2048, 64, HEADS, "prefix", False, 0.125, 0),
    ("VQ train (8,1024,48)", 8, 1024, 48, 8, None, False, VQ_SCALE, 0),
    ("VQ tokenize B=4 (32,512,48) masked", 32, 512, 48, 8, "prefix", False, VQ_SCALE, 0),
    ("finetune decoder (48,255,64) causal+mask", 48, 255, 64, HEADS, "random", True, 0.125,
     0),
)
DEAD_CASE = 1  # index of the case with one fully masked batch entry, run twice in bf16
# the D = 48 cases, timed in fp32 (VQ training's dtype) as well
VQ_CASES = tuple(i for i, c in enumerate(K23_CASES) if c[3] == 48)
SOURCES = {torch.float32: "dyadic_interaction_modeling_tpu_torch/csrc/flash_attention.cu",
           torch.bfloat16: "dyadic_interaction_modeling_tpu_torch/csrc/flash_attention_mma.cu"}


def _attn_inputs(rows, l, d, heads, dtype, g, mask_kind, dead=False):
    q, k, v, do = (torch.randn(rows, l, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    mask = None
    if mask_kind == "prefix":
        lens = torch.randint(l // 2, l + 1, (rows // heads,), device="cuda", generator=g)
        mask = torch.arange(l, device="cuda")[None, :] < lens[:, None]
    elif mask_kind == "random":  # the finetune's input corruption
        from dyadic_interaction_modeling_tpu_torch.models.xtrans import ar_mask_prob_kv_mask

        mask = ar_mask_prob_kv_mask(rows // heads, l, 0.15, generator=g, device="cuda")
    if dead:
        mask[1] = False
    return q, k, v, do, mask


@phase
def k23_check():
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {}
    for dtype, tol_o, tol_g in ((torch.float32, 2e-5, 1e-4), (torch.bfloat16, 2e-2, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        e_o, e_g, e_ga = [], [], []
        for i, (name, rows, l, d, heads, mask_kind, causal, scale, _) in enumerate(K23_CASES):
            q, k, v, do, mask = _attn_inputs(rows, l, d, heads, dtype, g, mask_kind,
                                             i == DEAD_CASE)
            kw = dict(causal=causal, scale=scale)
            o, lse = flash_attention_fwd(q, k, v, mask, **kw)
            ro, rlse = flash_attention_fwd_plain(q, k, v, mask, **kw)
            grads = flash_attention_bwd(q, k, v, ro, do, rlse, mask, **kw)
            refs = flash_attention_bwd_plain(q, k, v, ro, do, rlse, mask, **kw)
            torch.cuda.synchronize()
            diff = (o.float() - ro.float()).abs()
            rtol = 0.0 if dtype == torch.float32 else tol_o
            ok_o = bool((diff <= tol_o + rtol * ro.float().abs()).all())
            fin = torch.isfinite(rlse)
            same_inf = torch.equal(fin, torch.isfinite(lse))
            err_lse = float((lse[fin] - rlse[fin]).abs().max())
            err_g = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
                     for a, b in zip(grads, refs)]
            err_ga = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(grads, refs))
            zero = True
            if i == DEAD_CASE:
                dead = slice(HEADS, 2 * HEADS)
                zero = (float(o[dead].float().abs().max()) == 0.0 and all(
                    float(x[dead].float().abs().max()) == 0.0 for x in grads)
                    and bool(torch.isinf(lse[dead]).all()))
            check(ok_o and same_inf and err_lse <= 1e-4 and max(err_g) <= tol_g and zero,
                  f"K2/K3 {tag} {name}: o max abs err {float(diff.max()):.3g} "
                  f"(tol {tol_o}{' + rel' if rtol else ''}), lse {err_lse:.3g}, dq/dk/dv "
                  f"rel {err_g[0]:.3g}/{err_g[1]:.3g}/{err_g[2]:.3g} (tol {tol_g})"
                  + (f", fully masked entry zero: {zero}" if i == DEAD_CASE else ""))
            e_o.append(float(diff.max()))
            e_g.append(max(err_g))
            e_ga.append(err_ga)
            if i == DEAD_CASE and dtype == torch.bfloat16:
                again = (*flash_attention_fwd(q, k, v, mask, **kw),
                         *flash_attention_bwd(q, k, v, ro, do, rlse, mask, **kw))
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip((o, lse, *grads), again)),
                      f"K2/K3 {tag} {name}: a second call gives bitwise the same o, lse, "
                      "dq, dk, dv")
        worst[tag] = {"fwd_abs": max(e_o), "bwd_rel": max(e_g), "bwd_abs": max(e_ga)}
    return worst


def _model(dtype, seed=0, kv_heads=0):
    """SLMFT at full width; ``kv_heads`` = 1 is grouped-query (MQA) attention."""
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT

    slm_cfg, vq_cfg = slm_defaults(), vq_listener_defaults()
    slm_cfg["attn_kv_heads"] = kv_heads
    torch.manual_seed(seed)
    model = SLMFT(slm_cfg, vq_cfg)
    return model, slm_cfg


def _clips(n_clips, seed=3):
    from dyadic_interaction_modeling_tpu_torch.data.loader import (
        PaddedBatchLoader, slm_batch_from_collated)
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset

    ds = synthetic_vico_dataset(n_clips=n_clips, min_len=L, max_len=L, seed=seed)
    return [slm_batch_from_collated(c) + (c[5],)
            for c in PaddedBatchLoader(ds, n_clips, shuffle=False)]


def _generate(kv_heads):
    """Best-of-N generation of B0 clips, every launch count set to 0 just
    before and read just after."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import (
        evaluate_test_epoch, make_slmft_generator)
    from dyadic_interaction_modeling_tpu_torch.metrics.reporting import print_metrics

    model, slm_cfg = _model(torch.bfloat16, kv_heads=kv_heads)
    model = model.to("cuda", torch.bfloat16).eval()
    gen = make_slmft_generator(model)
    batches = _clips(B0)
    seen = {}

    def traced(batch, g, n):
        cands, tokens = gen(batch, g, n, return_tokens=True)
        seen["cands"], seen["tokens"] = cands, tokens
        return cands

    rng = torch.Generator(device="cuda").manual_seed(0)
    kernels.reset_launch_counts()
    y_true, y_pred, xs, _ = evaluate_test_epoch(model, traced, batches, rng,
                                                beam_size=N, device="cuda")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    tag = "MQA (attn_kv_heads=1) " if kv_heads else ""
    say(f"launches in the {tag}best-of-{N} run: {launches}")
    cands, tokens = seen["cands"], seen["tokens"]
    check(tuple(cands.shape) == (B0, N, L - 1, 56),
          f"{tag}candidate shape {tuple(cands.shape)} == {(B0, N, L - 1, 56)}")
    check(bool(torch.isfinite(cands.float()).all()), f"{tag}candidates finite")
    check(bool(((tokens >= 0) & (tokens < 512)).all()), f"{tag}tokens in [0, 512)")
    want = {"decode_attention": (L - 1) * 4 * 2, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "nearest_code": 2}
    check(launches == want, f"{tag}generation launches {launches} == {want} (K1 self and "
          "cross in 4 decoder layers x 255 steps, K4 twice, no K2/K3)")
    m = print_metrics(y_true, y_pred, xs, verbose=False)
    fd = [m[k] for k in ("fid_pose", "fid_exp", "mse_pose", "mse_exp")]
    check(all(v == v and abs(v) != float("inf") for v in fd),
          f"{tag}FD and MSE finite: fid_pose {m['fid_pose']:.4f} fid_exp {m['fid_exp']:.4f}")
    return model, gen, batches[0], launches


@phase
def slice_main_path():
    return _generate(kv_heads=0)


@phase
def mqa_main_path():
    """Grouped-query generation (one K/V head: step_cross folds G = 12 heads
    x N = 10 samples into NQ = 120 query rows a context), one generate call."""
    launches = _generate(kv_heads=1)[3]
    torch.cuda.empty_cache()
    return launches


def _reference(b0, n, kv_heads):
    """fp32 at B0 clips x N samples: kernels vs plain versions on the card,
    and the card's VQ codes against the CPU's."""
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import init_decoder_cache

    tag = f"{'MQA ' if kv_heads else ''}B0={b0} N={n}"
    cpu_model, _ = _model(torch.float32, seed=1, kv_heads=kv_heads)
    cpu_model.eval()
    model = _model(torch.float32, seed=1, kv_heads=kv_heads)[0].to("cuda").eval()
    batch = _clips(b0, seed=5)[0]
    src_v, tgt, src_a, mask = (torch.as_tensor(x) for x in batch[:4])
    with torch.no_grad():
        codes_cpu = cpu_model.forward_vq(src_v, tgt, mask)[1]
        codes_gpu = model.forward_vq(src_v.cuda(), tgt.cuda(), mask.cuda())[1].cpu()
        same = float((codes_cpu == codes_gpu).float().mean())
        check(same >= 0.99, f"{tag} listener VQ codes, card (K4) vs CPU (plain): "
              f"{same:.4f} equal (>= 0.99)")
        ctx, prompt = model.encode_context(src_v.cuda(), tgt.cuda(), src_a.cuda(),
                                           mask.cuda())
        dec = model.decoder
        cross = dec.cross_kv(ctx)
        g = torch.Generator(device="cuda").manual_seed(4)
        seq = torch.randint(0, 512, (n * b0, L - 1), device="cuda", generator=g)
        seq = torch.cat([prompt.repeat(n, 1).to(seq.dtype), seq], dim=1)
        maskc = mask.cuda()
        worst = 0.0
        caches = [init_decoder_cache(n * b0, L, dec.depth, dec.heads, dec.dim_head,
                                     torch.float32, dec.kv_heads, "cuda")
                  for _ in range(2)]
        for t in range(L):
            tok = seq[:, t: t + 1]
            a = dec.decode_step(tok, caches[0], t, cross, maskc, n)
            with plain_attention():
                b = dec.decode_step(tok, caches[1], t, cross, maskc, n)
            worst = max(worst, float((a - b).abs().max()))
    check(worst <= 1e-3, f"teacher-forced decode_step fp32 {tag}, {L} steps: "
          f"logits max abs err kernel vs plain {worst:.3g} (tol 1e-3)")
    return worst


@phase
def slice_reference():
    return _reference(4, 2, kv_heads=0)


@phase
def mqa_reference():
    """Cross attention at NQ = G x N = 120 query rows a context."""
    return _reference(2, N, kv_heads=1)


TRAIN_B, TRAIN_STEPS, WARMUP_STEPS, PROFILED_STEPS = 32, 10, 3, 3
STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 20,
                 "flash_attention_bwd": 20, "nearest_code": 2}


def _slm(seed):
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM

    torch.manual_seed(seed)
    return SLM(slm_defaults(), vq_listener_defaults())


def _candor(n_clips, seed):
    """n_clips synthetic CANDOR clips of length L, as one batch on the card."""
    from dyadic_interaction_modeling_tpu_torch.data.loader import (
        PaddedBatchLoader, slm_batch_from_collated)
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_candor_dataset

    ds = synthetic_candor_dataset(n_clips=n_clips, min_len=L, max_len=L, seed=seed)
    collated = next(iter(PaddedBatchLoader(ds, n_clips, shuffle=False)))
    return tuple(torch.as_tensor(x, device="cuda") for x in slm_batch_from_collated(collated))


@phase
def train_main_path():
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM_FROZEN

    model = _slm(seed=0).to("cuda")
    opt = make_optimizer(model, 1e-5, 0.01, SLM_FROZEN)
    step = make_slm_train_step(model, opt, 1.0, torch.bfloat16)
    batch = _candor(TRAIN_B, seed=7)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(0)
    logs = [step(batch, g) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(TRAIN_STEPS)]
    kernels.reset_launch_counts()
    for start, end in pairs:
        start.record()
        logs.append(step(batch, g))
        end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    times = [start.elapsed_time(end) / 1e3 for start, end in pairs]
    want = {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()}
    say(f"launches in {TRAIN_STEPS} training steps: {launches}")
    check(launches == want, f"training launches == {want} (20 K2, 20 K3, 2 K4 a step)")
    check(all(bool(torch.isfinite(v).all()) for lg in logs for v in lg.values()),
          f"losses finite over {len(logs)} steps")
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(bool(frozen) and all(torch.equal(model.get_parameter(k), before[k])
                               for k in frozen),
          f"{len(frozen)} frozen VQ encoder/quantizer tensors bitwise unchanged")
    moving = [k for k, p in model.named_parameters() if p.requires_grad
              and k.startswith(("encoder_", "decoder_joint"))]
    still = [k for k in moving if torch.equal(model.get_parameter(k), before[k])]
    check(not still, f"all {len(moving)} trainable transformer tensors moved "
          f"(unmoved: {still[:5]})")
    med = statistics.median(times)
    first = {k: round(float(v), 4) for k, v in logs[0].items()}
    last = {k: round(float(v), 4) for k, v in logs[-1].items()}
    say(f"SLM train step B={TRAIN_B} L={L} bf16 autocast, CUDA events: median "
        f"{med * 1e3:.2f} ms of "
        f"{[round(t * 1e3, 2) for t in times]} -> {TRAIN_B * L / med:.0f} frames/s")
    say(f"logs of the first warmup step {first}; of the last step {last}")
    return {"model": model, "step": step, "batch": batch, "gen": g,
            "launches": launches, "step_ms": med * 1e3,
            "step_runs_ms": [t * 1e3 for t in times]}


@phase
def train_reference():
    """One fp32 step at B=4 with ragged lengths: kernels against the plain
    versions on the card, from the same weights and noise; K4's codes
    against the plain version on the latents it was given."""
    what = "the SLM training step"
    b = 4
    src_v, tgt, src_a, _ = _candor(b, seed=9)
    lens = torch.tensor([L, 211, 170, 128], device="cuda")
    mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    state = _slm(seed=1).state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = tuple(torch.rand(b, L, device="cuda", generator=g) for _ in range(2))
    results, codes = [], []
    for plain in (False, True):
        model = _slm(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda")
        with plain_attention() if plain else k4_calls() as calls:
            with torch.no_grad():
                codes.append(model.forward_vq(src_v, tgt, mask))
            out = model(src_v, tgt, src_a, mask, noise=noise)
            out.total_loss.backward()
        logs = {k: float(v) for k, v in out.logs.items()}
        logs["total"] = float(out.total_loss.detach())
        results.append((logs, {k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None}))
        if not plain:
            k4 = k4_on_path(calls, what)
    check(all(torch.equal(a, b) for a, b in zip(*codes)),
          "both runs' speaker and listener VQ codes equal (K4 is deterministic)")
    (lk, gk), (lp, gp) = results
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, "fp32 step B=4 ragged, kernels vs plain: losses "
          f"rel err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-30))
            for k in gp}
    core = {k: e for k, e in errs.items() if "_vq." not in k}
    vq = {k: e for k, e in errs.items() if "_vq." in k}
    worst = max(core, key=core.get)
    check(core[worst] <= 1e-3, f"gradients of {len(core)} non-VQ leaves within 1e-3 of "
          f"each leaf's max: worst {core[worst]:.3g} ({worst})")
    say(f"VQ-decoder leaves (float-noise gradients, reported only): worst "
        f"{max(vq.values()):.3g} over {len(vq)} leaves")
    return {"loss_rel": max(rel.values()), "grad_rel": core[worst], "k4": k4}


def _attn_bound(rows, l, d, dtype, mask, causal, bwd):
    """Bytes each input is read and each output written once; operations of
    the (query, key) pairs this data attends: 4 D per pair forward (Q Kᵀ,
    P V), 10 D backward (Q Kᵀ, dO Vᵀ, Pᵀ dO, dS K, dSᵀ Q)."""
    es = torch.finfo(dtype).bits // 8
    if mask is not None:  # key j is attended by l - j queries under causal, else l
        w = l - torch.arange(l, device=mask.device) if causal else l
        pairs = (rows // mask.shape[0]) * float((mask.long() * w).sum())
    elif causal:
        pairs = rows * l * (l + 1) / 2
    else:
        pairs = rows * l * l
    extra = rows * l * 4 + (0 if mask is None else mask.numel())
    io = rows * l * d * es
    if bwd:
        return bound_ms(8 * io + extra, 10 * d * pairs, dtype)
    return bound_ms(4 * io + extra, 4 * d * pairs, dtype)


def _trace_steps(step, args, what):
    """The same window of PROFILED_STEPS steps traced twice by
    ``torch.profiler``: the card alone (its busy share is the one reported),
    then also the host's operators. Returns the two windows and the device
    kernels with the most time a step (name, µs, launches), from the
    second."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from dyadic_interaction_modeling_tpu_torch.cli.profile_generate import _busy_us

    windows = {}
    for tag, acts in (("card", [ProfilerActivity.CUDA]),
                      ("card+host", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(*args)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = _busy_us(kern)
        windows[tag] = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                        "busy_share": busy / wall_us, "kernels": len(kern)}
        say(f"{PROFILED_STEPS} {what} steps traced ({tag}): wall {wall_us / 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
            f"{len(kern)} kernels")
    check(windows["card"]["kernels"] > 0, f"tracing the card alone records the {what} "
          "step's kernels")
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.end - e.time_range.start, cnt + 1)
    top = [(name, tot / PROFILED_STEPS, cnt / PROFILED_STEPS) for name, (tot, cnt)
           in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    say(f"device time a {what} step by kernel (card+host window):")
    for name, tot, cnt in top:
        say(f"  {tot / 1e3:9.3f} ms  {cnt:7.1f} x  {name[:100]}")
    return windows, top


@phase
def train_timings(train):
    import torch.nn.functional as F
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    windows, top = _trace_steps(train["step"], (train["batch"], train["gen"]), "train")
    del train["model"], train["step"]
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    cases = {}
    # every case in bf16, the D = 48 (VQ) cases also in fp32, VQ training's dtype
    runs = [(c, bf, c[0]) for c in K23_CASES]
    runs += [(K23_CASES[i], torch.float32, K23_CASES[i][0] + " fp32") for i in VQ_CASES]
    for (name, rows, l, d, heads, mask_kind, causal, scale, per_step), dt, key in runs:
        q, k, v, do, mask = _attn_inputs(rows, l, d, heads, dt, g, mask_kind)
        kw = dict(causal=causal, scale=scale)
        o, lse = flash_attention_fwd(q, k, v, mask, **kw)
        b = rows // heads
        m4 = None if mask is None else mask[:, None, None, :]
        if causal and m4 is not None:  # SDPA takes a mask or is_causal, not both
            m4 = m4 & torch.ones(l, l, dtype=torch.bool, device="cuda").tril()

        def sdpa_fwd(q4, k4, v4, m4=m4, causal=causal and m4 is None, scale=scale):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4, is_causal=causal,
                                                  scale=scale)

        as4 = [x.view(b, heads, l, d) for x in (q, k, v)]
        sdpa, sdpa_bwd = _autograd_pair(sdpa_fwd, as4, do.view(b, heads, l, d))
        side = torch.cuda.Stream()  # a second forward, for the captured backward
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _, sdpa_bwd_side = _autograd_pair(sdpa_fwd, as4, do.view(b, heads, l, d))
        torch.cuda.current_stream().wait_stream(side)
        # ms and library_ms: single launches between events, the method of every
        # other kernel here; graph_ms and library_graph_ms: the card alone
        fwd = dict(
            ms=cuda_ms(lambda i: flash_attention_fwd(q, k, v, mask, **kw), 20),
            plain_ms=cuda_ms(lambda i: flash_attention_fwd_plain(q, k, v, mask, **kw), 10),
            library_ms=cuda_ms(lambda i: sdpa(), 20),
            graph_ms=graph_ms(lambda: flash_attention_fwd(q, k, v, mask, **kw)),
            library_graph_ms=graph_ms(sdpa))
        fwd["bound_ms"], fwd["bound_by"] = _attn_bound(rows, l, d, dt, mask, causal, False)
        bwd = dict(
            ms=cuda_ms(lambda i: flash_attention_bwd(q, k, v, o, do, lse, mask, **kw), 20),
            plain_ms=cuda_ms(lambda i: flash_attention_bwd_plain(q, k, v, o, do, lse, mask,
                                                                 **kw), 10),
            library_ms=cuda_ms(lambda i: sdpa_bwd(), 20),
            graph_ms=graph_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, mask, **kw)),
            library_graph_ms=graph_ms(sdpa_bwd_side, stream=side))
        bwd["bound_ms"], bwd["bound_by"] = _attn_bound(rows, l, d, dt, mask, causal, True)
        cases[key] = {"per_step": per_step if dt == bf else 0, "dtype": str(dt)[6:],
                      "fwd": fwd, "bwd": bwd}
        for tag, r in (("K2", fwd), ("K3", bwd)):
            say(f"{tag} {key}{'' if dt != bf else ' bf16'}: kernel {r['ms'] * 1e3:.1f} us, "
                f"plain {r['plain_ms'] * 1e3:.1f} us, SDPA {r['library_ms'] * 1e3:.1f} us, "
                f"from a CUDA graph: kernel {r['graph_ms'] * 1e3:.1f} us, SDPA "
                f"{r['library_graph_ms'] * 1e3:.1f} us, "
                f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
        del q, k, v, do, o, lse, sdpa, sdpa_bwd, sdpa_bwd_side
        torch.cuda.empty_cache()
    per_step = {}
    for which in ("fwd", "bwd"):
        per_step[which] = {key: sum(c["per_step"] * c[which][key] for c in cases.values())
                           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                       "graph_ms", "library_graph_ms")}
        say(f"{which} summed over a step's 20 launches: " + ", ".join(
            f"{key} {val:.3f}" for key, val in per_step[which].items()))
    return {"busy_share": windows["card"]["busy_share"], "windows": windows,
            "top": [(n, t / 1e3, c) for n, t, c in top], "cases": cases,
            "per_step": per_step}


VQ_L, FT_B = 1024, 4
VQ_STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 12,
                    "flash_attention_bwd": 12, "nearest_code": 1}
FT_STEP_LAUNCHES = {"decode_attention": 0, "flash_attention_fwd": 4,
                    "flash_attention_bwd": 4, "nearest_code": 2}


def _timed_steps(step, args, what, want_per_step):
    """WARMUP_STEPS steps, then TRAIN_STEPS each between its own pair of CUDA
    events, with every launch count set to 0 just before those and read just
    after. Returns (median step s, every step in s, launches, metrics of
    each step)."""
    from dyadic_interaction_modeling_tpu_torch import kernels

    logs = [step(*args) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(TRAIN_STEPS)]
    kernels.reset_launch_counts()
    for start, end in pairs:
        start.record()
        logs.append(step(*args))
        end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    times = [start.elapsed_time(end) / 1e3 for start, end in pairs]
    want = {k: v * TRAIN_STEPS for k, v in want_per_step.items()}
    say(f"launches in {TRAIN_STEPS} {what} steps: {launches}")
    check(launches == want, f"{what} launches == {want} (a step: {want_per_step})")
    check(all(bool(torch.isfinite(v).all()) for lg in logs for v in lg.values()),
          f"{what}: metrics finite over {len(logs)} steps")
    return statistics.median(times), times, launches, logs


def _vq_model(seed):
    from dyadic_interaction_modeling_tpu_torch.config import vq_listener_defaults
    from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder

    torch.manual_seed(seed)
    return VQAutoEncoder(vq_listener_defaults())


def _vq_clip(seed):
    """One synthetic listener clip of VQ_L frames, as the VQ collate gives it."""
    from dyadic_interaction_modeling_tpu_torch.data.loader import vq_collate
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset

    ds = synthetic_vico_dataset(n_clips=1, min_len=VQ_L, max_len=VQ_L, seed=seed)
    return torch.as_tensor(vq_collate([(ds[0][1],)]), device="cuda")


@phase
def vq_train_main_path():
    """VQ-VAE tokenizer training at full width (vq_listener_defaults: hidden
    384, 6 + 6 layers, 8 heads of 48, 512 x 128 codes), fp32, one clip of
    1024 frames, AdamW lr 1e-4 with weight decay 0.01 (train_vq's)."""
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.engine.vq_engine import make_vq_train_step

    model = _vq_model(seed=0).to("cuda")
    step = make_vq_train_step(model, make_optimizer(model, 1e-4, 0.01))
    clip = _vq_clip(seed=11)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    med, times, launches, logs = _timed_steps(step, (clip,), "VQ training", VQ_STEP_LAUNCHES)
    still = [k for k, p in model.named_parameters() if torch.equal(p, before[k])]
    check(not still, f"all {len(before)} VQ parameter tensors moved (unmoved: {still[:5]})")
    say(f"VQ train step B=1 L={VQ_L} fp32, CUDA events: median {med * 1e3:.2f} ms of "
        f"{[round(t * 1e3, 2) for t in times]} -> {VQ_L / med:.0f} frames/s")
    say(f"metrics of the first warmup step {_rounded(logs[0])}; of the last {_rounded(logs[-1])}")
    windows, top = _trace_steps(step, (clip,), "VQ training")
    return {"launches": launches, "step_ms": med * 1e3, "step_runs_ms": [t * 1e3 for t in times],
            "windows": windows, "top": [(n, t / 1e3, c) for n, t, c in top]}


def _rounded(logs):
    return {k: round(float(v), 4) for k, v in logs.items()}


def _grad_errs(gk, gp):
    return {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-30))
            for k in gp}


@phase
def vq_train_reference():
    """One fp32 VQ step's forward and backward with the kernels and with
    their plain versions, from the same weights on the same clip: equal
    codes, losses within 1e-5 relative, gradients within 1e-3 of each
    leaf's largest magnitude. K4 runs in both (``plain_attention`` swaps the
    attention only), so its codes are held against ``nearest_code_plain`` on
    the latents it was given (``k4_on_path``)."""
    from dyadic_interaction_modeling_tpu_torch.metrics.loss import calc_vq_loss

    clip = _vq_clip(seed=12)
    state = _vq_model(seed=1).state_dict()
    results = []
    for plain in (False, True):
        model = _vq_model(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda")
        with plain_attention() if plain else k4_calls() as calls:
            dec, emb_loss, enc = model(clip)
            total, (rec, quant) = calc_vq_loss(dec, clip, emb_loss)
            total.backward()
        results.append(({"loss": float(total.detach()), "rec_loss": float(rec),
                          "quant_loss": float(quant), "perplexity": float(enc.perplexity)},
                         enc.indices, {k: p.grad for k, p in model.named_parameters()
                                       if p.grad is not None}))
        if not plain:
            k4 = k4_on_path(calls, "the VQ training step")
    (lk, ck, gk), (lp, cp, gp) = results
    check(torch.equal(ck, cp), f"VQ codes equal with the kernels and with the plain versions "
          f"({ck.numel()} codes)")
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, f"fp32 VQ step L={VQ_L}, kernels vs plain: metrics rel "
          f"err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = _grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-3, f"gradients of {len(errs)} VQ leaves within 1e-3 of each "
          f"leaf's max: worst {errs[worst]:.3g} ({worst})")
    return {"loss_rel": max(rel.values()), "grad_rel": errs[worst], "k4": k4}


def _finetune_batch(lens, seed, moving_speaker=False):
    """FT_B synthetic clips of L frames, as one batch on the card, with the
    key mask of ``lens``: ViCo-shaped (whose speaker motion is constant, as
    the synthetic ViCo set makes it), or with ``moving_speaker`` the same
    layout with smooth speaker motion (the synthetic CANDOR set). Under a
    constant speaker the speaker encoders' query and key gradients cancel to
    ~1e-6 of their value gradients, too little to hold two runs' rounding
    against, so the kernel-vs-plain comparison takes moving speakers."""
    batch = _candor(FT_B, seed) if moving_speaker else (
        torch.as_tensor(x, device="cuda") for x in _clips(FT_B, seed)[0][:4])
    src_v, tgt, src_a, _ = batch
    mask = torch.arange(L, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    return src_v, tgt, src_a, mask


@phase
def finetune_main_path():
    """The SLMFT listener finetune at full width (slm_defaults +
    vq_listener_defaults): fp32 parameters under bf16 autocast, FT_B clips of
    L = 256, AdamW lr 1e-5 with weight decay 0.01, clip 1.0, both VQs frozen
    (finetune_s2s_pretrain's)."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT_FROZEN

    model = _model(torch.float32, seed=0)[0].to("cuda")
    opt = make_optimizer(model, 1e-5, 0.01, SLMFT_FROZEN)
    step = make_slm_train_step(model, opt, 1.0, torch.bfloat16)
    batch = _finetune_batch([L] * FT_B, seed=13)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(0)
    med, times, launches, logs = _timed_steps(step, (batch, g), "finetune", FT_STEP_LAUNCHES)
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    check(bool(frozen) and all(k.startswith(SLMFT_FROZEN) for k in frozen)
          and all(torch.equal(model.get_parameter(k), before[k]) for k in frozen),
          f"{len(frozen)} frozen VQ tensors bitwise unchanged")
    moving = [k for k, p in model.named_parameters() if p.requires_grad
              and k.startswith(("encoder_", "decoder_joint"))]
    still = [k for k in moving if torch.equal(model.get_parameter(k), before[k])]
    check(not still, f"all {len(moving)} trainable transformer tensors moved "
          f"(unmoved: {still[:5]})")
    say(f"SLMFT finetune step B={FT_B} L={L} bf16 autocast, CUDA events: median "
        f"{med * 1e3:.2f} ms of {[round(t * 1e3, 2) for t in times]} -> "
        f"{FT_B * L / med:.0f} frames/s")
    say(f"logs of the first warmup step {_rounded(logs[0])}; of the last {_rounded(logs[-1])}")
    windows, top = _trace_steps(step, (batch, g), "finetune")
    return {"launches": launches, "step_ms": med * 1e3, "step_runs_ms": [t * 1e3 for t in times],
            "windows": windows, "top": [(n, t / 1e3, c) for n, t, c in top]}


@phase
def finetune_reference():
    """One fp32 finetune step at FT_B clips of ragged lengths (128-256), with
    the kernels and with the plain versions, from the same weights and
    corruption noise: equal codes, losses within 1e-5 relative, gradients
    within 1e-3 of each leaf's largest magnitude; K4's codes against the
    plain version on the latents it was given."""
    what = "the finetune step"
    batch = _finetune_batch([L, 211, 170, 128], seed=14, moving_speaker=True)
    state = _model(torch.float32, seed=1)[0].state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = torch.randn(FT_B, L - 1, device="cuda", generator=g)
    results, codes = [], []
    for plain in (False, True):
        model = _model(torch.float32, seed=1)[0]
        model.load_state_dict(state)
        model = model.to("cuda")
        with plain_attention() if plain else k4_calls() as calls:
            with torch.no_grad():
                codes.append(model.forward_vq(batch[0], batch[1], batch[3]))
            out = model(*batch, noise=noise)
            out.total_loss.backward()
        logs = {k: float(v) for k, v in out.logs.items() if k in ("l_ce_l", "l_cont_l")}
        logs["total"] = float(out.total_loss.detach())
        results.append((logs, {k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None}))
        if not plain:
            k4 = k4_on_path(calls, what)
    check(all(torch.equal(a, b) for a, b in zip(*codes)),
          "both runs' speaker and listener VQ codes equal")
    (lk, gk), (lp, gp) = results
    rel = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    check(max(rel.values()) <= 1e-5, f"fp32 finetune step B={FT_B} ragged, kernels vs plain: "
          f"losses rel err {max(rel.values()):.3g} (tol 1e-5): {lk}")
    errs = _grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-3, f"gradients of {len(errs)} leaves within 1e-3 of each leaf's "
          f"max: worst {errs[worst]:.3g} ({worst})")
    return {"loss_rel": max(rel.values()), "grad_rel": errs[worst], "k4": k4}


@contextlib.contextmanager
def fp64_where_fp32():
    """Inside, ``Tensor.float()`` leaves an fp64 tensor as it is, so that a
    model run in fp64 stays in fp64 where it rounds to fp32 on purpose
    (attention scores and softmax, the cross-entropy's log-softmax)."""
    from unittest import mock

    to_float = torch.Tensor.float

    def keep64(x, *args, **kwargs):
        return x if x.dtype == torch.float64 else to_float(x, *args, **kwargs)

    with mock.patch.object(torch.Tensor, "float", keep64):
        yield


def finetune_grads_fp64(make_model, batch, noise):
    """The gradients of one finetune loss, from the same weights, VQ codes
    and corruption noise: fp32 with the kernels, fp32 with the plain
    versions, and the plain versions in fp64 (``fp64_where_fp32``). The
    first run's VQ codes stand in all three, so that a run in another dtype
    cannot take another code at a tie."""
    runs, codes = [], None
    for plain, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.float64)):
        model = make_model().to(batch[0].device, dtype)
        if codes is None:
            with torch.no_grad():
                codes = model.forward_vq(batch[0], batch[1], batch[3])
        model.forward_vq = lambda *args: codes
        inputs = [x.to(dtype) if x.is_floating_point() else x for x in batch]
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_attention())
            if dtype == torch.float64:
                stack.enter_context(fp64_where_fp32())
            model(*inputs, noise=noise).total_loss.backward()
        runs.append({k: p.grad.double() for k, p in model.named_parameters()
                     if p.grad is not None})
        del model
    return runs


@phase
def finetune_fp64_reference():
    """The ViCo-shaped clips (a constant speaker) at ragged lengths
    (128-256), which ``finetune_reference`` does not take: there the speaker
    encoder's query and key gradients cancel (``_finetune_batch``), so that
    fp32 rounding alone moves them by percents of their largest magnitude.
    Both fp32 runs, with the kernels and with the plain versions, are held
    against the plain versions in fp64: on every leaf the kernels' error,
    relative to the fp64 leaf's largest magnitude, is within 1e-3 or within
    4x the plain fp32 run's error on that leaf."""
    batch = _finetune_batch([L, 211, 170, 128], seed=14)
    state = _model(torch.float32, seed=1)[0].state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = torch.randn(FT_B, L - 1, device="cuda", generator=g)

    def make_model():
        model = _model(torch.float32, seed=1)[0]
        model.load_state_dict(state)
        return model

    gk, gp, g64 = finetune_grads_fp64(make_model, batch, noise)
    ek, ep, ekp = _grad_errs(gk, g64), _grad_errs(gp, g64), _grad_errs(gk, gp)
    worst = max(ekp, key=ekp.get)
    say(f"kernels vs plain, both fp32: worst {ekp[worst]:.3g} of the leaf's max ({worst})")
    hard = sorted((k for k in g64 if ep[k] > 1e-3), key=ep.get, reverse=True)
    big = max(float(x.abs().max()) for x in g64.values())
    rows = {}
    for k in hard:
        v = k.replace(".to_q.", ".to_v.").replace(".to_k.", ".to_v.")
        rows[k] = {"kernels": ek[k], "plain_fp32": ep[k], "fp64_max": float(g64[k].abs().max()),
                   "to_v_fp64_max": float(g64[v].abs().max()) if v in g64 else None}
    for k, r in list(rows.items())[:6]:
        say(f"  {k}: off fp64 by {r['kernels']:.3g} (kernels) and {r['plain_fp32']:.3g} "
            f"(plain fp32) of its largest fp64 magnitude {r['fp64_max']:.3g} "
            f"(its layer's to_v: {r['to_v_fp64_max']}; largest of all leaves {big:.3g})")
    easy = [k for k in g64 if k not in rows]
    rest = max(easy, key=ek.get)
    say(f"the other {len(easy)} leaves: the kernels within {ek[rest]:.3g} of fp64 ({rest}), "
        f"the plain fp32 run within {max(ep[k] for k in easy):.3g}")
    bad = [k for k in g64 if ek[k] > max(1e-3, 4 * ep[k])]
    ratio = max(ek[k] / ep[k] for k in hard) if hard else None
    check(not bad, f"fp32 finetune step on ViCo-shaped clips against fp64: the kernels' "
          f"error within 1e-3 or 4x the plain fp32 run's on each of {len(g64)} leaves "
          f"({len(hard)} leaves where the plain fp32 run is past 1e-3, largest ratio "
          f"{ratio}; worst kernel error {max(ek.values()):.3g}; failing: {bad[:5]})")
    return {"kernels_vs_plain_fp32": ekp[worst], "kernels_vs_plain_fp32_leaf": worst,
            "kernels_vs_fp64": max(ek.values()), "plain_fp32_vs_fp64": max(ep.values()),
            "past_1e-3": rows, "largest_ratio": ratio, "kernels_vs_fp64_other_leaves": ek[rest]}


@phase
def vq_attention_routes():
    """The VQ attention at D = 48 by both routes, forward and forward +
    backward, graph-timed (the card alone): the matmul path (``attend``) and
    K2/K3, at L = 256 and 1024, 8 rows (one clip, 8 heads), fp32 and bf16.
    These set the port's L >= 512 gate in a later change."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import flash_attention
    from dyadic_interaction_modeling_tpu_torch.ops.transformer import attend

    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for l in (256, 1024):
            q, k, v, do = (torch.randn(1, 8, l, 48, device="cuda", generator=g).to(dt)
                           for _ in range(4))
            routes = {"attend": lambda q, k, v: attend(q, k, v, VQ_SCALE, None),
                      "flash": lambda q, k, v: flash_attention(
                          q[0], k[0], v[0], scale=VQ_SCALE)[None]}
            for route, f in routes.items():
                fwd, _ = _autograd_pair(f, (q, k, v), do)
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    _, bwd = _autograd_pair(f, (q, k, v), do)
                torch.cuda.current_stream().wait_stream(side)
                r = {"fwd_graph_ms": graph_ms(fwd), "bwd_graph_ms": graph_ms(bwd, stream=side)}
                out[f"{route} {str(dt)[6:]} L={l}"] = r
                say(f"VQ attention (8,{l},48) {str(dt)[6:]} by {route}: forward "
                    f"{r['fwd_graph_ms'] * 1e3:.1f} us, backward {r['bwd_graph_ms'] * 1e3:.1f} "
                    "us (from a CUDA graph)")
            del q, k, v, do
    return out


@phase
def timings(main):
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)
    import torch.nn.functional as F

    model, gen, batch, _ = main
    tensors = tuple(torch.as_tensor(x, device="cuda") for x in batch[:4])
    rng = torch.Generator(device="cuda").manual_seed(11)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen(tensors, rng, N)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    say(f"best-of-{N} generate, {B0} clips x L={L}, bf16: median {med * 1e3:.1f} ms "
        f"of {[round(t * 1e3, 1) for t in times]} -> {B0 * N * (L - 1) / med:.0f} "
        f"sampled frames/s")

    g = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    out = {}
    # ms: single launches between CUDA events (a K1 self sweep t = 0..255
    # between a pair, / 256), which also times the host's path to the launch;
    # graph_ms: the same launches replayed from a CUDA graph, the card alone
    # K1 self: the mean launch of a generate is the sweep t = 0..255 (4 input
    # sets, one per decoder layer, so the 196 MB caches do not sit in L2)
    sets = _k1_inputs(3000, 1, bf, g, n_sets=4)
    nbytes = sum(3000 * 64 * 2 * 2 * (t + 1) for t in range(L)) / L + 2 * 3000 * 64 * 2
    ops = sum(4 * 3000 * 64 * (t + 1) for t in range(L)) / L

    def sweep(fn):
        return lambda i=0: [fn(*sets[(i + t) % 4][:3], t) for t in range(L)]

    kern = sweep(lambda q, k, v, t: decode_attention(q, k, v, t, scale=0.125))
    plain = sweep(lambda q, k, v, t: decode_attention_plain(q, k, v, t, scale=0.125))
    sdpa = sweep(lambda q, k, v, t: F.scaled_dot_product_attention(
        q[:, None], k[:, None, : t + 1], v[:, None, : t + 1], scale=0.125))
    out["self"] = dict(ms=cuda_ms(kern, 7) / L, plain_ms=cuda_ms(plain, 3) / L,
                       library_ms=cuda_ms(sdpa, 7) / L, graph_ms=graph_ms(kern, inner=1) / L,
                       library_graph_ms=graph_ms(sdpa, inner=1) / L)
    out["self"]["bound_ms"], out["self"]["bound_by"] = bound_ms(nbytes, ops, bf)
    del sets
    # K1 cross: (300, 10, 64) and MQA cross (25, 120, 64) against the full
    # L=256 context, key mask
    for name, rows, nq, group in (("cross", 300, 10, 12), ("mqa_cross", 25, 120, 1)):
        sets = _k1_inputs(rows, nq, bf, g, masked=True, n_sets=4, group=group)
        nbytes = rows * L * 64 * 2 * 2 + 2 * rows * nq * 64 * 2 + (rows // group) * L
        masks4 = [s[3].repeat_interleave(group, 0)[:, None, None, :] for s in sets]

        def kern(i=0, sets=sets):
            return decode_attention(*sets[i % 4][:3], None, sets[i % 4][3], scale=0.125)

        def plain(i=0, sets=sets):
            return decode_attention_plain(*sets[i % 4][:3], None, sets[i % 4][3], scale=0.125)

        def sdpa(i=0, sets=sets, masks4=masks4):
            return F.scaled_dot_product_attention(
                sets[i % 4][0][:, None], sets[i % 4][1][:, None], sets[i % 4][2][:, None],
                attn_mask=masks4[i % 4], scale=0.125)

        r = dict(ms=cuda_ms(kern, 200), plain_ms=cuda_ms(plain, 50),
                 library_ms=cuda_ms(sdpa, 200),
                 graph_ms=graph_ms(lambda: [kern(i) for i in range(4)]) / 4,
                 library_graph_ms=graph_ms(lambda: [sdpa(i) for i in range(4)]) / 4)
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 4 * rows * nq * L * 64, bf)
        out[name] = r
        del sets, masks4
    # K4: (n, 128) latents x (512, 128) codebook, fp32: n = 6400 in a
    # generate, 1024 in a VQ training step and twice in a finetune step
    for name, n in (("vq", 6400), ("vq_1024", 1024)):
        z = torch.randn(n, 128, device="cuda", generator=g)
        e = torch.randn(512, 128, device="cuda", generator=g)
        r = dict(ms=cuda_ms(lambda i: nearest_code(z, e), 200),
                 plain_ms=cuda_ms(lambda i: nearest_code_plain(z, e), 200), library_ms=None,
                 graph_ms=graph_ms(lambda: nearest_code(z, e)), library_graph_ms=None)
        r["bound_ms"], r["bound_by"] = bound_ms(n * 128 * 4 + 512 * 128 * 4 + n * 4,
                                                2 * n * 512 * 128, torch.float32)
        out[name] = r
    for name, r in out.items():
        lib = ("n/a" if r["library_ms"] is None else
               f"{r['library_ms'] * 1e3:.2f} us (graph {r['library_graph_ms'] * 1e3:.2f} us)")
        say(f"{name:9s}: kernel {r['ms'] * 1e3:.2f} us (graph {r['graph_ms'] * 1e3:.2f} us), "
            f"plain {r['plain_ms'] * 1e3:.2f} us, library {lib}, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return {"generate_ms": med * 1e3, "generate_runs_ms": [t * 1e3 for t in times],
            **out}


def _flash_entry(name, line, which, tt, k23, by_path):
    cases = tt["cases"]
    return {"name": name, "route": "cuda", "source": SOURCES[torch.bfloat16],
            "sources_by_dtype": {str(k).replace("torch.", ""): v for k, v in SOURCES.items()},
            "replaces": f"dyadic_interaction_modeling_tpu/ops/pallas/attention.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": k23["bfloat16"]["fwd_abs" if which == "fwd" else "bwd_abs"],
            # launch-weighted means over one SLM training step's 20 launches
            **{key: val / 20 for key, val in tt["per_step"][which].items()},
            "bound_by": max((c[which] for c in cases.values() if c["per_step"]),
                            key=lambda r: r["bound_ms"])["bound_by"],
            "cases": {k: c[which] for k, c in cases.items()}, "max_err": k23}


def kernels_line(gen_launches, mqa_launches, train, vq, ft, k4, k1, k23, t, tt, routes,
                 refs, ft64, build_s):
    self_, cross = t["self"], t["cross"]
    mean = {key: (self_[key] + cross[key]) / 2
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "graph_ms",
                        "library_graph_ms")}
    paths = {f"train_{TRAIN_STEPS}_steps": train["launches"],
             f"vq_train_{TRAIN_STEPS}_steps": vq["launches"],
             f"finetune_{TRAIN_STEPS}_steps": ft["launches"]}

    def by_path(name, generate=None):
        out = {} if generate is None else generate
        return {**out, **{path: counts[name] for path, counts in paths.items()}}

    k4_paths = by_path("nearest_code", {"generate": gen_launches["nearest_code"],
                                        "generate_mqa": mqa_launches["nearest_code"]})
    return {"kernels": [
        {"name": "decode_attention", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/decode_attention.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/decode.py:129",
         "launches": gen_launches["decode_attention"],
         "launches_by_path": by_path("decode_attention", {
             "generate": gen_launches["decode_attention"],
             "generate_mqa": mqa_launches["decode_attention"]}),
         "max_abs_err": k1["bfloat16"], **mean, "bound_by": "bytes",
         "cases": {"self (3000,1,64) L=256 t=0..255 bf16": self_,
                   "cross (300,10,64) L=256 masked bf16": cross,
                   "MQA cross (25,120,64) L=256 masked bf16": t["mqa_cross"],
                   "max_abs_err": k1}},
        _flash_entry("flash_attention_fwd", 111, "fwd", tt, k23,
                     by_path("flash_attention_fwd", {"generate": 0})),
        _flash_entry("flash_attention_bwd", 152, "bwd", tt, k23,
                     by_path("flash_attention_bwd", {"generate": 0})),
        {"name": "nearest_code", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/vq.py:49",
         "launches": sum(v for k, v in k4_paths.items() if k != "generate_mqa"),
         "launches_by_path": k4_paths,
         "max_abs_err": k4["max_abs_err"], **t["vq"], "agree": k4["agree"],
         "cases": {"(6400,128) x (512,128) fp32 (generate)": t["vq"],
                   "(1024,128) x (512,128) fp32 (VQ training, finetune)": t["vq_1024"]},
         "on_path_latents": {path: r["k4"] for path, r in refs.items()}},
    ], "generate_ms": t["generate_ms"], "generate_runs_ms": t["generate_runs_ms"],
        "train_step_ms": train["step_ms"], "train_step_runs_ms": train["step_runs_ms"],
        "train_frames_per_s": TRAIN_B * L / train["step_ms"] * 1e3,
        "train_busy_share": tt["busy_share"], "train_traced_windows": tt["windows"],
        "vq_train_step_ms": vq["step_ms"], "vq_train_step_runs_ms": vq["step_runs_ms"],
        "vq_train_frames_per_s": VQ_L / vq["step_ms"] * 1e3,
        "vq_train_busy_share": vq["windows"]["card"]["busy_share"],
        "vq_train_traced_windows": vq["windows"],
        "finetune_step_ms": ft["step_ms"], "finetune_step_runs_ms": ft["step_runs_ms"],
        "finetune_frames_per_s": FT_B * L / ft["step_ms"] * 1e3,
        "finetune_busy_share": ft["windows"]["card"]["busy_share"],
        "finetune_traced_windows": ft["windows"],
        "finetune_fp64_reference": ft64, "vq_attention_routes": routes, "build_s": build_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dyadic_interaction_modeling_tpu_torch  # noqa: F401 - fails alone

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = device()
    build_s = build()
    k4 = k4_check()
    k1 = k1_check()
    k23 = k23_check()
    main_run = slice_main_path()
    slice_reference()
    t = timings(main_run) if main_run else None
    gen_launches = main_run[3] if main_run else None
    del main_run
    torch.cuda.empty_cache()
    mqa_launches = mqa_main_path()
    mqa_ref = mqa_reference()
    train = train_main_path()
    train_ref = train_reference()
    tt = train_timings(train) if train else None
    vq = vq_train_main_path()
    vq_ref = vq_train_reference()
    torch.cuda.empty_cache()
    ft = finetune_main_path()
    ft_ref = finetune_reference()
    ft64 = finetune_fp64_reference()
    torch.cuda.empty_cache()
    routes = vq_attention_routes()
    if FAILURES or None in (smi, build_s, k4, k1, k23, t, mqa_launches, mqa_ref, train,
                            train_ref, tt, vq, vq_ref, ft, ft_ref, ft64, routes):
        say(f"FAILED: {FAILURES}")
        return 1
    refs = {"train": train_ref, "vq_train": vq_ref, "finetune": ft_ref}
    say(json.dumps(kernels_line(gen_launches, mqa_launches, train, vq, ft, k4, k1, k23, t,
                                tt, routes, refs, ft64, build_s)))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
