#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version, drive SLMFT best-of-10 listener generation
and the SLM pretraining step at full width, and time it all.

    python3 chip_smoke.py            # needs one CUDA card

Phases (each prints its own lines; any failure exits 1 without the final
line):

1. device: the card's name and power limit as nvidia-smi prints them;
2. build: ``torch.utils.cpp_extension.load`` of every source in ``csrc/``
   (sm_90a), timed;
3. K4 ``nearest_code`` at (6400, 128) x (512, 128) fp32: exact indices on
   inputs with a margin, >= 99.9% agreement on plain random inputs;
4. K1 ``decode_attention`` in fp32 (tolerance 1e-5) and bf16 (2e-2): the
   self case (3000, 1, 64) x L=256 at several t (Python int and device
   tensor), the cross case (300, 10, 64) with a key mask holding one fully
   masked row, and a GQA case with NQ = G = 4 under a t bound;
5. K2/K3 ``flash_attention_fwd``/``_bwd`` in fp32 (the CUDA-core kernels)
   and bf16 (the tensor-core kernels) at the training step's four shapes, one
   D = 128 case and L = 2048 (``enc_max_seq_len`` as the joint encoder
   reaches it), ragged key masks (one batch entry fully masked at
   (384, 512, 64): zero output and gradients), a causal tail tile at
   L = 255. Tolerances: output fp32 2e-5, bf16 2e-2 (absolute and
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
7. training at full width: SLM, fp32 parameters under bf16 autocast, AdamW
   (1e-5, weight decay 0.01) with clip 1.0 and the VQ encoders and
   quantizers frozen, 32 synthetic CANDOR clips of L=256 (``bench.py:54``):
   3 warmup steps, then 10 steps, each between its own pair of CUDA events,
   with every launch count set to 0 just before and read just after (20
   K2, 20 K3 and 2 K4 a step), finite losses, frozen parameters bitwise
   unchanged and every trainable transformer parameter moved; then one fp32
   step at B=4 with ragged lengths (128-256) with the kernels and with the
   plain versions on the card (equal VQ codes, losses within 1e-5 relative,
   gradients of the non-VQ leaves within 1e-3 of each leaf's largest
   magnitude);
8. times after warmup: the median of 3 best-of-10 generate calls (host
   clock), the median per-launch time of each kernel at the main paths'
   shapes from CUDA events (for K1 self, the median over sweeps t = 0..255
   of a sweep's mean launch; for K2/K3 and their library call, whose launch
   costs the host more than the kernel costs the card, ten launches replayed
   from a CUDA graph between the events, so the card alone is timed), its
   plain version's, and one PyTorch library
   call on the same inputs where there is one (yardstick only, never on the
   port's path); the training step's median, and three steps under
   ``torch.profiler`` tracing the card only (device busy share of that
   window, top device kernels); then the ``kernels`` JSON line and, last,
   the device JSON line.

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


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_attention():
    """Inside, the x-transformers stack calls the plain versions of K1
    (``decode_attention``) and K2/K3 (``flash_attention``) on the card, so a
    path can be held against itself without the kernels."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.attention import flash_attention_plain
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention_plain
    from dyadic_interaction_modeling_tpu_torch.models import xtrans

    with mock.patch.multiple(xtrans, decode_attention=decode_attention_plain,
                             flash_attention=flash_attention_plain):
        yield


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
    return {"max_abs_err": gap, "agree": agree}


def _k1_inputs(rows, nq, dtype, g, masked=False, n_sets=1):
    sets = []
    for _ in range(n_sets):
        q = torch.randn(rows, nq, 64, device="cuda", generator=g).to(dtype)
        k = torch.randn(rows, L, 64, device="cuda", generator=g).to(dtype)
        v = torch.randn(rows, L, 64, device="cuda", generator=g).to(dtype)
        mask = None
        if masked:
            mask = torch.rand(rows // 12, L, device="cuda", generator=g) < 0.8
            mask[:, 0] = True
            mask[3] = False  # one fully masked context row
        sets.append((q, k, v, mask))
    return sets


@phase
def k1_check():
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        tag = str(dtype).replace("torch.", "")
        errs = []
        (q, k, v, _), = _k1_inputs(3000, 1, dtype, g)
        for t in (0, 1, 63, 64, 127, 200, 255):
            for tt in (t, torch.tensor(t, dtype=torch.int32, device="cuda")):
                out = decode_attention(q, k, v, tt, scale=0.125)
                ref = decode_attention_plain(q, k, v, t, scale=0.125)
                errs.append(float((out.float() - ref.float()).abs().max()))
        check(max(errs) <= tol, f"K1 self {tag} (3000,1,64) L=256 t in 0..255: "
              f"max abs err {max(errs):.3g} (tol {tol})")
        (q, k, v, mask), = _k1_inputs(300, 10, dtype, g, masked=True)
        out = decode_attention(q, k, v, None, mask, scale=0.125)
        ref = decode_attention_plain(q, k, v, None, mask, scale=0.125)
        err_c = float((out.float() - ref.float()).abs().max())
        zero = float(out[3 * 12:4 * 12].float().abs().max())
        check(err_c <= tol and zero == 0.0,
              f"K1 cross {tag} (300,10,64) masked, one fully masked row: max abs "
              f"err {err_c:.3g} (tol {tol}), masked row max {zero}")
        (q, k, v, _), = _k1_inputs(750, 4, dtype, g)
        err_g = 0.0
        for t in (0, 37, 255):
            out = decode_attention(q, k, v, t, scale=0.125)
            ref = decode_attention_plain(q, k, v, t, scale=0.125)
            err_g = max(err_g, float((out.float() - ref.float()).abs().max()))
        check(err_g <= tol, f"K1 GQA {tag} (750,4,64) t in (0,37,255): max abs err "
              f"{err_g:.3g} (tol {tol})")
        worst[tag] = max(errs + [err_c, err_g])
    torch.cuda.synchronize()
    return worst


HEADS = 12
# (name, rows, L, D, key mask, causal, launches per training step); rows are
# batch x heads, the key mask (rows / HEADS, L)
K23_CASES = (
    ("encoder_s/l (384,256,64) masked", 384, 256, 64, True, False, 8),
    ("encoder_joint 2L (384,512,64) masked", 384, 512, 64, True, False, 4),
    ("marginal joint (768,256,64) masked", 768, 256, 64, True, False, 4),
    ("decoder self (768,255,64) causal", 768, 255, 64, False, True, 4),
    ("D=128 (192,512,128) masked", 192, 512, 128, True, False, 0),
    ("enc_max_seq_len (24,2048,64) masked", 24, 2048, 64, True, False, 0),
)
DEAD_CASE = 1  # index of the case with one fully masked batch entry, run twice in bf16
SOURCES = {torch.float32: "dyadic_interaction_modeling_tpu_torch/csrc/flash_attention.cu",
           torch.bfloat16: "dyadic_interaction_modeling_tpu_torch/csrc/flash_attention_mma.cu"}


def _attn_inputs(rows, l, d, dtype, g, masked, dead=False):
    q, k, v, do = (torch.randn(rows, l, d, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    mask = None
    if masked:
        lens = torch.randint(l // 2, l + 1, (rows // HEADS,), device="cuda", generator=g)
        mask = torch.arange(l, device="cuda")[None, :] < lens[:, None]
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
        for i, (name, rows, l, d, masked, causal, _) in enumerate(K23_CASES):
            q, k, v, do, mask = _attn_inputs(rows, l, d, dtype, g, masked, i == DEAD_CASE)
            kw = dict(causal=causal, scale=d ** -0.5)
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


def _model(dtype, seed=0):
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT

    slm_cfg, vq_cfg = slm_defaults(), vq_listener_defaults()
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


@phase
def slice_main_path():
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import (
        evaluate_test_epoch, make_slmft_generator)
    from dyadic_interaction_modeling_tpu_torch.metrics.reporting import print_metrics

    model, slm_cfg = _model(torch.bfloat16)
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
    say(f"launches in the best-of-{N} run: {launches}")
    cands, tokens = seen["cands"], seen["tokens"]
    check(tuple(cands.shape) == (B0, N, L - 1, 56),
          f"candidate shape {tuple(cands.shape)} == {(B0, N, L - 1, 56)}")
    check(bool(torch.isfinite(cands.float()).all()), "candidates finite")
    check(bool(((tokens >= 0) & (tokens < 512)).all()), "tokens in [0, 512)")
    want = {"decode_attention": (L - 1) * 4 * 2, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "nearest_code": 2}
    check(launches == want, f"generation launches {launches} == {want} (K1 self and "
          "cross in 4 decoder layers x 255 steps, K4 twice, no K2/K3)")
    m = print_metrics(y_true, y_pred, xs, verbose=False)
    fd = [m[k] for k in ("fid_pose", "fid_exp", "mse_pose", "mse_exp")]
    check(all(v == v and abs(v) != float("inf") for v in fd),
          f"FD and MSE finite: fid_pose {m['fid_pose']:.4f} fid_exp {m['fid_exp']:.4f}")
    return model, gen, batches[0], launches


@phase
def slice_reference():
    """fp32 at B0=4, N=2: kernels vs plain versions on the card, and the card's
    VQ codes against the CPU's."""
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import init_decoder_cache

    b0, n = 4, 2
    cpu_model, _ = _model(torch.float32, seed=1)
    cpu_model.eval()
    model = _model(torch.float32, seed=1)[0].to("cuda").eval()
    batch = _clips(b0, seed=5)[0]
    src_v, tgt, src_a, mask = (torch.as_tensor(x) for x in batch[:4])
    with torch.no_grad():
        codes_cpu = cpu_model.forward_vq(src_v, tgt, mask)[1]
        codes_gpu = model.forward_vq(src_v.cuda(), tgt.cuda(), mask.cuda())[1].cpu()
        same = float((codes_cpu == codes_gpu).float().mean())
        check(same >= 0.99, f"listener VQ codes, card (K4) vs CPU (plain): "
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
    check(worst <= 1e-3, f"teacher-forced decode_step fp32 B0={b0} N={n}, {L} steps: "
          f"logits max abs err kernel vs plain {worst:.3g} (tol 1e-3)")
    return worst


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
    versions on the card, from the same weights and noise."""
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
        with plain_attention() if plain else contextlib.nullcontext():
            with torch.no_grad():
                codes.append(model.forward_vq(src_v, tgt, mask))
            out = model(src_v, tgt, src_a, mask, noise=noise)
            out.total_loss.backward()
        logs = {k: float(v) for k, v in out.logs.items()}
        logs["total"] = float(out.total_loss.detach())
        results.append((logs, {k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None}))
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
    return {"loss_rel": max(rel.values()), "grad_rel": core[worst]}


def _attn_bound(rows, l, d, dtype, mask, causal, bwd):
    """Bytes each input is read and each output written once; operations of
    the (query, key) pairs this data attends: 4 D per pair forward (Q Kᵀ,
    P V), 10 D backward (Q Kᵀ, dO Vᵀ, Pᵀ dO, dS K, dSᵀ Q)."""
    es = torch.finfo(dtype).bits // 8
    if causal:
        pairs = rows * l * (l + 1) / 2
    elif mask is not None:
        pairs = (rows // mask.shape[0]) * l * float(mask.sum())
    else:
        pairs = rows * l * l
    extra = rows * l * 4 + (0 if mask is None else mask.numel())
    io = rows * l * d * es
    if bwd:
        return bound_ms(8 * io + extra, 10 * d * pairs, dtype)
    return bound_ms(4 * io + extra, 4 * d * pairs, dtype)


@phase
def train_timings(train):
    from torch.profiler import DeviceType, ProfilerActivity, profile

    import torch.nn.functional as F
    from dyadic_interaction_modeling_tpu_torch.cli.profile_generate import _busy_us
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    step, batch, gen = train["step"], train["batch"], train["gen"]
    windows = {}
    # the same window of PROFILED_STEPS steps traced twice: the card alone
    # (the busy share reported), then also the host's operators
    for tag, acts in (("card", [ProfilerActivity.CUDA]),
                      ("card+host", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(batch, gen)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = _busy_us(kern)
        windows[tag] = {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                        "busy_share": busy / wall_us, "kernels": len(kern)}
        say(f"{PROFILED_STEPS} train steps traced ({tag}): wall {wall_us / 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%), "
            f"{len(kern)} kernels")
    check(windows["card"]["kernels"] > 0, "tracing the card alone records its kernels")
    by_name = {}
    for e in kern:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.end - e.time_range.start, cnt + 1)
    top = [(name, tot / PROFILED_STEPS, cnt / PROFILED_STEPS) for name, (tot, cnt)
           in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    say("device time a step by kernel (card+host window):")
    for name, tot, cnt in top:
        say(f"  {tot / 1e3:9.3f} ms  {cnt:7.1f} x  {name[:100]}")
    del train["model"], train["step"]
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(8)
    bf = torch.bfloat16
    cases = {}
    for name, rows, l, d, masked, causal, per_step in K23_CASES:
        q, k, v, do, mask = _attn_inputs(rows, l, d, bf, g, masked)
        kw = dict(causal=causal, scale=d ** -0.5)
        o, lse = flash_attention_fwd(q, k, v, mask, **kw)
        b = rows // HEADS
        m4 = None if mask is None else mask[:, None, None, :]

        def sdpa_on_stream():
            """SDPA's forward on leaves of its own, made on the current stream,
            and its backward: autograd runs a backward on its forward's stream."""
            q4, k4, v4 = (x.view(b, HEADS, l, d).detach().requires_grad_() for x in (q, k, v))
            fwd_ = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, attn_mask=m4, is_causal=causal, scale=kw["scale"])
            out4 = fwd_()
            return fwd_, lambda: torch.autograd.grad(out4, (q4, k4, v4), do.view_as(out4),
                                                     retain_graph=True)

        sdpa, sdpa_bwd = sdpa_on_stream()
        side = torch.cuda.Stream()  # a second forward, for the captured backward
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _, sdpa_bwd_side = sdpa_on_stream()
        torch.cuda.current_stream().wait_stream(side)
        # ms and library_ms: single launches between events, the method of every
        # other kernel here; graph_ms and library_graph_ms: the card alone
        fwd = dict(
            ms=cuda_ms(lambda i: flash_attention_fwd(q, k, v, mask, **kw), 20),
            plain_ms=cuda_ms(lambda i: flash_attention_fwd_plain(q, k, v, mask, **kw), 10),
            library_ms=cuda_ms(lambda i: sdpa(), 20),
            graph_ms=graph_ms(lambda: flash_attention_fwd(q, k, v, mask, **kw)),
            library_graph_ms=graph_ms(sdpa))
        fwd["bound_ms"], fwd["bound_by"] = _attn_bound(rows, l, d, bf, mask, causal, False)
        bwd = dict(
            ms=cuda_ms(lambda i: flash_attention_bwd(q, k, v, o, do, lse, mask, **kw), 20),
            plain_ms=cuda_ms(lambda i: flash_attention_bwd_plain(q, k, v, o, do, lse, mask,
                                                                 **kw), 10),
            library_ms=cuda_ms(lambda i: sdpa_bwd(), 20),
            graph_ms=graph_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, mask, **kw)),
            library_graph_ms=graph_ms(sdpa_bwd_side, stream=side))
        bwd["bound_ms"], bwd["bound_by"] = _attn_bound(rows, l, d, bf, mask, causal, True)
        cases[name] = {"per_step": per_step, "fwd": fwd, "bwd": bwd}
        for tag, r in (("K2", fwd), ("K3", bwd)):
            say(f"{tag} {name} bf16: kernel {r['ms'] * 1e3:.1f} us, plain "
                f"{r['plain_ms'] * 1e3:.1f} us, SDPA {r['library_ms'] * 1e3:.1f} us, "
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
    # K1 self: the mean launch of a generate is the sweep t = 0..255 (4 input
    # sets, one per decoder layer, so the 196 MB caches do not sit in L2)
    sets = _k1_inputs(3000, 1, bf, g, n_sets=4)
    nbytes = sum(3000 * 64 * 2 * 2 * (t + 1) for t in range(L)) / L + 2 * 3000 * 64 * 2
    ops = sum(4 * 3000 * 64 * (t + 1) for t in range(L)) / L

    def sweep(fn):
        return lambda i: [fn(*sets[(i + t) % 4][:3], t) for t in range(L)]

    ms = cuda_ms(sweep(lambda q, k, v, t: decode_attention(q, k, v, t, scale=0.125)), 7) / L
    pl = cuda_ms(sweep(lambda q, k, v, t: decode_attention_plain(q, k, v, t, scale=0.125)), 3) / L
    lib = cuda_ms(sweep(lambda q, k, v, t: F.scaled_dot_product_attention(
        q[:, None], k[:, None, : t + 1], v[:, None, : t + 1], scale=0.125)), 7) / L
    bms, by = bound_ms(nbytes, ops, bf)
    out["self"] = dict(ms=ms, plain_ms=pl, library_ms=lib, bound_ms=bms, bound_by=by)
    del sets
    # K1 cross: (300, 10, 64) against the full L=256 context, key mask
    sets = _k1_inputs(300, 10, bf, g, masked=True, n_sets=4)
    nbytes = 300 * L * 64 * 2 * 2 + 2 * 300 * 10 * 64 * 2 + 25 * L
    ops = 4 * 300 * 10 * L * 64
    ms = cuda_ms(lambda i: decode_attention(*sets[i % 4][:3], None, sets[i % 4][3],
                                            scale=0.125), 200)
    pl = cuda_ms(lambda i: decode_attention_plain(*sets[i % 4][:3], None, sets[i % 4][3],
                                                  scale=0.125), 50)
    masks4 = [s[3].repeat_interleave(12, 0)[:, None, None, :] for s in sets]
    lib = cuda_ms(lambda i: F.scaled_dot_product_attention(
        sets[i % 4][0][:, None], sets[i % 4][1][:, None], sets[i % 4][2][:, None],
        attn_mask=masks4[i % 4], scale=0.125), 200)
    bms, by = bound_ms(nbytes, ops, bf)
    out["cross"] = dict(ms=ms, plain_ms=pl, library_ms=lib, bound_ms=bms, bound_by=by)
    del sets
    # K4: (6400, 128) latents x (512, 128) codebook, fp32
    z = torch.randn(6400, 128, device="cuda", generator=g)
    e = torch.randn(512, 128, device="cuda", generator=g)
    ms = cuda_ms(lambda i: nearest_code(z, e), 200)
    pl = cuda_ms(lambda i: nearest_code_plain(z, e), 200)
    bms, by = bound_ms(6400 * 128 * 4 + 512 * 128 * 4 + 6400 * 4,
                       2 * 6400 * 512 * 128, torch.float32)
    out["vq"] = dict(ms=ms, plain_ms=pl, library_ms=None, bound_ms=bms, bound_by=by)
    for name, r in out.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        say(f"{name:5s}: kernel {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library {lib}, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return {"generate_ms": med * 1e3, "generate_runs_ms": [t * 1e3 for t in times],
            **out}


def _flash_entry(name, line, which, tt, k23, launches):
    cases = tt["cases"]
    return {"name": name, "route": "cuda", "source": SOURCES[torch.bfloat16],
            "sources_by_dtype": {str(k).replace("torch.", ""): v for k, v in SOURCES.items()},
            "replaces": f"dyadic_interaction_modeling_tpu/ops/pallas/attention.py:{line}",
            "launches": launches[name],
            "launches_by_path": {"generate": 0, f"train_{TRAIN_STEPS}_steps": launches[name]},
            "max_abs_err": k23["bfloat16"]["fwd_abs" if which == "fwd" else "bwd_abs"],
            # launch-weighted means over one training step's 20 launches
            **{key: val / 20 for key, val in tt["per_step"][which].items()},
            "bound_by": max((c[which] for c in cases.values() if c["per_step"]),
                            key=lambda r: r["bound_ms"])["bound_by"],
            "cases": {k: c[which] for k, c in cases.items()}, "max_err": k23}


def kernels_line(gen_launches, train, k4, k1, k23, t, tt, build_s):
    self_, cross = t["self"], t["cross"]
    mean = {key: (self_[key] + cross[key]) / 2
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    tl = train["launches"]
    return {"kernels": [
        {"name": "decode_attention", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/decode_attention.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/decode.py:129",
         "launches": gen_launches["decode_attention"],
         "launches_by_path": {"generate": gen_launches["decode_attention"],
                              f"train_{TRAIN_STEPS}_steps": tl["decode_attention"]},
         "max_abs_err": k1["bfloat16"], **mean, "bound_by": "bytes",
         "cases": {"self (3000,1,64) L=256 t=0..255 bf16": self_,
                   "cross (300,10,64) L=256 masked bf16": cross,
                   "max_abs_err": k1}},
        _flash_entry("flash_attention_fwd", 111, "fwd", tt, k23, tl),
        _flash_entry("flash_attention_bwd", 152, "bwd", tt, k23, tl),
        {"name": "nearest_code", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/vq.py:49",
         "launches": gen_launches["nearest_code"] + tl["nearest_code"],
         "launches_by_path": {"generate": gen_launches["nearest_code"],
                              f"train_{TRAIN_STEPS}_steps": tl["nearest_code"]},
         "max_abs_err": k4["max_abs_err"], **t["vq"], "agree": k4["agree"]},
    ], "generate_ms": t["generate_ms"], "generate_runs_ms": t["generate_runs_ms"],
        "train_step_ms": train["step_ms"], "train_step_runs_ms": train["step_runs_ms"],
        "train_frames_per_s": TRAIN_B * L / train["step_ms"] * 1e3,
        "train_busy_share": tt["busy_share"], "train_traced_windows": tt["windows"],
        "build_s": build_s}


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
    train = train_main_path()
    train_ref = train_reference()
    tt = train_timings(train) if train else None
    if FAILURES or None in (smi, build_s, k4, k1, k23, t, train, train_ref, tt):
        say(f"FAILED: {FAILURES}")
        return 1
    say(json.dumps(kernels_line(gen_launches, train, k4, k1, k23, t, tt, build_s)))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
