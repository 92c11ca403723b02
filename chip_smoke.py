#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: build the CUDA kernels, hold each
against its plain PyTorch version, drive SLMFT best-of-10 listener generation
at full width, and time it all.

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
5. the slice at full width (``slm_defaults()`` + ``vq_listener_defaults()``,
   random init from a seed, bf16): 25 synthetic clips of L=256, best-of-10
   through ``make_slmft_generator`` and ``evaluate_test_epoch`` with every
   launch count set to 0 just before and read just after; then in fp32 at
   B0=4, N=2 one token sequence teacher-forced through ``decode_step`` with
   the kernels and with the plain versions (logits within 1e-3), and the VQ
   codes on the card against the same model on the CPU;
6. times from CUDA events after warmup: the median of 3 best-of-10 generate
   calls, the median per-launch time of each kernel at the main path's shapes
   (for K1 self, the median over sweeps t = 0..255 of a sweep's mean launch),
   its plain version's, and one PyTorch library call on the same inputs where
   there is one (yardstick only, never on the port's path); then the
   ``kernels`` JSON line and, last, the device JSON line.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on tensor cores, 67 TFLOP/s fp32 on CUDA cores.
"""

from __future__ import annotations

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


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    check(all(v > 0 for v in launches.values()),
          "every kernel launched on the main path")
    m = print_metrics(y_true, y_pred, xs, verbose=False)
    fd = [m[k] for k in ("fid_pose", "fid_exp", "mse_pose", "mse_exp")]
    check(all(v == v and abs(v) != float("inf") for v in fd),
          f"FD and MSE finite: fid_pose {m['fid_pose']:.4f} fid_exp {m['fid_exp']:.4f}")
    return model, gen, batches[0], launches


@phase
def slice_reference():
    """fp32 at B0=4, N=2: kernels vs plain versions on the card, and the card's
    VQ codes against the CPU's."""
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention_plain
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
            b = dec.decode_step(tok, caches[1], t, cross, maskc, n,
                                attend=decode_attention_plain)
            worst = max(worst, float((a - b).abs().max()))
    check(worst <= 1e-3, f"teacher-forced decode_step fp32 B0={b0} N={n}, {L} steps: "
          f"logits max abs err kernel vs plain {worst:.3g} (tol 1e-3)")
    return worst


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


def kernels_line(launches, k4, k1, t, build_s):
    self_, cross = t["self"], t["cross"]
    mean = {key: (self_[key] + cross[key]) / 2
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return {"kernels": [
        {"name": "decode_attention", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/decode_attention.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/decode.py:129",
         "launches": launches["decode_attention"], "max_abs_err": k1["bfloat16"],
         **mean, "bound_by": "bytes",
         "cases": {"self (3000,1,64) L=256 t=0..255 bf16": self_,
                   "cross (300,10,64) L=256 masked bf16": cross,
                   "max_abs_err": k1}},
        {"name": "nearest_code", "route": "cuda",
         "source": "dyadic_interaction_modeling_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "dyadic_interaction_modeling_tpu/ops/pallas/vq.py:49",
         "launches": launches["nearest_code"], "max_abs_err": k4["max_abs_err"],
         **t["vq"], "agree": k4["agree"]},
    ], "generate_ms": t["generate_ms"], "generate_runs_ms": t["generate_runs_ms"],
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
    main_run = slice_main_path()
    slice_reference()
    t = timings(main_run) if main_run else None
    if FAILURES or None in (smi, build_s, k4, k1, t):
        say(f"FAILED: {FAILURES}")
        return 1
    say(json.dumps(kernels_line(main_run[3], k4, k1, t, build_s)))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
