"""What the port's card tests share: the ``card`` fixture, launch counts,
the swaps to the kernels' plain versions, and the functions that make the
models and inputs at full width.

A plain module beside the tests (pytest puts ``tests/`` on ``sys.path``), not
collected. It imports no JAX and builds nothing at import: the fixture
decides whether there is a card, and every model, input or extension is
made inside a test. The card tests run on a GPU machine without the repo's
conftest (it imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_*_cuda.py tests/test_torch_token_graph.py \\
        tests/test_torch_deepseek_v2.py

``-k`` selects an area, as everywhere in pytest.
"""

from __future__ import annotations

import contextlib
import gc

import pytest
import torch

L, B0, N, HEADS = 256, 25, 10, 12  # the generate headline's clips, best-of-10
WARMUP_STEPS, TRAIN_STEPS = 3, 10
# the BIWI speaker family: frames a clip, best-of-50, 70,110-d meshes
BIWI_L, BIWI_N, BIWI_VDIM = 120, 50, 70110
BIWI_MOUTH = list(range(BIWI_VDIM // 6))  # half the mesh's vertices, as test_biwi's map
RENDER_RES, RENDER_B, RENDER_T, RENDER_RADIUS = 256, 8, 120, 13
S2S_B = 4  # the ListenerGenerator's clips a batch
SPEECH_SAMPLES = 77200  # 4.825 s at 16 kHz: 241 conv frames, BIWI_L frames after the trim


@pytest.fixture
def card():
    """Skips without a CUDA device. On the card: TF32 off for the test (the
    fp32 checks hold fp32 arithmetic), a seeded generator on the card, and
    afterwards the captured token graphs and cached blocks let go."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    from dyadic_interaction_modeling_tpu_torch.models import xtrans

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield torch.Generator(device="cuda").manual_seed(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        xtrans._GRAPHS.clear()
        gc.collect()
        torch.cuda.empty_cache()


def launches(**counts) -> dict:
    """Every kernel's launch count: ``counts``, 0 for the others."""
    from dyadic_interaction_modeling_tpu_torch.kernels import LAUNCHES

    return {k: counts.get(k, 0) for k in LAUNCHES}


@contextlib.contextmanager
def counted():
    """Every launch count set to 0 on entry; on exit, after a synchronize,
    the dict it yields holds the counts."""
    from dyadic_interaction_modeling_tpu_torch import kernels

    got = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    yield got
    torch.cuda.synchronize()
    got.update(kernels.LAUNCHES)


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
def k4_calls(plain=False):
    """Inside, every K4 launch of the model (``ops.quantizer``'s) is recorded
    as (latents, codebook, codes), so that the codes a path took can be held
    against the plain version on the same latents afterwards; with
    ``plain``, the plain version runs in K4's place on the card."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code_plain
    from dyadic_interaction_modeling_tpu_torch.ops import quantizer

    calls, kernel = [], nearest_code_plain if plain else quantizer._nearest_code

    def record(z, e):
        idx = kernel(z, e)
        calls.append((z.detach().clone(), e.detach().clone(), idx))
        return idx

    with mock.patch.object(quantizer, "_nearest_code", record):
        yield calls


def _dist64(z, e, idx):
    z, e = z.double(), e.double()
    return ((z - e[idx.long()]) ** 2).sum(1)


def assert_k4_on_path(calls):
    """Recorded K4 codes against ``nearest_code_plain`` on the same latents:
    equal, but for rows whose two codes' fp64 distances tie to 1e-5 of
    |z|^2 + |e|^2 (the rounding of two fp32 sums in different orders), and
    at most 0.1% of the rows (the random-input rule of K4's card test)."""
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
    assert calls and worst <= 1e-5 and differ <= rows // 1000, (
        f"K4 on {len(calls)} launches: {differ} of {rows} codes differ from the plain "
        f"version's, largest relative distance gap {worst:.3g} (tol 1e-5)")


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


def grad_errs(gk, gp) -> dict:
    """Each leaf's largest error of ``gk`` against ``gp``, over the largest
    magnitude of ``gp``."""
    return {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-30))
            for k in gp}


def rel_err(lk: dict, lp: dict) -> float:
    """The largest relative error of the losses ``lk`` against ``lp``."""
    return max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp)


def assert_moved(model, before, frozen=None, moving=None):
    """The parameters that take no gradient bitwise as in ``before`` (with
    ``frozen``, at least one, each under those prefixes); with ``moving``,
    every trainable one under those prefixes changed."""
    fixed = [k for k, p in model.named_parameters() if not p.requires_grad]
    if frozen is not None:
        assert fixed and all(k.startswith(frozen) for k in fixed), fixed[:5]
    assert all(torch.equal(model.get_parameter(k), before[k]) for k in fixed)
    if moving is not None:
        still = [k for k, p in model.named_parameters() if p.requires_grad
                 and k.startswith(moving) and torch.equal(p, before[k])]
        assert not still, f"unmoved: {still[:5]}"


def teacher_forced_err(dec, seq, cross, mask, groups=1) -> float:
    """``seq`` (rows, T) teacher-forced through ``dec.decode_step`` with the
    kernels and with their plain versions, each from an empty fp32 cache of
    T: the largest difference of their logits."""
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import init_decoder_cache

    caches = [init_decoder_cache(seq.shape[0], seq.shape[1], dec.depth, dec.heads,
                                 dec.dim_head, torch.float32, dec.kv_heads, "cuda")
              for _ in range(2)]
    worst = 0.0
    with torch.no_grad():
        for t in range(seq.shape[1]):
            tok = seq[:, t: t + 1]
            a = dec.decode_step(tok, caches[0], t, cross, mask, groups)
            with plain_attention():
                b = dec.decode_step(tok, caches[1], t, cross, mask, groups)
            worst = max(worst, float((a - b).abs().max()))
    return worst


# --- models and inputs at full width, seeded ---------------------------------


def slmft(seed=0, kv_heads=0):
    """SLMFT at ``slm_defaults()`` + ``vq_listener_defaults()``, fp32 on the
    CPU; ``kv_heads`` = 1 is grouped-query (MQA) attention."""
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT

    cfg = slm_defaults()
    cfg["attn_kv_heads"] = kv_heads
    torch.manual_seed(seed)
    return SLMFT(cfg, vq_listener_defaults())


def clips(n_clips, seed=3):
    """Synthetic ViCo clips of L frames, as numpy batches of n_clips
    (src_v, tgt, src_a, mask, names)."""
    from dyadic_interaction_modeling_tpu_torch.data.loader import (
        PaddedBatchLoader, slm_batch_from_collated)
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset

    ds = synthetic_vico_dataset(n_clips=n_clips, min_len=L, max_len=L, seed=seed)
    return [slm_batch_from_collated(c) + (c[5],)
            for c in PaddedBatchLoader(ds, n_clips, shuffle=False)]


def candor(n_clips, seed):
    """n_clips synthetic CANDOR clips of L frames (moving speakers), as one
    batch on the card: (speaker motion, listener motion, audio, mask)."""
    from dyadic_interaction_modeling_tpu_torch.data.loader import (
        PaddedBatchLoader, slm_batch_from_collated)
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_candor_dataset

    ds = synthetic_candor_dataset(n_clips=n_clips, min_len=L, max_len=L, seed=seed)
    collated = next(iter(PaddedBatchLoader(ds, n_clips, shuffle=False)))
    return tuple(torch.as_tensor(x, device="cuda") for x in slm_batch_from_collated(collated))


def speaker_model(seed):
    """SpeakerSLMFT at full width (slm_defaults + vq_listener_defaults, 70110-d
    BIWI meshes, 15 speakers), fp32, seeded random weights."""
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SpeakerSLMFT

    torch.manual_seed(seed)
    return SpeakerSLMFT(slm_defaults(), vq_listener_defaults(), vertice_dim=BIWI_VDIM,
                        n_speakers=15)


def biwi_batch(n_clips, seed):
    """n_clips synthetic BIWI clips of BIWI_L frames (about 4.8 s at BIWI's 25
    fps) as one batch on the card: (vertices, EMOCA, audio features, mask,
    template, speaker ids)."""
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import (
        synthetic_biwi_dataset, synthetic_vico_dataset)
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import speaker_ids_from_names

    items, _ = synthetic_biwi_dataset(n_clips=n_clips, length=BIWI_L,
                                      n_vertices=BIWI_VDIM // 3, seed=seed)
    emoca = synthetic_vico_dataset(n_clips=n_clips, min_len=BIWI_L, max_len=BIWI_L, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def stack(xs):
        return torch.stack([torch.as_tensor(x) for x in xs]).to("cuda")

    return (stack([it["vertice"] for it in items]), stack([emoca[i][1] for i in range(n_clips)]),
            torch.randn(n_clips, BIWI_L, 768, device="cuda", generator=g),
            torch.ones(n_clips, BIWI_L, dtype=torch.bool, device="cuda"),
            stack([it["template"] for it in items]),
            speaker_ids_from_names([it["name"] for it in items], "cuda"))


def lg_model(seed, with_ids=True):
    """ListenerGenerator at full width (listener_generator_defaults: dim 512,
    6 + 6 layers, 8 heads of 64, 512 codes, enc_max_seq_len 1024; both VQs
    vq_listener_defaults), fp32, seeded random weights."""
    from dyadic_interaction_modeling_tpu_torch.config import (
        lg_vq_cfg, listener_generator_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.listener_generator import (
        ListenerGenerator)

    cfg = listener_generator_defaults()
    vq = lg_vq_cfg(cfg)
    torch.manual_seed(seed)
    return ListenerGenerator(cfg, vq, vq, with_ids=with_ids)


def lg_batch(seed, lens=None, moving_speaker=False):
    """S2S_B clips of L frames as (src_v, tgt, mask, speaker ids, listener
    ids) on the card: synthetic ViCo clips (their speaker motion constant,
    as ViCo's reader makes it) with their ids, or with ``moving_speaker``
    CANDOR-shaped ones with ids 0-3 (under a constant speaker the speaker
    encoders' query and key gradients cancel to ~1e-6 of their value
    gradients, too little to hold two runs' rounding against); ``lens``
    gives the key mask."""
    if moving_speaker:
        src_v, tgt, _, mask = candor(S2S_B, seed)
        ids = torch.arange(S2S_B, device="cuda")
        sp, li = ids, ids.flip(0)
    else:
        src_v, tgt, _, mask, _ = clips(S2S_B, seed)[0]
        src_v, tgt, mask = (torch.as_tensor(x, device="cuda") for x in (src_v, tgt, mask))
        n = torch.arange(S2S_B, device="cuda")
        sp, li = n % 7, n % 5  # the synthetic set's ids
    if lens is not None:
        mask = torch.arange(L, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    return src_v, tgt, mask, sp, li


def lg_training():
    """``lg_model(0)`` on the card, its training step (AdamW 1e-5, weight
    decay 0.01, no clip, ``LG_FROZEN``) and ``lg_batch(41)``: (model, step,
    batch)."""
    from dyadic_interaction_modeling_tpu_torch.engine.s2s_engine import make_lg_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.listener_generator import LG_FROZEN

    model = lg_model(seed=0).to("cuda")
    step = make_lg_train_step(model, make_optimizer(model, 1e-5, 0.01, LG_FROZEN), 0.0,
                              use_ids=True)
    return model, step, lg_batch(seed=41)


def speech_audio(n, seed):
    """n waveforms of SPEECH_SAMPLES, on the CPU."""
    return torch.randn(n, SPEECH_SAMPLES, generator=torch.Generator().manual_seed(seed))


def codetalker(seed):
    """CodeTalker at full width (codetalker_defaults: feature_dim 1024, 6
    decoder layers of 4 heads; the vertex VQ at 70110-d: hidden 384, 6 + 6
    layers, 512 x 128 codes; the wav2vec2-base trunk), fp32, seeded."""
    from dyadic_interaction_modeling_tpu_torch.config import codetalker_defaults
    from dyadic_interaction_modeling_tpu_torch.models.codetalker import CodeTalker

    torch.manual_seed(seed)
    return CodeTalker(codetalker_defaults())


def ct_batch(seed):
    """One BIWI clip on the card: (1, SPEECH_SAMPLES) audio, (1, 70110)
    template, (1, BIWI_L, 70110) vertices, (1, 6) one-hot."""
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_biwi_dataset

    item = synthetic_biwi_dataset(n_clips=1, length=BIWI_L, n_vertices=BIWI_VDIM // 3,
                                  seed=seed)[0][0]
    one_hot = torch.zeros(1, 6)
    one_hot[0, seed % 6] = 1
    return tuple(torch.as_tensor(x).to("cuda") for x in (
        speech_audio(1, seed), item["template"][None], item["vertice"][None], one_hot))


def codetalker_training():
    """``codetalker(0)`` on the card in training mode and its
    ``train_stage2`` step (Adam 1e-4, ``CODETALKER_FROZEN``) on
    ``ct_batch(41)``: (model, step, batch)."""
    from dyadic_interaction_modeling_tpu_torch.cli.train_stage2 import make_stage2_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.codetalker import CODETALKER_FROZEN

    model = codetalker(seed=0).to("cuda").train()
    step = make_stage2_step(model, make_optimizer(model, 1e-4, 0.0, CODETALKER_FROZEN))
    return model, step, ct_batch(seed=41)


def render_weights():
    """PIRender's FaceGenerator at full width (``RENDER_DEFAULTS``, 56-d EMOCA
    coefficients into the 73-d ``pre`` conv), seeded, as a state_dict."""
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator

    torch.manual_seed(61)
    return {k: v.clone() for k, v in FaceGenerator(flame_coeff_nc=56, coeff_nc=73)
            .state_dict().items()}


def render_inputs():
    """A smooth RENDER_RES x RENDER_RES source (uint8, so a PNG of it is the
    same image) and RENDER_T EMOCA-shaped frames (pose 6 + exp 50), seeded."""
    import numpy as np

    g = torch.Generator().manual_seed(62)
    low = torch.rand(1, 3, 16, 16, generator=g) * 2 - 1
    src = torch.nn.functional.interpolate(low, size=(RENDER_RES, RENDER_RES), mode="bilinear",
                                          align_corners=False)
    src8 = ((src[0].permute(1, 2, 0).clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8).numpy()
    rng = np.random.default_rng(63)
    coeffs = np.concatenate([rng.normal(0, 0.1, (RENDER_T, 6)),
                             rng.normal(0, 0.3, (RENDER_T, 50))], axis=1).astype(np.float32)
    return src8, coeffs
