"""Training steps on the card at full width: the SLM pretraining step, the
listener and speaker VQ-VAEs', the SLMFT finetune, the SpeakerSLMFT finetune,
the EMOCA converter's, the ListenerGenerator's and CodeTalker's. Each step's
kernel launches are counted, its frozen tensors held bitwise and its
trainable ones seen to move; then one fp32 step with the kernels is held
against the same step with their plain versions, and where fp32 rounding
alone moves a leaf, against the plain versions in fp64.

Marked ``cuda`` (skipped where no card is present). On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from torch_card import (BIWI_L, BIWI_MOUTH, BIWI_VDIM, L, TRAIN_STEPS, WARMUP_STEPS,
                        assert_k4_on_path, assert_moved, biwi_batch, candor, card,  # noqa: F401
                        clips, codetalker, codetalker_training, counted, fp64_where_fp32,
                        grad_errs, k4_calls, launches, lg_batch, lg_model, lg_training,
                        plain_attention, rel_err, slmft, speaker_model)

pytestmark = pytest.mark.cuda

VQ_L, FT_B = 1024, 4


def _slm(seed):
    from dyadic_interaction_modeling_tpu_torch.config import (
        slm_defaults, vq_listener_defaults)
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM

    torch.manual_seed(seed)
    return SLM(slm_defaults(), vq_listener_defaults())


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


def _spk_model(seed):
    from dyadic_interaction_modeling_tpu_torch.config import vq_speaker_defaults
    from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQSpeakerAutoEncoder

    torch.manual_seed(seed)
    return VQSpeakerAutoEncoder(vq_speaker_defaults())


def _spk_clip(seed):
    """One synthetic audio-visual clip of VQ_L frames, listener motion ||
    audio (824 features), as ``train_vq``'s synthetic AV stream makes it."""
    from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_vico_dataset

    combined, listener = synthetic_vico_dataset(n_clips=1, min_len=VQ_L, max_len=VQ_L,
                                                seed=seed)[0][:2]
    clip = torch.cat([torch.as_tensor(listener), torch.as_tensor(combined[:, 56:])], dim=1)
    return clip[None].to("cuda")


def _finetune_batch(lens, seed, moving_speaker=False):
    """FT_B synthetic clips of L frames, as one batch on the card, with the
    key mask of ``lens``: ViCo-shaped (whose speaker motion is constant, as
    the synthetic ViCo set makes it), or with ``moving_speaker`` the same
    layout with smooth speaker motion (the synthetic CANDOR set). Under a
    constant speaker the speaker encoders' query and key gradients cancel to
    ~1e-6 of their value gradients, too little to hold two runs' rounding
    against, so the kernel-vs-plain comparison takes moving speakers."""
    batch = candor(FT_B, seed) if moving_speaker else (
        torch.as_tensor(x, device="cuda") for x in clips(FT_B, seed)[0][:4])
    src_v, tgt, src_a, _ = batch
    mask = torch.arange(L, device="cuda")[None, :] < torch.tensor(lens, device="cuda")[:, None]
    return src_v, tgt, src_a, mask


# --- each step: (model, step, its arguments, launches a step, frozen
# prefixes, prefixes of the tensors that must move; None: not checked)


def _slm_step():
    """SLM pretraining, fp32 parameters under bf16 autocast, AdamW (1e-5,
    weight decay 0.01), clip 1.0, the VQ encoders and quantizers frozen, 32
    synthetic CANDOR clips of L (``bench.py:54``)."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM_FROZEN

    model = _slm(seed=0).to("cuda")
    step = make_slm_train_step(model, make_optimizer(model, 1e-5, 0.01, SLM_FROZEN), 1.0,
                               torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    return (model, step, (candor(32, seed=7), g),
            dict(flash_attention_fwd=20, flash_attention_bwd=20, nearest_code=2),
            SLM_FROZEN, ("encoder_", "decoder_joint"))


def _vq_step():
    """The listener VQ-VAE (hidden 384, 6 + 6 layers, 8 heads of 48, 512 x
    128 codes), fp32, one clip of 1024 frames, AdamW (1e-4, weight decay
    0.01): every parameter moves."""
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.engine.vq_engine import make_vq_train_step

    model = _vq_model(seed=0).to("cuda")
    step = make_vq_train_step(model, make_optimizer(model, 1e-4, 0.01))
    return (model, step, (_vq_clip(seed=11),),
            dict(flash_attention_fwd=12, flash_attention_bwd=12, nearest_code=1), None, "")


def _finetune_step():
    """The SLMFT finetune, fp32 parameters under bf16 autocast, FT_B ViCo
    clips of L, AdamW (1e-5, weight decay 0.01), clip 1.0, both VQs frozen:
    K2/K3 in the decoder's causal self-attention under the 15% corruption
    key mask."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT_FROZEN

    model = slmft(seed=0).to("cuda")
    step = make_slm_train_step(model, make_optimizer(model, 1e-5, 0.01, SLMFT_FROZEN), 1.0,
                               torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    return (model, step, (_finetune_batch([L] * FT_B, seed=13), g),
            dict(flash_attention_fwd=4, flash_attention_bwd=4, nearest_code=2),
            SLMFT_FROZEN, ("encoder_", "decoder_joint"))


def _speaker_vq_step():
    """The audio-visual speaker VQ-VAE (hidden 768, 6 + 6 + 6 layers, 8
    heads of 96, 8 codes a frame), fp32, one clip of 1024 frames, AdamW
    (1e-4, weight decay 0.01), the split AV loss: K2/K3 once in each of the
    18 attention layers, K4 once at 8 x 1024 latents."""
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.engine.vq_engine import make_vq_train_step

    model = _spk_model(seed=0).to("cuda")
    step = make_vq_train_step(model, make_optimizer(model, 1e-4, 0.01), audio_visual=True)
    return (model, step, (_spk_clip(seed=21),),
            dict(flash_attention_fwd=18, flash_attention_bwd=18, nearest_code=1), None, "")


def _speaker_finetune_step():
    """SpeakerSLMFT, fp32, AdamW (1e-5, weight decay 0.01), clip 1.0,
    ``SPEAKER_SLMFT_FROZEN``, 4 BIWI clips of BIWI_L with the mouth MSE
    logged: K2/K3 at (48, 119, 64) causal."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_speaker_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SPEAKER_SLMFT_FROZEN

    model = speaker_model(seed=0).to("cuda")
    step = make_speaker_train_step(
        model, make_optimizer(model, 1e-5, 0.01, SPEAKER_SLMFT_FROZEN), 1.0)
    return (model, step, (biwi_batch(4, seed=23), BIWI_MOUTH),
            dict(flash_attention_fwd=4, flash_attention_bwd=4, nearest_code=2),
            SPEAKER_SLMFT_FROZEN, ("decoder_joint", "speaker_vq.decoder.decoder_transformer"))


def _converter_step():
    """``cli/train_converter``'s step, 70110-d meshes, one clip of BIWI_L, a
    mouth map: K4 once (the frozen speaker VQ's encode; its attention at L =
    120 takes the matmul route)."""
    from dyadic_interaction_modeling_tpu_torch.cli import train_converter as tc
    from dyadic_interaction_modeling_tpu_torch.config import vq_listener_defaults
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import CONVERTER_FROZEN, EmocaConverter

    torch.manual_seed(0)
    model = EmocaConverter(vq_listener_defaults(), BIWI_VDIM).to("cuda")
    step = tc.make_converter_step(model, make_optimizer(model, 1e-5, 0.01, CONVERTER_FROZEN),
                                  0.0, BIWI_MOUTH, 5.0)
    args = tuple(torch.as_tensor(x, device="cuda")
                 for x in tc.synthetic_batches(BIWI_VDIM, BIWI_L, n_clips=1)[0])
    return model, step, args, dict(nearest_code=1), None, None


def _s2s_step():
    """The ListenerGenerator, fp32 (the JAX CLI's dtype), S2S_B ViCo clips of
    L with ids, AdamW (1e-5, weight decay 0.01, no clip), ``LG_FROZEN``: K2/K3
    in the 6 encoder layers at (32, 257, 64) with the key mask and the 6
    causal decoder layers at (32, 256, 64), K4 for the two VQ encodes."""
    from dyadic_interaction_modeling_tpu_torch.models.listener_generator import LG_FROZEN

    model, step, batch = lg_training()
    return (model, step, (batch,),
            dict(flash_attention_fwd=12, flash_attention_bwd=12, nearest_code=2),
            LG_FROZEN, "generator.")


STEPS = {"slm": _slm_step, "vq": _vq_step, "finetune": _finetune_step,
         "speaker_vq": _speaker_vq_step, "speaker_finetune": _speaker_finetune_step,
         "converter": _converter_step, "s2s": _s2s_step}


@pytest.mark.parametrize("name", list(STEPS))
def test_a_training_step_launches_its_kernels_and_moves_its_weights(card, record_property,
                                                                     name):
    """WARMUP_STEPS steps, then TRAIN_STEPS with every launch count set to 0
    just before and read just after; finite metrics over all of them."""
    model, step, args, per_step, frozen, moving = STEPS[name]()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    logs = [step(*args) for _ in range(WARMUP_STEPS)]
    with counted() as got:
        logs += [step(*args) for _ in range(TRAIN_STEPS)]
    assert got == launches(**{k: v * TRAIN_STEPS for k, v in per_step.items()})
    record_property("launches", got)
    values = [v for lg in logs for v in (lg.values() if isinstance(lg, dict) else [lg])]
    assert all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in values)
    assert_moved(model, before, frozen, moving)


def test_slm_step_matches_plain(card):
    """One fp32 SLM step at B = 4 with ragged lengths (128-256) with the
    kernels and with their plain versions on the card, from the same weights
    and noise: equal VQ codes, losses within 1e-5 relative, gradients of the
    non-VQ leaves within 1e-3 of each leaf's largest magnitude; K4's codes
    against the plain version on the latents it was given."""
    b = 4
    src_v, tgt, src_a, _ = candor(b, seed=9)
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
            assert_k4_on_path(calls)
    assert all(torch.equal(a, b) for a, b in zip(*codes))
    (lk, gk), (lp, gp) = results
    assert rel_err(lk, lp) <= 1e-5, (lk, lp)
    errs = grad_errs(gk, gp)
    core = {k: e for k, e in errs.items() if "_vq." not in k}
    worst = max(core, key=core.get)
    assert core[worst] <= 1e-3, (worst, core[worst])


def test_vq_step_matches_plain(card):
    """One fp32 VQ step's forward and backward with the kernels and with
    their plain versions, from the same weights on the same clip: equal
    codes, losses within 1e-5 relative, gradients within 1e-3 of each
    leaf's largest magnitude. K4 runs in both (``plain_attention`` swaps the
    attention only), so its codes are held against ``nearest_code_plain`` on
    the latents it was given."""
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
            assert_k4_on_path(calls)
    (lk, ck, gk), (lp, cp, gp) = results
    assert torch.equal(ck, cp)
    assert rel_err(lk, lp) <= 1e-5, (lk, lp)
    errs = grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def _grads_of(run, dtype, plain):
    """``run()`` with the kernels or with their plain versions (``plain``),
    in fp32 or, for a model cast to fp64, with ``fp64_where_fp32``."""
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(plain_attention())
        if dtype == torch.float64:
            stack.enter_context(fp64_where_fp32())
        return run()


def _fp64_bad(gk, gp, g64, leaves=None):
    """The leaves where the kernels' error against fp64 is past both 1e-3 and
    4x the plain fp32 run's."""
    ek, ep = grad_errs(gk, g64), grad_errs(gp, g64)
    return [k for k in (leaves or g64) if ek[k] > max(1e-3, 4 * ep[k])]


def test_finetune_step_matches_plain(card):
    """One fp32 finetune step at FT_B clips of ragged lengths (128-256) with
    moving speakers, with the kernels and with the plain versions, from the
    same weights and corruption noise: equal codes, losses within 1e-5
    relative, gradients within 1e-3 of each leaf's largest magnitude; K4's
    codes against the plain version on the latents it was given."""
    batch = _finetune_batch([L, 211, 170, 128], seed=14, moving_speaker=True)
    state = slmft(seed=1).state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = torch.randn(FT_B, L - 1, device="cuda", generator=g)
    results, codes = [], []
    for plain in (False, True):
        model = slmft(seed=1)
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
            assert_k4_on_path(calls)
    assert all(torch.equal(a, b) for a, b in zip(*codes))
    (lk, gk), (lp, gp) = results
    assert rel_err(lk, lp) <= 1e-5, (lk, lp)
    errs = grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_finetune_step_against_fp64(card):
    """The ViCo-shaped clips (a constant speaker) at ragged lengths
    (128-256): there the speaker encoder's query and key gradients cancel,
    so that fp32 rounding alone moves them by percents of their largest
    magnitude. Both fp32 runs, with the kernels and with the plain versions,
    are held against the plain versions in fp64 (the first run's VQ codes
    standing in all three): on every leaf the kernels' error, relative to
    the fp64 leaf's largest magnitude, within 1e-3 or within 4x the plain
    fp32 run's."""
    batch = _finetune_batch([L, 211, 170, 128], seed=14)
    state = slmft(seed=1).state_dict()
    g = torch.Generator(device="cuda").manual_seed(3)
    noise = torch.randn(FT_B, L - 1, device="cuda", generator=g)
    runs, codes = [], None
    for plain, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.float64)):
        model = slmft(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda", dtype)
        if codes is None:
            with torch.no_grad():
                codes = model.forward_vq(batch[0], batch[1], batch[3])
        model.forward_vq = lambda *args: codes
        inputs = [x.to(dtype) if x.is_floating_point() else x for x in batch]

        def run():
            model(*inputs, noise=noise).total_loss.backward()
            return {k: p.grad.double() for k, p in model.named_parameters()
                    if p.grad is not None}

        runs.append(_grads_of(run, dtype, plain))
        del model
    bad = _fp64_bad(*runs)
    assert not bad, bad[:5]


def test_speaker_vq_step_matches_plain_and_fp64(card):
    """The speaker VQ's step on one AV clip of VQ_L frames, three times from
    the same weights: fp32 with the kernels, fp32 with the plain versions,
    and the plain versions in fp64 (the first run's codes stand in K4's
    place, which takes fp32 only). Between the fp32 runs: codes equal,
    metrics within 1e-5 relative. Gradients: on the leaves where the plain
    fp32 run is within 1e-4 of fp64, the kernels within 1e-3 of the plain
    fp32 run; on every leaf, the kernels' error against fp64 within 1e-3 or
    within 4x the plain fp32 run's. Some leaves lose digits to cancellation
    in fp32 whatever computes the attention (the sums over the frames that
    share a code, the instance norms of the conv blocks): there only fp64
    tells which fp32 run is right. K4's codes are held against
    ``nearest_code_plain`` on the latents it was given."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.metrics.loss import calc_vq_loss_AV
    from dyadic_interaction_modeling_tpu_torch.ops import quantizer

    clip = _spk_clip(seed=22)
    state = _spk_model(seed=1).state_dict()
    runs, codes = [], None
    for plain, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.float64)):
        model = _spk_model(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda", dtype)
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(plain_attention() if plain else k4_calls())
            if dtype == torch.float64:
                stack.enter_context(fp64_where_fp32())
                stack.enter_context(mock.patch.object(quantizer, "_nearest_code",
                                                      lambda z, e: codes))
            dec, emb_loss, enc = model(clip.to(dtype))
            total, (rec, quant) = calc_vq_loss_AV(dec, clip.to(dtype), emb_loss)
            total.backward()
        if not plain:
            assert_k4_on_path(calls)
            codes = enc.indices.reshape(-1)
        runs.append(({"loss": float(total.detach()), "rec_loss": float(rec),
                      "quant_loss": float(quant), "perplexity": float(enc.perplexity)},
                     enc.indices, {k: p.grad.double() for k, p in model.named_parameters()
                                   if p.grad is not None}))
        del model
    (lk, ck, gk), (lp, cp, gp), (_, _, g64) = runs
    assert torch.equal(ck, cp)
    assert rel_err(lk, lp) <= 1e-5, (lk, lp)
    ep, ekp = grad_errs(gp, g64), grad_errs(gk, gp)
    sound = [k for k in g64 if ep[k] <= 1e-4]
    worst = max(sound, key=ekp.get)
    assert ekp[worst] <= 1e-3, (worst, ekp[worst])
    bad = _fp64_bad(gk, gp, g64)
    assert not bad, bad[:5]


def test_speaker_finetune_step_matches_plain(card):
    """One SpeakerSLMFT loss (4 BIWI clips, the mouth MSE) from seeded
    weights and the same target codes, with the kernels and with their
    plain versions: equal codes (K4's held against the plain version on its
    latents), loss within 1e-5 relative, gradients of the trainable leaves
    within 1e-3 of each leaf's largest magnitude; a leaf past that is held
    against the plain versions in fp64 (the kernels' error within 1e-3 or
    4x the plain fp32 run's)."""
    from dyadic_interaction_modeling_tpu_torch.models.slm import SPEAKER_SLMFT_FROZEN

    state = {k: v.detach().clone() for k, v in speaker_model(seed=0).state_dict().items()}
    batch = biwi_batch(4, seed=23)
    codes = []
    for plain in (False, True):
        m = speaker_model(seed=0)
        m.load_state_dict(state)
        m = m.to("cuda")
        with plain_attention() if plain else k4_calls() as calls, torch.no_grad():
            codes.append(m._codes(batch[0], batch[1], batch[3], batch[4]))
        if not plain:
            assert_k4_on_path(calls)
        del m
    assert torch.equal(*codes)

    def grads(plain, dtype):
        model = speaker_model(seed=0)
        model.load_state_dict(state)
        model = model.to("cuda", dtype)
        for k, p in model.named_parameters():
            p.requires_grad_(not k.startswith(SPEAKER_SLMFT_FROZEN))
        model._codes = lambda *args: codes[0]
        inputs = [x.to(dtype) if x.is_floating_point() else x for x in batch]

        def run():
            out = model(*inputs, mouth_map=BIWI_MOUTH)
            out.total_loss.backward()
            logs = {k: float(out.logs[k].detach()) for k in ("l_ce_l", "l_cont_l")}
            logs["total"] = float(out.total_loss.detach())
            return logs, {k: p.grad.double() for k, p in model.named_parameters()
                          if p.grad is not None}

        return _grads_of(run, dtype, plain)

    (lk, gk), (lp, gp) = grads(False, torch.float32), grads(True, torch.float32)
    assert rel_err(lk, lp) <= 1e-5, (lk, lp)
    errs = grad_errs(gk, gp)
    hard = [k for k in errs if errs[k] > 1e-3]
    if hard:
        bad = _fp64_bad(gk, gp, grads(True, torch.float64)[1], hard)
        assert not bad, bad[:5]


def test_s2s_step_matches_plain_and_fp64(card):
    """One step of the ListenerGenerator loss at S2S_B clips of ragged
    lengths (128-256) with ids, three times from the same weights: fp32 with
    the kernels, fp32 with the plain versions, and the plain versions in
    fp64 (the first run's VQ features and codes in place of the frozen VQs'
    encodes, as K4 takes fp32 only). Between the fp32 runs: equal VQ
    features and codes, losses within 1e-5 relative. Gradients, relative to
    each leaf's largest magnitude: on the non-VQ leaves the kernels within
    1e-3 of the plain fp32 run; on every leaf the kernels' error against
    fp64 within 1e-3 or within 4x the plain fp32 run's. The random speaker
    VQ gives most frames the same few codes, so the encoder's rows hardly
    differ and its query and key gradients are small differences of large
    sums: the test of a backward's rounding (``csrc/flash_attention.cu`` on
    its delta). K4's codes are held against the plain version on the
    latents it was given."""
    batch = lg_batch(seed=42, lens=[L, 211, 170, 128], moving_speaker=True)
    state = lg_model(seed=1).state_dict()
    runs, streams = [], None
    for plain, dtype in ((False, torch.float32), (True, torch.float32), (True, torch.float64)):
        model = lg_model(seed=1)
        model.load_state_dict(state)
        model = model.to("cuda", dtype)
        src_v, tgt = (x.to(dtype) for x in batch[:2])
        with contextlib.ExitStack() as stack:
            calls = stack.enter_context(plain_attention() if plain else k4_calls())
            if dtype == torch.float64:
                stack.enter_context(fp64_where_fp32())
                x_sp, z_li = streams
                model._encode_streams = lambda *args: (x_sp.to(dtype), z_li)
            own = model._encode_streams(src_v, tgt, batch[2])
            streams = streams or own
            out = model(src_v, tgt, *batch[2:])
            out.loss.backward()
        if not plain:
            assert_k4_on_path(calls)
        runs.append((float(out.loss.detach()), own, {k: p.grad.double() for k, p in
                                                     model.named_parameters()
                                                     if p.grad is not None}))
        del model
    (lk, sk, gk), (lp, sp, gp), (_, _, g64) = runs
    assert all(torch.equal(a, b) for a, b in zip(sk, sp))
    assert abs(lk - lp) / max(abs(lp), 1e-12) <= 1e-5, (lk, lp)
    ekp = grad_errs(gk, gp)
    core = [k for k in g64 if "_vq." not in k]
    worst = max(core, key=ekp.get)
    assert ekp[worst] <= 1e-3, (worst, ekp[worst])
    bad = _fp64_bad(gk, gp, g64)
    assert not bad, bad[:5]


def _key_bias(name, n):
    """The slice of a key bias in the tensor ``name`` of length ``n`` (None
    if it holds none): its gradient is zero but for rounding, since it
    shifts every score of a row alike."""
    if name.endswith("k_proj.bias"):
        return slice(0, n)
    if name.endswith("in_proj_bias"):
        return slice(n // 3, 2 * n // 3)
    return None


def _without_key_bias(name, x):
    kb = _key_bias(name, len(x))
    return x if kb is None else torch.cat([x[: kb.start], x[kb.stop:]])


def test_codetalker_step(card):
    """CodeTalker's training step at full width, fp32, B = 1, L = BIWI_L,
    Adam 1e-4 (``train_stage2``'s step and frozen parts): WARMUP_STEPS, then
    TRAIN_STEPS each with its launches counted (K4 2: the ground truth's
    encode and the prediction's quantize; no K1/K2/K3), finite losses,
    frozen parameters bitwise unchanged and every trainable one the loss
    reaches moved (their key biases left out). Then, from the trained
    weights (``feat_map`` moved from its zero init), one loss with K4 and one
    with its plain version: equal codes, losses within 1e-5 relative,
    gradients within 1e-3 of each leaf's largest magnitude, and K4 on that
    step's latents."""
    from dyadic_interaction_modeling_tpu_torch.models.codetalker import CODETALKER_FROZEN

    model, step, batch = codetalker_training()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    logs = [step(*batch) for _ in range(WARMUP_STEPS)]
    for _ in range(TRAIN_STEPS):
        with counted() as got:
            logs.append(step(*batch))
        assert got == launches(nearest_code=2)
    assert all(bool(torch.isfinite(v).all()) for lg in logs for v in lg.values())
    assert_moved(model, before, CODETALKER_FROZEN)
    reached = [k for k, p in model.named_parameters() if p.grad is not None]
    still = []
    for k in reached:
        p, b = (_without_key_bias(k, x) for x in (model.get_parameter(k).detach(), before[k]))
        if p.numel() and torch.equal(p, b):
            still.append(k)
    assert len(reached) > 100 and not still, still[:5]
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, step

    def grads(plain):
        """One loss from ``state`` with K4 or its plain version: (losses,
        the trainable leaves' gradients without their key biases, K4's
        calls)."""
        model = codetalker(seed=0)
        model.load_state_dict(state)
        model = model.to("cuda")
        for k, p in model.named_parameters():
            p.requires_grad_(not k.startswith(CODETALKER_FROZEN))
        with k4_calls(plain=plain) as calls:
            total, (motion, reg) = model(*batch)
            total.backward()
        gs = {}
        for k, p in model.named_parameters():
            kb = _key_bias(k, len(p))
            if p.grad is not None and (kb is None or kb.start > 0):
                gs[k] = _without_key_bias(k, p.grad).double()
        logs = {k: float(v.detach()) for k, v in (("loss", total), ("motion", motion),
                                                   ("reg", reg))}
        return logs, gs, calls

    (lk, gk, ck), (lp, gp, cp) = grads(False), grads(True)
    assert len(ck) == len(cp) == 2 and all(torch.equal(a[2], b[2]) for a, b in zip(ck, cp))
    assert_k4_on_path(ck)
    assert rel_err(lk, lp) <= 1e-5, (lk, lp)
    errs = grad_errs(gk, gp)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])
