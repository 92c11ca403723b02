"""The plain references against the port at tiny widths in fp32: the same
weights and inputs give the same context, logits, motion, losses,
gradients and three optimizer steps."""

from __future__ import annotations

import pytest
import torch

from conftest import TINY_SLM, TINY_VQ
from portbench.harness import traffic, weights
from portbench.reference import common, slm_vico as R, vq_speaker_av as RV

P = common.Prec("fp32")


def _cfgs():
    from dyadic_interaction_modeling_tpu_torch.config import (
        CfgNode, slm_defaults, vq_listener_defaults, vq_speaker_defaults)

    slm = dict(slm_defaults(), **TINY_SLM)
    vq = dict(vq_listener_defaults(), **TINY_VQ)
    spk = dict(vq_speaker_defaults(), **TINY_VQ)
    return CfgNode, slm, vq, spk


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_slmft_generation_pieces():
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT

    CfgNode, slm, vq, _ = _cfgs()
    m = SLMFT(CfgNode(slm), CfgNode(vq)).eval()
    W = weights.seeded_params(m, traffic.generator(5, 0, "cpu"), torch.float32)
    weights.load(m, W)
    sp, li, au, mask = traffic.dyadic_clips(traffic.generator(5, 1, "cpu"), 3, 20, "cpu")
    with torch.no_grad():
        ctx, prompt = m.encode_context(sp, li, au, mask)
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(0, slm["num_tokens"], (6, 19), generator=g)
        rows = torch.arange(6)
        seq = torch.cat([prompt.repeat(2, 1), toks[:, :-1]], 1)
        lg = m.decoder(seq, context=ctx[rows % 3], context_mask=mask[rows % 3])
        mo = m.decode_tokens_to_motion(toks)
    rctx = R.context(P, W, slm, sp, au, mask)
    assert _rel(ctx, rctx) < 1e-5
    assert torch.equal(R.prompt_candidates(W, vq, li, mask)[:, 0], prompt[:, 0].long())
    rl = R.logits(P, W, slm, prompt.repeat(2, 1)[:, 0].long(), toks, rctx, mask, rows % 3)
    assert _rel(lg, rl) < 1e-5
    assert _rel(mo, R.motion(P, W, vq, toks, rows)) < 1e-5
    # the decode of a subset of rows takes each row's own batch position
    sub = torch.tensor([4, 1])
    assert _rel(mo[sub], R.motion(P, W, vq, toks[sub], sub)) < 1e-5


def _grads(model):
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


def test_slm_loss_and_gradients():
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM

    CfgNode, slm, vq, _ = _cfgs()
    m = SLM(CfgNode(slm), CfgNode(vq))
    W = weights.seeded_params(m, traffic.generator(6, 0, "cpu"), torch.float32)
    weights.load(m, W)
    batch = traffic.dyadic_clips(traffic.generator(6, 1, "cpu"), 3, 20, "cpu")
    g = torch.Generator().manual_seed(1)
    noise = (torch.rand(3, 20, generator=g), torch.rand(3, 20, generator=g))
    out = m(*batch, noise=noise)
    out.total_loss.backward()
    Wr = {k: v.detach().clone().requires_grad_(True) for k, v in W.items()}
    total = R.slm_loss(P, Wr, slm, vq, batch, noise)[0]
    total.backward()
    assert float(total.detach()) == pytest.approx(float(out.total_loss.detach()), rel=1e-5)
    got = _grads(m)
    assert set(got) == {k for k, v in Wr.items() if v.grad is not None}
    assert max(_rel(got[k], Wr[k].grad) for k in got) < 1e-4


def test_speaker_vq_loss_and_gradients():
    from dyadic_interaction_modeling_tpu_torch.metrics.loss import calc_vq_loss_AV
    from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQSpeakerAutoEncoder

    CfgNode, _, _, spk = _cfgs()
    m = VQSpeakerAutoEncoder(CfgNode(spk))
    W = weights.seeded_params(m, traffic.generator(7, 0, "cpu"), torch.float32)
    weights.load(m, W)
    x = traffic.av_clips(traffic.generator(7, 1, "cpu"), 1, 40, "cpu")
    dec, eloss, _ = m(x)
    total = calc_vq_loss_AV(dec, x, eloss)[0]
    total.backward()
    Wr = {k: v.detach().clone().requires_grad_(True) for k, v in W.items()}
    ref = RV.loss(P, Wr, spk, x)[0]
    ref.backward()
    assert float(ref.detach()) == pytest.approx(float(total.detach()), rel=1e-5)
    got = _grads(m)
    assert max(_rel(got[k], Wr[k].grad) for k in got) < 1e-4


def test_three_adamw_steps_match_the_ports():
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.engine.vq_engine import make_vq_train_step
    from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQSpeakerAutoEncoder

    CfgNode, _, _, spk = _cfgs()
    m = VQSpeakerAutoEncoder(CfgNode(spk))
    W = weights.seeded_params(m, traffic.generator(8, 0, "cpu"), torch.float32)
    weights.load(m, W)
    W0 = {k: v.detach().clone() for k, v in W.items()}
    step = make_vq_train_step(m, make_optimizer(m, 1e-3, 0.01), audio_visual=True)
    g = traffic.generator(8, 1, "cpu")
    xs = [traffic.av_clips(g, 1, 32, "cpu") for _ in range(3)]
    losses = [float(step(x)["loss"]) for x in xs]
    ref_losses, _, _, final = common.train_steps(lambda Wd, x: RV.loss(P, Wd, spk, x), W0,
                                              RV.trainable(W0), xs, 1e-3, 0.01)
    assert ref_losses == pytest.approx(losses, rel=1e-5)
    params = dict(m.named_parameters())
    # Adam moves an element whose gradient is round-off by up to lr: held
    # by each leaf's change as a whole
    gaps = [abs(float((params[k].detach() - W0[k]).norm()) - float((final[k] - W0[k]).norm()))
            / float((final[k] - W0[k]).norm()) for k in final]
    assert max(gaps) < 1e-4


@pytest.mark.parametrize("name,bits", [("bf16", 8), ("tf32", 11)])
def test_lower_precisions_round_as_their_formats(name, bits):
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q = common.Prec(name).r(x)
    rel = ((q - x).abs() / x.abs()).max()
    assert 0 < float(rel) <= 2.0 ** -bits


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q = common.Prec("fp8").r(x)
    big = x.abs() > x.abs().max() / 64  # normal range of e4m3 at this scale
    assert float(((q - x).abs() / x.abs())[big].max()) <= 2.0 ** -4 + 1e-6
