"""Generation on the card at full width: SLMFT best-of-N (multi-head and
grouped-query, K1's query rows whole and in two slices), SpeakerSLMFT
best-of-50, and the ``test_s2s`` loop of the ListenerGenerator. Each call's
kernel launches are counted, and the decode steps teacher-forced with the
kernels are held against the same steps with their plain versions.

Marked ``cuda`` (skipped where no card is present). On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_generate_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from torch_card import (B0, BIWI_L, BIWI_N, L, N, S2S_B, TRAIN_STEPS, WARMUP_STEPS,
                        biwi_batch, card, clips, counted, launches, lg_batch,  # noqa: F401
                        lg_training, slmft, speaker_model, teacher_forced_err)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("kv_heads,n", [(0, N), (1, N), (1, 22)])
def test_slmft_best_of_n_launches(card, record_property, kv_heads, n):
    """Best-of-n generation of B0 clips of L (bf16) through
    ``make_slmft_generator`` and ``evaluate_test_epoch``: K1 on the self step
    and on the cross step's G n query rows a context, whole while they fit
    (``MAX_NQ``), else in equal slices (grouped-query at n = 22: 264 rows,
    two slices), in 4 decoder layers x 255 steps; K4 twice; no K2/K3."""
    from dyadic_interaction_modeling_tpu_torch.config import slm_defaults
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import (
        evaluate_test_epoch, make_slmft_generator)
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import MAX_NQ
    from dyadic_interaction_modeling_tpu_torch.metrics.reporting import print_metrics

    model = slmft(kv_heads=kv_heads).to("cuda", torch.bfloat16).eval()
    gen = make_slmft_generator(model)
    seen = {}

    def traced(batch, g, n):
        cands, seen["tokens"] = gen(batch, g, n, return_tokens=True)
        seen["cands"] = cands
        return cands

    rng = torch.Generator(device="cuda").manual_seed(0)
    with counted() as got:
        y_true, y_pred, xs, _ = evaluate_test_epoch(model, traced, clips(B0), rng,
                                                    beam_size=n, device="cuda")
    cands, tokens = seen["cands"], seen["tokens"]
    assert tuple(cands.shape) == (B0, n, L - 1, 56)
    assert bool(torch.isfinite(cands.float()).all())
    assert bool(((tokens >= 0) & (tokens < 512)).all())
    heads = slm_defaults()["dec_heads"]
    cross_nq = heads // (kv_heads or heads) * n
    slices = -(-cross_nq // MAX_NQ)
    assert got == launches(decode_attention=(L - 1) * 4 * (1 + slices), nearest_code=2)
    record_property("launches", got)
    m = print_metrics(y_true, y_pred, xs, verbose=False)
    fd = [m[k] for k in ("fid_pose", "fid_exp", "mse_pose", "mse_exp")]
    assert all(v == v and abs(v) != float("inf") for v in fd), fd


@pytest.mark.parametrize("b0,n,kv_heads", [(4, 2, 0), (2, N, 1), (1, 22, 1)])
def test_slmft_decode_steps_match_plain(card, b0, n, kv_heads):
    """fp32 at b0 clips x n samples: the card's VQ codes (K4) against the
    CPU's (plain), then one token sequence teacher-forced through
    ``decode_step`` with the kernels and with the plain versions (logits
    within 1e-3); grouped-query cross attention at G n = 120 and 264 query
    rows a context, the latter past ``MAX_NQ`` in two slices."""
    cpu_model = slmft(seed=1, kv_heads=kv_heads).eval()
    model = slmft(seed=1, kv_heads=kv_heads).to("cuda").eval()
    src_v, tgt, src_a, mask = (torch.as_tensor(x) for x in clips(b0, seed=5)[0][:4])
    with torch.no_grad():
        codes_cpu = cpu_model.forward_vq(src_v, tgt, mask)[1]
        codes_gpu = model.forward_vq(src_v.cuda(), tgt.cuda(), mask.cuda())[1].cpu()
        same = float((codes_cpu == codes_gpu).float().mean())
        assert same >= 0.99, same
        ctx, prompt = model.encode_context(src_v.cuda(), tgt.cuda(), src_a.cuda(),
                                           mask.cuda())
        cross = model.decoder.cross_kv(ctx)
    g = torch.Generator(device="cuda").manual_seed(4)
    seq = torch.randint(0, 512, (n * b0, L - 1), device="cuda", generator=g)
    seq = torch.cat([prompt.repeat(n, 1).to(seq.dtype), seq], dim=1)
    worst = teacher_forced_err(model.decoder, seq, cross, mask.cuda(), n)
    assert worst <= 1e-3, worst


def test_speaker_best_of_50(card):
    """SpeakerSLMFT best-of-50 at full width, fp32, one clip a call as the
    reference evaluates: ``make_speaker_generator`` then
    ``select_best_by_l2``, each call K1 8 x (L - 1) (self and cross at NQ =
    50 in 4 decoder layers), K4 twice, no K2/K3. Then the greedy sequence
    of a clip teacher-forced through ``decode_step`` with the kernels and
    with the plain versions (logits within 1e-3)."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import (
        make_speaker_generator, select_best_by_l2)

    model = speaker_model(seed=0).to("cuda").eval()
    gen = make_speaker_generator(model)
    batch = biwi_batch(4, seed=21)
    rng = torch.Generator(device="cuda").manual_seed(0)
    for i in range(4):
        clip = tuple(x[i: i + 1] for x in batch)
        with counted() as got:
            cands = gen(clip, rng, BIWI_N)
        assert got == launches(decode_attention=8 * (BIWI_L - 1), nearest_code=2), i
        best = select_best_by_l2(cands[0].cpu().numpy(), clip[1][0, 1:].cpu().numpy())
        assert tuple(cands.shape) == (1, BIWI_N, BIWI_L - 1, 56)
        assert bool(torch.isfinite(cands).all()) and best.shape == (BIWI_L - 1, 56)

    clip = tuple(x[:1] for x in batch)
    with torch.no_grad():
        tokens = gen(clip, None, BIWI_N, greedy=True, return_tokens=True)[1]
        ctx, prompt = model.encode_context(*clip)
        cross = model.decoder.cross_kv(ctx)
    seq = torch.cat([prompt.repeat(BIWI_N, 1).to(tokens.dtype), tokens], dim=1)
    worst = teacher_forced_err(model.decoder, seq, cross, clip[3], BIWI_N)
    assert worst <= 1e-3, worst


def test_s2s_generation(card):
    """The ``test_s2s`` loop (``cli.test_s2s.predict``) on the
    ListenerGenerator after its WARMUP_STEPS + TRAIN_STEPS training steps,
    S2S_B clips of L, fp32: K1 255 x 6 layers x (self, cross), K2 in the 6
    encoder layers, K4 for the two VQ encodes; finite predictions. Then one
    token sequence teacher-forced through ``decode_step`` with the kernels
    and with the plain versions (logits within 1e-3)."""
    from dyadic_interaction_modeling_tpu_torch.cli import test_s2s

    model, step, train_batch = lg_training()
    for _ in range(WARMUP_STEPS + TRAIN_STEPS):
        step(train_batch)
    model.eval()
    batch = lg_batch(seed=43)[:3]
    gen = torch.Generator(device="cuda").manual_seed(1)
    with counted() as got:
        _, y_pred, _ = test_s2s.predict(model, [batch], gen)
    assert got == launches(decode_attention=(L - 1) * 6 * 2, flash_attention_fwd=6,
                           nearest_code=2)
    assert len(y_pred) == S2S_B and all(
        p.shape == (L - 1, 56) and bool(torch.isfinite(torch.as_tensor(p)).all())
        for p in y_pred)
    with torch.no_grad():
        enc, prompt = model.encode_context(*batch)
        dec = model.generator.decoder.net
        cross = dec.cross_kv(enc)
    g = torch.Generator(device="cuda").manual_seed(4)
    seq = torch.cat([prompt, torch.randint(0, 512, (S2S_B, L - 1), device="cuda",
                                           generator=g)], dim=1)
    worst = teacher_forced_err(dec, seq, cross, batch[2])
    assert worst <= 1e-3, worst
