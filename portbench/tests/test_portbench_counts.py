"""The count functions against values worked out by hand at small shapes."""

from __future__ import annotations

import pytest

from portbench.counts import flops as F
from portbench.harness.cell import BENCH, file_module
from portbench.harness.peaks import FP32_3XTF32_FLOPS, HBM_BYTES_PER_S, PEAK_FLOPS

VQ = dict(in_dim=3, hidden_size=4, num_hidden_layers=1, num_attention_heads=2,
          intermediate_size=8, face_quan_num=2, zquant_dim=2, n_embed=5)
SLM = dict(dim_in=3, dim=4, dim_audio=2, enc_depth=1, enc_heads=2, dec_depth=1, dec_heads=2,
           attn_dim_head=2, num_tokens=5)


def test_linear_and_attention():
    assert F.linear(3, 4, 5) == 120
    assert F.attention(2, 4, 3) == 96


def test_vq_encoder_by_hand():
    # a frame: mapping 2*3*4 = 24, conv 2*20*4 = 160, embedding 2*4*4 = 32,
    # qkv 2*4*12 = 96, out 32, mlp 64 + 64, attention 4*4*L, post 2*4*4 = 32,
    # distances 2 per latent * 2*5 = 40 (two latents a frame)
    l = 3
    per_frame = 24 + 160 + 32 + 96 + 32 + 128 + 4 * 4 * l + 32 + 40
    assert F.vq_encoder(VQ, 2, l) == 2 * l * per_frame


def test_vq_decoder_by_hand():
    # pre 2*4*4 = 32, conv 160, embedding 32, layer 96 + 32 + 128 + 16 L, out 2*4*7 = 56
    l = 5
    assert F.vq_decoder(VQ, 1, l, 7) == l * (32 + 160 + 32 + 96 + 32 + 128 + 16 * l + 56)


def test_x_encoder_by_hand():
    # inner 4; a frame: proj 2*3*4 = 24; q, k, v 3*32, out 32, ff 2*2*4*16 = 256,
    # attention 4*4*keys with keys (L + 1) / 2 = 2 causal at L = 3
    assert F.x_encoder(SLM, 1, 3, 3, True) == 3 * (24 + 96 + 32 + 256 + 32)
    assert F.x_encoder(SLM, 1, 3, 3, False) == 3 * (24 + 96 + 32 + 256 + 48)


def test_x_decoder_by_hand():
    # d = 6, inner 4: self 3*48 + 48, cross q 48 + out 48, ff 2*2*6*24 = 576,
    # attention 16 * (1 + 3), logits 2*6*5 = 60
    assert F.x_decoder_tokens(SLM, 1, 1, 3) == 144 + 48 + 96 + 576 + 64 + 60
    assert F.x_decoder_context(SLM, 2) == 2 * 2 * 48


def test_k1_bound_by_hand():
    k1 = file_module(BENCH / "metrics" / "k1_roofline.gen.py")
    # 2 launches of 3 cache rows, 2 query rows, 4 keys, D 8, 10 mask bytes:
    # bytes 3 * (2*2*8 + 2*4*8) * 2 + 10 = 586, operations 4*8*3*2*4 = 768
    want = 2 * max(586 / HBM_BYTES_PER_S, 768 / PEAK_FLOPS["bfloat16"])
    assert k1.bound([(2, 3, 2, 4, 8, 10)], "bfloat16") == pytest.approx(want)


def test_k23_bound_by_hand():
    k23 = file_module(BENCH / "metrics" / "k23_roofline.train.py")
    # rows 2, L 4, D 8, fp32, no mask: io 2*4*8*4 = 256, lse 32;
    # forward 4*256 + 32 bytes and 4*8*(2*16) operations, backward 8*256 + 32
    # and 10*8*32
    fwd = max((4 * 256 + 32) / HBM_BYTES_PER_S, 4 * 8 * 32 / FP32_3XTF32_FLOPS)
    bwd = max((8 * 256 + 32) / HBM_BYTES_PER_S, 10 * 8 * 32 / FP32_3XTF32_FLOPS)
    assert k23.bound([(1, 2, 4, 8, False, 4, 0)], "float32") == pytest.approx(fwd + bwd)
    # causal: 2 * 4 * 5 / 2 = 20 pairs; a mask over 1 row adds 4 bytes
    fwd = max((2 * 128 + 2 * 128 + 32 + 4) / HBM_BYTES_PER_S, 4 * 8 * 20 / PEAK_FLOPS["bfloat16"])
    bwd = max((6 * 128 + 2 * 128 + 32 + 4) / HBM_BYTES_PER_S, 10 * 8 * 20 / PEAK_FLOPS["bfloat16"])
    assert k23.bound([(1, 2, 4, 8, True, 4, 1)], "bfloat16") == pytest.approx(fwd + bwd)


def test_generate_bytes_by_hand():
    from portbench.counts import slm_vico

    cfg = {"slm": SLM, "vq": dict(VQ, in_dim=7), "precision": {"serve_dtype": "bfloat16"}}
    tr = {"kind": "generate", "clips": 2, "samples": 3, "frames": 4}
    w = slm_vico.work(cfg, tr)
    # 6 rows, 3 steps attending 1 + 2 + 3 = 6 keys; a K/V entry 2*4*2 = 16 B
    d, inner = 6, 4
    params = 6 * d * inner + 2 * d * 4 * d + 2 * d * 5
    want = (6 * 6 * 16 + 3 * 2 * 4 * 16 + 3 * params * 2 + 6 * 3 * 16
            + 6 * 3 * (7 * 2 + 8))
    assert w["bytes"] == want and w["token_steps"] == 3
    assert [c[0] for c in w["k1"]] == [1, 1, 1, 3]
