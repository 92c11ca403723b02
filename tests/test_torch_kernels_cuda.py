"""The port's CUDA kernels against their plain versions, on the card, at
small shapes and at the main paths' own.

Marked ``cuda``: each test skips where no CUDA device is present (as on the
CPU test host). On a GPU machine, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from torch_card import card  # noqa: F401  (a fixture)

pytestmark = pytest.mark.cuda

VQ_SCALE = 384 ** -0.5  # the VQ-VAEs' full-width scale (reference quirk), D = 384 / 8
SPK_SCALE = 768 ** -0.5  # the speaker VQ's, D = 768 / 8


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,nq,l,d,t,group", [
    (64, 1, 256, 64, 200, None),   # step_self
    (24, 10, 200, 64, None, 6),    # step_cross, best-of-10, ragged L
    (30, 4, 96, 128, 70, 6),       # GQA rows, bound and mask, D=128
    (250, 12, 256, 64, 200, None), # MQA self: G = 12 query rows
    (25, 120, 256, 64, None, 1),   # MQA cross, best-of-10: NQ = G * N = 120
    (6, 256, 64, 64, 40, 6),       # NQ at its limit
    (12, 50, 120, 64, None, 6),    # speaker best-of-50 cross: NQ = 50 over 120 keys
    (300, 10, 256, 64, None, 12),  # generate's cross step: 25 clips x 12 heads
])
def test_decode_attention_kernel_matches_plain(card, dtype, tol, rows, nq, l, d, t, group):
    """A mask row serves ``group`` cache rows; mask row 0, and row 3 of a
    mask of more than 4, are fully masked, and their rows' output is exactly
    0."""
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    q, k, v = (torch.randn(s, device="cuda", generator=card).to(dtype)
               for s in ((rows, nq, d), (rows, l, d), (rows, l, d)))
    mask, dead = None, []
    if group:
        mask = torch.rand(rows // group, l, device="cuda", generator=card) < 0.7
        dead = [0, 3] if mask.shape[0] > 4 else [0]
        mask[dead] = False
    out = decode_attention(q, k, v, t, mask, scale=d ** -0.5)
    ref = decode_attention_plain(q, k, v, t, mask, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    for r in dead:
        assert float(out[r * group: (r + 1) * group].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,nq", [
    (24, 1), (24, 10),
    (3000, 1),   # generate's self step: 25 clips x 10 samples x 12 heads
    (250, 12),   # its MQA self step: G = 12 query rows a K/V head
    (750, 4),    # GQA, G = 4
])
def test_decode_attention_kernel_at_split_boundaries(card, dtype, rows, nq):
    """t on both sides of every 16-key boundary (chunks are multiples of 16),
    as an int and as a device tensor."""
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    q, k, v = (torch.randn(s, device="cuda", generator=card).to(dtype)
               for s in ((rows, nq, 64), (rows, 256, 64), (rows, 256, 64)))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for t in [0, 1, 200] + [b + d for b in range(16, 256, 16) for d in (-1, 0)] + [255]:
        ref = decode_attention_plain(q, k, v, t, scale=0.125)
        for tt in (t, torch.tensor([t], dtype=torch.int32, device="cuda"),
                   torch.tensor(t, dtype=torch.int32, device="cuda")):
            out = decode_attention(q, k, v, tt, scale=0.125)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("rows,nq,group", [(300, 10, 5), (25, 120, 5), (40, 1, 5),
                                           (300, 10, 12), (25, 120, 1)])
def test_decode_attention_kernel_is_deterministic(card, rows, nq, group):
    """The splits are folded in a fixed order whichever block arrives last."""
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention

    q, k, v = (torch.randn(s, device="cuda", generator=card).bfloat16()
               for s in ((rows, nq, 64), (rows, 256, 64), (rows, 256, 64)))
    mask = torch.rand(rows // group, 256, device="cuda", generator=card) < 0.8
    mask[3] = False
    first = decode_attention(q, k, v, None, mask, scale=0.125)
    assert all(torch.equal(first, decode_attention(q, k, v, None, mask, scale=0.125))
               for _ in range(3))


@pytest.mark.parametrize("n,n_e,d", [
    (1000, 512, 128), (70, 130, 20), (8192, 512, 128), (333, 1000, 256),
    (6400, 512, 128),  # generate's encode: 25 clips x 256 frames
    (1024, 512, 128),  # a VQ training step's clip, a finetune step's 4 x 256
    (6401, 500, 128),  # N and n_e off the kernel's tiles
])
def test_nearest_code_kernel_ragged_shapes(card, n, n_e, d):
    """Latents near a code take exactly it; on plain random inputs at least
    99.9% of the rows agree with the plain version (the others tie to fp32
    rounding)."""
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    e = torch.randn(n_e, d, device="cuda", generator=card)
    want = torch.randint(0, n_e, (n,), device="cuda", generator=card)
    z = e[want] + 0.01 * torch.randn(n, d, device="cuda", generator=card)
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    assert torch.equal(got, want.int()) and torch.equal(got, nearest_code_plain(z, e))
    z = torch.randn(n, d, device="cuda", generator=card)
    agree = float((nearest_code(z, e) == nearest_code_plain(z, e)).float().mean())
    assert agree >= 0.999, agree


def test_nearest_code_kernel_matches_plain(card):
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    e = torch.randn(512, 128, device="cuda", generator=card)
    want = torch.randint(0, 512, (1000,), device="cuda", generator=card)
    z = e[want] + 0.01 * torch.randn(1000, 128, device="cuda", generator=card)
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    assert torch.equal(got, want.int()) and torch.equal(got, nearest_code_plain(z, e))


@pytest.mark.parametrize("n,n_e,d,nan_code", [(100, 300, 64, 211), (64, 512, 128, None)])
def test_nearest_code_kernel_orders_nan_as_the_plain_version(card, n, n_e, d, nan_code):
    """A NaN latent gets code 0 and a NaN code wins its row, as torch.argmin
    orders NaN first."""
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    e = torch.randn(n_e, d, device="cuda", generator=card)
    z = torch.randn(n, d, device="cuda", generator=card)
    z[7] = float("nan")
    if nan_code is not None:
        e[nan_code, 5] = float("nan")
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    assert torch.equal(got, nearest_code_plain(z, e))
    assert int(got[7]) == 0
    if nan_code is not None:
        assert int(got[0]) == nan_code


def _key_mask(kind, b, l, g):
    """(b, l) keys: "dead" random with key 0 kept and entry 1 fully masked,
    "prefix" ragged lengths from l/2 to l, "prefix+dead" those with entry 1
    fully masked, "random" the finetune's corruption (15% of the keys a row,
    never key 0)."""
    if kind == "dead":
        mask = torch.rand(b, l, device="cuda", generator=g) < 0.7
        mask[:, 0] = True
    elif kind == "random":
        from dyadic_interaction_modeling_tpu_torch.models.xtrans import ar_mask_prob_kv_mask

        return ar_mask_prob_kv_mask(b, l, 0.15, generator=g, device="cuda")
    else:
        lens = torch.randint(l // 2, l + 1, (b,), device="cuda", generator=g)
        mask = torch.arange(l, device="cuda")[None, :] < lens[:, None]
    if kind.endswith("dead"):
        mask[1] = False
    return mask


@pytest.mark.parametrize("dtype,tol_o,tol", [(torch.float32, 2e-5, 1e-4),
                                             (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("rows,l,d,heads,causal,mask,scale", [
    (8, 200, 64, 2, False, "dead", 0.125),    # ragged tail, key mask, one dead batch entry
    (6, 255, 64, 2, True, None, 0.125),       # the decoder's causal self-attention
    (4, 130, 128, 2, True, "dead", 128 ** -0.5),   # D = 128
    (4, 129, 128, 2, False, "dead", 128 ** -0.5),  # D = 128, a tail tile of one row
    (4, 2048, 64, 2, False, "dead", 0.125),   # enc_max_seq_len as the joint encoder reaches it
    (8, 200, 48, 2, False, "dead", 48 ** -0.5),    # D = 48 (the VQ-VAEs' heads), key mask
    (8, 130, 48, 2, True, "dead", 48 ** -0.5),     # D = 48, causal and masked
    (6, 1024, 48, 2, False, None, 48 ** -0.5),     # D = 48 at a VQ clip's length, no mask
    (8, 130, 96, 2, False, "dead", 96 ** -0.5),    # D = 96 (the speaker VQ's), tail tile
    (8, 1024, 96, 2, False, None, 96 ** -0.5),     # D = 96 at the speaker VQ's shape
    (48, 119, 64, 2, True, None, 0.125),      # SpeakerSLMFT's decoder, causal tail tile
    # the SLM training step's four (B = 32, 12 heads), ragged lengths
    (384, 256, 64, 12, False, "prefix", 0.125),       # encoder_s / encoder_l
    (384, 512, 64, 12, False, "prefix+dead", 0.125),  # the joint encoder at 2L
    (768, 256, 64, 12, False, "prefix", 0.125),       # the marginal joint
    (768, 255, 64, 12, True, None, 0.125),            # the decoder's self-attention
    (192, 512, 128, 12, False, "prefix", 128 ** -0.5),  # D = 128
    (24, 2048, 64, 12, False, "prefix", 0.125),         # enc_max_seq_len
    (8, 1024, 48, 8, False, None, VQ_SCALE),             # VQ training, one clip
    (32, 512, 48, 8, False, "prefix", VQ_SCALE),         # VQ tokenizing 4 clips
    (48, 255, 64, 12, True, "random", 0.125),            # the finetune's decoder
    (32, 257, 64, 8, False, "prefix", 0.125),            # the s2s step's encoder
    (32, 256, 64, 8, True, None, 0.125),                 # the s2s step's decoder
    (8, 1024, 96, 8, False, None, SPK_SCALE),            # speaker VQ training
    (32, 512, 96, 8, False, "prefix+dead", SPK_SCALE),   # speaker VQ, 4 clips
])
def test_flash_attention_kernels_match_plain(card, dtype, tol_o, tol, rows, l, d, heads,
                                             causal, mask, scale):
    """K2 (o, lse) and K3 (dq, dk, dv) against their plain versions: o within
    ``tol_o`` (bf16: absolute and relative), lse within 1e-4, gradients
    within ``tol`` of the reference's largest magnitude; a fully masked
    batch entry gives zero output and gradients and an infinite lse."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    q, k, v, do = (torch.randn(rows, l, d, device="cuda", generator=card).to(dtype)
                   for _ in range(4))
    if mask is not None:
        dead = mask.endswith("dead")
        mask = _key_mask(mask, rows // heads, l, card)
    o, lse = flash_attention_fwd(q, k, v, mask, causal=causal, scale=scale)
    ro, rlse = flash_attention_fwd_plain(q, k, v, mask, causal=causal, scale=scale)
    grads = flash_attention_bwd(q, k, v, ro, do, rlse, mask, causal=causal, scale=scale)
    refs = flash_attention_bwd_plain(q, k, v, ro, do, rlse, mask, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    rtol = 0.0 if dtype == torch.float32 else tol_o
    torch.testing.assert_close(o.float(), ro.float(), atol=tol_o, rtol=rtol)
    assert torch.equal(torch.isinf(lse), torch.isinf(rlse))
    fin = torch.isfinite(rlse)
    torch.testing.assert_close(lse[fin], rlse[fin], atol=1e-4, rtol=0)
    for g, r in zip(grads, refs):
        assert g.dtype == dtype
        err = float((g.float() - r.float()).abs().max() / r.float().abs().max())
        assert err <= tol, err
    if mask is not None and dead:
        entry = slice(heads, 2 * heads)
        assert float(o[entry].float().abs().max()) == 0.0
        assert max(float(g[entry].float().abs().max()) for g in grads) == 0.0
        assert bool(torch.isinf(lse[entry]).all())


@pytest.mark.parametrize("rows,l,heads,causal,mask", [
    (8, 200, 2, True, "dead"),
    (384, 512, 12, False, "prefix+dead"),  # the SLM step's joint encoder at 2L
])
def test_flash_attention_kernels_are_deterministic(card, rows, l, heads, causal, mask):
    """No atomics and a fixed order of sums: two calls agree bitwise."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_fwd)

    q, k, v, do = (torch.randn(rows, l, 64, device="cuda", generator=card).bfloat16()
                   for _ in range(4))
    mask = _key_mask(mask, rows // heads, l, card)

    def run():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=causal, scale=0.125)
        return (o, lse, *flash_attention_bwd(q, k, v, o, do, lse, mask, causal=causal,
                                             scale=0.125))

    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_autograd_runs_the_kernels(card):
    from dyadic_interaction_modeling_tpu_torch.kernels import LAUNCHES
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention, flash_attention_plain)

    x = [torch.randn(4, 96, 64, device="cuda", generator=card, requires_grad=True)
         for _ in range(3)]
    before = dict(LAUNCHES)
    flash_attention(*x, causal=True, scale=0.125).square().sum().backward()
    grads = [t.grad.clone() for t in x]
    assert LAUNCHES["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    for t in x:
        t.grad = None
    flash_attention_plain(*x, causal=True, scale=0.125).square().sum().backward()
    for g, t in zip(grads, x):
        torch.testing.assert_close(g, t.grad, atol=1e-4, rtol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code

    q = torch.randn(4, 1, 60, device="cuda")
    with pytest.raises(ValueError, match="D % 8"):
        decode_attention(q, torch.randn(4, 8, 60, device="cuda"),
                         torch.randn(4, 8, 60, device="cuda"), 3, scale=0.1)
    kv = torch.randn(2, 8, 64, device="cuda")
    with pytest.raises(ValueError, match="NQ=257 .* at most 256"):
        decode_attention(torch.randn(2, 257, 64, device="cuda"), kv, kv, 3, scale=0.1)
    with pytest.raises(ValueError, match="float32"):
        nearest_code(torch.randn(8, 16, device="cuda").half(),
                     torch.randn(4, 16, device="cuda").half())
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import flash_attention_fwd

    x = torch.randn(4, 32, 40, device="cuda")
    with pytest.raises(ValueError, match="D = 40"):
        flash_attention_fwd(x, x, x, causal=False, scale=0.1)
    x = torch.randn(4, 32, 64, device="cuda")
    with pytest.raises(ValueError, match="key_mask"):
        flash_attention_fwd(x, x, x, torch.ones(3, 32, device="cuda", dtype=torch.bool),
                            causal=False, scale=0.1)
    with pytest.raises(ValueError, match="torch.float16"):
        flash_attention_fwd(x.half(), x.half(), x.half(), causal=False, scale=0.1)
