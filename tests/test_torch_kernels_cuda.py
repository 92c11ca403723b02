"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (as on the
CPU test host). On a GPU machine, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc for sm_90a")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,nq,l,d,t,masked", [
    (64, 1, 256, 64, 200, False),   # step_self
    (24, 10, 200, 64, None, True),  # step_cross, best-of-10, ragged L
    (30, 4, 96, 128, 70, True),     # GQA rows, bound and mask, D=128
    (250, 12, 256, 64, 200, False), # MQA self: G = 12 query rows
    (25, 120, 256, 64, None, True), # MQA cross, best-of-10: NQ = G * N = 120
    (6, 256, 64, 64, 40, True),     # NQ at its limit
    (12, 50, 120, 64, None, True),  # speaker best-of-50 cross: NQ = 50 over 120 keys
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, tol, rows, nq, l, d, t, masked):
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    q, k, v = (torch.randn(s, device="cuda", generator=cuda).to(dtype)
               for s in ((rows, nq, d), (rows, l, d), (rows, l, d)))
    mask = None
    if masked:  # a mask row serves 6 cache rows (1 where 6 does not divide R)
        mask = torch.rand(rows // 6 if rows % 6 == 0 else rows, l, device="cuda",
                          generator=cuda) < 0.7
        mask[0] = False
    out = decode_attention(q, k, v, t, mask, scale=d ** -0.5)
    ref = decode_attention_plain(q, k, v, t, mask, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq", [1, 10])
def test_decode_attention_kernel_at_split_boundaries(cuda, dtype, nq):
    """t on both sides of every 16-key boundary (chunks are multiples of 16),
    as an int and as a device tensor."""
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    q, k, v = (torch.randn(s, device="cuda", generator=cuda).to(dtype)
               for s in ((24, nq, 64), (24, 256, 64), (24, 256, 64)))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for t in [0] + [b + d for b in range(16, 256, 16) for d in (-1, 0)] + [255]:
        ref = decode_attention_plain(q, k, v, t, scale=0.125)
        for tt in (t, torch.tensor([t], dtype=torch.int32, device="cuda")):
            out = decode_attention(q, k, v, tt, scale=0.125)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


def test_decode_attention_kernel_is_deterministic(cuda):
    """The splits are folded in a fixed order whichever block arrives last."""
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention

    for nq, rows in ((10, 300), (120, 25), (1, 40)):
        q, k, v = (torch.randn(s, device="cuda", generator=cuda).bfloat16()
                   for s in ((rows, nq, 64), (rows, 256, 64), (rows, 256, 64)))
        mask = torch.rand(rows // 5, 256, device="cuda", generator=cuda) < 0.8
        first = decode_attention(q, k, v, None, mask, scale=0.125)
        assert all(torch.equal(first, decode_attention(q, k, v, None, mask, scale=0.125))
                   for _ in range(3))


@pytest.mark.parametrize("n,n_e,d", [(1000, 512, 128), (70, 130, 20), (8192, 512, 128),
                                     (333, 1000, 256)])
def test_nearest_code_kernel_ragged_shapes(cuda, n, n_e, d):
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    e = torch.randn(n_e, d, device="cuda", generator=cuda)
    want = torch.randint(0, n_e, (n,), device="cuda", generator=cuda)
    z = e[want] + 0.01 * torch.randn(n, d, device="cuda", generator=cuda)
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    assert torch.equal(got, want.int()) and torch.equal(got, nearest_code_plain(z, e))


def test_nearest_code_kernel_matches_plain(cuda):
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    e = torch.randn(512, 128, device="cuda", generator=cuda)
    want = torch.randint(0, 512, (1000,), device="cuda", generator=cuda)
    z = e[want] + 0.01 * torch.randn(1000, 128, device="cuda", generator=cuda)
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    assert torch.equal(got, want.int()) and torch.equal(got, nearest_code_plain(z, e))


def test_nearest_code_kernel_orders_nan_as_the_plain_version(cuda):
    """A NaN latent gets code 0 and a NaN code wins its row, as torch.argmin
    orders NaN first."""
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import (
        nearest_code, nearest_code_plain)

    e = torch.randn(300, 64, device="cuda", generator=cuda)
    z = torch.randn(100, 64, device="cuda", generator=cuda)
    z[7] = float("nan")
    e[211, 5] = float("nan")
    got = nearest_code(z, e)
    torch.cuda.synchronize()
    assert torch.equal(got, nearest_code_plain(z, e))
    assert int(got[0]) == 211 and int(got[7]) == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("rows,l,d,causal,masked", [
    (8, 200, 64, False, True),    # ragged tail, key mask, one dead batch entry
    (6, 255, 64, True, False),    # the decoder's causal self-attention
    (4, 130, 128, True, True),    # D = 128
    (4, 129, 128, False, True),   # D = 128, a tail tile of one row
    (4, 2048, 64, False, True),   # enc_max_seq_len as the joint encoder reaches it
    (8, 200, 48, False, True),    # D = 48 (the VQ-VAEs' heads), ragged tail, key mask
    (8, 130, 48, True, True),     # D = 48, causal and masked
    (6, 1024, 48, False, False),  # D = 48 at a VQ training clip's length, no mask
    (8, 130, 96, False, True),    # D = 96 (the speaker VQ's heads), tail tile, key mask
    (8, 1024, 96, False, False),  # D = 96 at the speaker VQ's training shape
    (48, 119, 64, True, False),   # SpeakerSLMFT's teacher-forced decoder, causal tail tile
])
def test_flash_attention_kernels_match_plain(cuda, dtype, tol, rows, l, d, causal, masked):
    """K2 (o, lse) and K3 (dq, dk, dv) against their plain versions; errors
    relative to the reference's largest magnitude."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    q, k, v, do = (torch.randn(rows, l, d, device="cuda", generator=cuda).to(dtype)
                   for _ in range(4))
    mask = None
    if masked:
        mask = torch.rand(rows // 2, l, device="cuda", generator=cuda) < 0.7
        mask[:, 0] = True
        mask[1] = False
    o, lse = flash_attention_fwd(q, k, v, mask, causal=causal, scale=d ** -0.5)
    ro, rlse = flash_attention_fwd_plain(q, k, v, mask, causal=causal, scale=d ** -0.5)
    grads = flash_attention_bwd(q, k, v, ro, do, rlse, mask, causal=causal, scale=d ** -0.5)
    refs = flash_attention_bwd_plain(q, k, v, ro, do, rlse, mask, causal=causal,
                                     scale=d ** -0.5)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    assert torch.equal(torch.isinf(lse), torch.isinf(rlse))
    fin = torch.isfinite(rlse)
    torch.testing.assert_close(lse[fin], rlse[fin], atol=1e-4, rtol=1e-5)
    for g, r in zip(grads, refs):
        assert g.dtype == dtype
        err = float((g.float() - r.float()).abs().max() / r.float().abs().max())
        assert err <= tol, err
    if masked:
        assert float(o[2:4].float().abs().max()) == 0.0
        assert max(float(g[2:4].float().abs().max()) for g in grads) == 0.0


def test_flash_attention_kernels_are_deterministic(cuda):
    """No atomics and a fixed order of sums: two calls agree bitwise."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_bwd, flash_attention_fwd)

    q, k, v, do = (torch.randn(8, 200, 64, device="cuda", generator=cuda).bfloat16()
                   for _ in range(4))
    mask = torch.rand(4, 200, device="cuda", generator=cuda) < 0.7
    mask[1] = False

    def run():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=True, scale=0.125)
        return (o, lse, *flash_attention_bwd(q, k, v, o, do, lse, mask, causal=True,
                                             scale=0.125))

    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_autograd_runs_the_kernels(cuda):
    from dyadic_interaction_modeling_tpu_torch.kernels import LAUNCHES
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention, flash_attention_plain)

    x = [torch.randn(4, 96, 64, device="cuda", generator=cuda, requires_grad=True)
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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
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
