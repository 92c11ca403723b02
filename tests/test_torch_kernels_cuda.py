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
    (30, 4, 96, 48, 70, True),      # GQA rows, bound and mask, D=48
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, tol, rows, nq, l, d, t, masked):
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)

    q, k, v = (torch.randn(s, device="cuda", generator=cuda).to(dtype)
               for s in ((rows, nq, d), (rows, l, d), (rows, l, d)))
    mask = None
    if masked:
        mask = torch.rand(rows // 6, l, device="cuda", generator=cuda) < 0.7
        mask[0] = False
    out = decode_attention(q, k, v, t, mask, scale=d ** -0.5)
    ref = decode_attention_plain(q, k, v, t, mask, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from dyadic_interaction_modeling_tpu_torch.kernels.decode import decode_attention
    from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code

    q = torch.randn(4, 1, 60, device="cuda")
    with pytest.raises(ValueError, match="D % 8"):
        decode_attention(q, torch.randn(4, 8, 60, device="cuda"),
                         torch.randn(4, 8, 60, device="cuda"), 3, scale=0.1)
    with pytest.raises(ValueError, match="float32"):
        nearest_code(torch.randn(8, 16, device="cuda").half(),
                     torch.randn(4, 16, device="cuda").half())
