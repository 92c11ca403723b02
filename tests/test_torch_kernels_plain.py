"""The torch port's plain kernel versions against the JAX package.

K1: ``kernels.decode.decode_attention_plain`` against the Pallas
``decode_attention`` in interpret mode, on the cases of
tests/test_decode_kernel.py plus grouped query rows under a t bound.
K4: ``kernels.vq.nearest_code_plain`` against ``ops.quantizer.nearest_code``,
exact indices, NaN included, and the port's ``ops.quantizer.nearest_code``
past K4's widest latent against the same. Also the CPU dispatch of both
wrappers, and that the build takes every source in ``csrc/``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.ops.pallas.decode import decode_attention as jax_decode
from dyadic_interaction_modeling_tpu.ops.quantizer import nearest_code as jax_nearest_code
from dyadic_interaction_modeling_tpu_torch.kernels import LAUNCHES
from dyadic_interaction_modeling_tpu_torch.kernels.build import CSRC, SOURCES
from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
    decode_attention,
    decode_attention_plain,
)
from dyadic_interaction_modeling_tpu_torch.kernels.vq import nearest_code, nearest_code_plain
from dyadic_interaction_modeling_tpu_torch.ops import quantizer

TOL = 1e-5  # fp32 on both sides; only the summation order differs


def _mk(bh, l, d, nq=1, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((bh, nq, d), (bh, l, d), (bh, l, d)))


def _both(q, k, v, t=None, mask=None, *, scale):
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     None if t is None else jnp.int32(t),
                     None if mask is None else jnp.asarray(mask),
                     scale=scale, interpret=True)
    out = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), t,
                                 None if mask is None else torch.from_numpy(mask),
                                 scale=scale)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("t", [0, 1, 63, 64, 127, 200, 255])
def test_k1_bounded_prefix(t):
    out, ref = _both(*_mk(8, 256, 64), t=t, scale=0.125)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_k1_unbounded_key_mask():
    q, k, v = _mk(16, 200, 64, seed=1)
    mask = np.random.default_rng(3).random((16, 200)) < 0.7
    mask[:, 0] = True
    out, ref = _both(q, k, v, mask=mask, scale=0.2)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_k1_fully_masked_row_is_zero():
    q, k, v = _mk(8, 128, 64, seed=2)
    mask = np.ones((8, 128), dtype=bool)
    mask[3] = False
    out, ref = _both(q, k, v, mask=mask, scale=0.1)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert np.abs(out[3]).max() == 0.0


@pytest.mark.parametrize("nq", [2, 10])
def test_k1_multi_query_rows(nq):
    q, k, v = _mk(12, 192, 64, nq=nq, seed=4)
    mask = np.random.default_rng(5).random((12, 192)) < 0.8
    mask[:, 0] = True
    out, ref = _both(q, k, v, mask=mask, scale=0.125)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_k1_bounded_plus_mask_odd_rows():
    q, k, v = _mk(5, 96, 48, seed=6)
    mask = np.ones((5, 96), dtype=bool)
    mask[:, 40:] = False
    out, ref = _both(q, k, v, t=70, mask=mask, scale=0.15)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [0, 37, 95])
def test_k1_grouped_queries_with_t_bound(t):
    """NQ = G = 4 query heads per KV head under a t bound (GQA step_self);
    the JAX package's own kernel tests lack this case."""
    out, ref = _both(*_mk(6, 96, 64, nq=4, seed=8), t=t, scale=0.125)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_k1_bf16_inputs():
    q, k, v = _mk(8, 128, 64, seed=7)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = decode_attention_plain(qb, kb, vb, 100, scale=0.125)
    assert out.dtype == torch.bfloat16
    ref = jax_decode(*(jnp.asarray(x.float().numpy()) for x in (qb, kb, vb)),
                     jnp.int32(100), scale=0.125, interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)


def test_k1_shared_mask_rows_equal_repeated_mask():
    """A (R // m, L) key mask serves m consecutive cache rows, as the
    repeated (R, L) mask of the JAX step_cross does."""
    q, k, v = (torch.from_numpy(x) for x in _mk(12, 64, 64, nq=3, seed=9))
    mask = torch.from_numpy(np.random.default_rng(2).random((4, 64)) < 0.6)
    mask[1] = False
    a = decode_attention_plain(q, k, v, None, mask, scale=0.125)
    b = decode_attention_plain(q, k, v, None, mask.repeat_interleave(3, 0), scale=0.125)
    assert torch.equal(a, b)


def test_k1_cpu_dispatch_runs_plain_and_other_devices_raise():
    q, k, v = (torch.from_numpy(x) for x in _mk(4, 32, 64, nq=2, seed=10))
    before = dict(LAUNCHES)
    assert torch.equal(decode_attention(q, k, v, 5, scale=0.3),
                       decode_attention_plain(q, k, v, 5, scale=0.3))
    assert LAUNCHES == before  # a plain call is not a kernel launch
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q.to("meta"), k.to("meta"), v.to("meta"), 5, scale=0.3)


def test_k1_query_row_limit_is_the_same_on_every_device():
    """NQ up to 256 (MQA best-of-10 cross attention has 120); above it the
    wrapper raises with the limit, on the CPU as on the card."""
    q, k, v = (torch.from_numpy(x) for x in _mk(2, 16, 64, nq=256, seed=11))
    assert decode_attention(q, k, v, 7, scale=0.125).shape == (2, 256, 64)
    q = torch.cat([q, q[:, :1]], dim=1)
    with pytest.raises(ValueError, match="NQ=257 .* at most 256"):
        decode_attention(q, k, v, 7, scale=0.125)


@pytest.mark.parametrize("n,n_e,d,seed", [(300, 64, 32, 0), (6400 // 8, 512, 128, 1)])
def test_k4_plain_matches_jax_exactly(n, n_e, d, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, d)).astype(np.float32)
    e = rng.standard_normal((n_e, d)).astype(np.float32)
    ref = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(e)))
    out = nearest_code_plain(torch.from_numpy(z), torch.from_numpy(e))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_k4_ties_go_to_lowest_index():
    e = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    z = torch.tensor([[0.5, 0.5], [2.0, 0.0], [0.0, 3.0]])
    np.testing.assert_array_equal(nearest_code_plain(z, e).numpy(), [0, 0, 1])
    ref = jax_nearest_code(jnp.asarray(z.numpy()), jnp.asarray(e.numpy()))
    np.testing.assert_array_equal(np.asarray(ref), [0, 0, 1])


def test_k4_cpu_dispatch_runs_plain_and_other_devices_raise():
    z, e = torch.randn(40, 16), torch.randn(8, 16)
    assert torch.equal(nearest_code(z, e), nearest_code_plain(z, e))
    with pytest.raises(ValueError, match="unsupported device"):
        nearest_code(z.to("meta"), e.to("meta"))


def test_k4_plain_orders_nan_as_jax():
    """A NaN latent gets code 0 and a NaN code wins every row, in the JAX
    package and in the plain version (the kernel is held to the same on the
    card)."""
    rng = np.random.default_rng(3)
    z = rng.standard_normal((20, 16)).astype(np.float32)
    e = rng.standard_normal((30, 16)).astype(np.float32)
    z[4] = np.nan
    ref = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(e)))
    out = nearest_code_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[4] == 0
    e[17, 2] = np.nan
    ref = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(e)))
    out = nearest_code_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[np.arange(20) != 4] == 17).all()


@pytest.mark.parametrize("d", [48, 64, 96, 128, 40])
def test_k23_head_widths_the_kernels_take(d):
    """K2/K3 are built for D in {48, 64, 96, 128} (48: the listener VQ's
    384 / 8 heads, 96: the speaker VQ's 768 / 8); the wrapper's check, which
    runs before every call on either device, refuses any other D and names
    it."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import KERNEL_D, _check

    x = torch.zeros(4, 32, d)
    if d in KERNEL_D:
        _check("flash_attention_fwd", x, (("k", x), ("v", x)), None)
    else:
        with pytest.raises(ValueError, match=f"D = {d}"):
            _check("flash_attention_fwd", x, (("k", x), ("v", x)), None)


def test_build_compiles_every_source_in_csrc():
    """A kernel source left out of ``kernels/build.py`` would never be built;
    the binding and the kernels share one header of launchers."""
    on_disk = sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cpp"))
    assert sorted(SOURCES) == on_disk
    for name in on_disk:
        assert '#include "kernels.h"' in (CSRC / name).read_text(), name


def test_k23_head_width_limit_is_the_same_on_every_device():
    """A CPU tensor at a width K2/K3 lack (D = 8) raises the card's
    ValueError in the forward, the backward and the differentiable call."""
    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)

    x, lse = torch.zeros(4, 32, 8), torch.zeros(4, 32)
    for call in (lambda: flash_attention(x, x, x, scale=0.5),
                 lambda: flash_attention_fwd(x, x, x, causal=False, scale=0.5),
                 lambda: flash_attention_bwd(x, x, x, x, x, lse, causal=False, scale=0.5)):
        with pytest.raises(ValueError, match="D = 8"):
            call()


def test_k1_head_width_limit_is_the_same_on_every_device():
    """K1 takes D in {64, 128}; a CPU tensor at D = 32 raises as on the card."""
    q, k, v = (torch.from_numpy(x) for x in _mk(2, 16, 32, nq=2, seed=12))
    with pytest.raises(ValueError, match="D % 8 == 0.*got D=32"):
        decode_attention(q, k, v, 7, scale=0.125)


def test_k4_latent_width_limit_is_the_same_on_every_device():
    """K4 takes e_dim <= 256; a CPU latent of 257 raises as on the card."""
    with pytest.raises(ValueError, match="e_dim <= 256, got e_dim = 257"):
        nearest_code(torch.zeros(4, 257), torch.zeros(8, 257))
    assert nearest_code(torch.zeros(4, 256), torch.zeros(8, 256)).shape == (4,)


@pytest.fixture
def one_thread():
    """One intra-op thread: the test run's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("d", [257, 320])
def test_quantizer_past_k4_width_takes_the_dense_argmin(d, one_thread):
    """``ops.quantizer.nearest_code`` past K4's widest latent is the dense
    fp32 argmin on every device, the JAX package's default: its indices."""
    rng = np.random.default_rng(d)
    z = rng.standard_normal((300, d)).astype(np.float32)
    e = rng.standard_normal((64, d)).astype(np.float32)
    ref = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(e)))
    out = quantizer.nearest_code(torch.from_numpy(z), torch.from_numpy(e))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_quantizer_reaches_k4_up_to_its_width(monkeypatch, one_thread):
    widths = []

    def k4(z, e):
        widths.append(z.shape[1])
        return nearest_code(z, e)

    monkeypatch.setattr(quantizer, "_nearest_code", k4)
    for d in (128, 256, 257):
        quantizer.nearest_code(torch.zeros(4, d), torch.zeros(8, d))
    assert widths == [128, 256]


def test_quantizer_dense_argmin_stays_fp32_under_autocast(one_thread):
    """The SLM and finetune steps quantize under a bf16 autocast: the dense
    argmin past K4's width still computes its distances in fp32."""
    rng = np.random.default_rng(7)
    z = rng.standard_normal((300, 257)).astype(np.float32)
    e = rng.standard_normal((64, 257)).astype(np.float32)
    ref = np.asarray(jax_nearest_code(jnp.asarray(z), jnp.asarray(e)))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = quantizer.nearest_code(torch.from_numpy(z), torch.from_numpy(e))
    np.testing.assert_array_equal(out.numpy(), ref)
