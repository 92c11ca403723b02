"""K2/K3's plain versions against the JAX package's flash attention.

``kernels.attention.flash_attention_fwd_plain`` (o, lse) and
``flash_attention_bwd_plain`` (dq, dk, dv) against the Pallas ``_fwd`` /
``_bwd`` in interpret mode and against ``jax.vjp`` of the dense path; CPU
autograd through ``flash_attention``; a fully masked row; ``XAttention``'s
flash route (a self-attention without an attn_mask) against its matmul
route (the same attention given an all-True attn_mask). Tolerances:
2e-5 for the forward and 1e-4 for gradients, fp32 on both sides, where only
the order of the sums differs. Then what the card's bf16 kernels do
differently from the plain backward, rounding P and dS to bf16 as operands,
held to the card's tolerance here; and the wrappers' dispatch by dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dyadic_interaction_modeling_tpu.ops.pallas.attention as FA
from dyadic_interaction_modeling_tpu_torch.kernels import LAUNCHES
from dyadic_interaction_modeling_tpu_torch.kernels import attention as A
from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from dyadic_interaction_modeling_tpu_torch.models import xtrans as T

FWD_TOL, GRAD_TOL = 2e-5, 1e-4
H = 2  # heads: a (B, L) key mask serves H consecutive rows


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpreter mode on the CPU."""
    from jax.experimental import pallas as pl

    real_call = pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interp_call)


def _inputs(b, l, d, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b * H, l, d)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = rng.random((b, l)) < 0.7
        mask[:, 0] = True  # no query row is left without a key
    return q, k, v, do, mask


def _rows(mask):
    """The (B*H, L) per-row key mask the Pallas kernels take."""
    return jnp.asarray(np.repeat(mask, H, axis=0))


def _t(*xs):
    return tuple(None if x is None else torch.from_numpy(np.array(x)) for x in xs)


def _dense(q, k, v, mask_rows, causal, scale):
    """The JAX package's dense attention (``models/xtrans.py:198-218``)."""
    s = jnp.einsum("rid,rjd->rij", q, k) * scale
    l = s.shape[-1]
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((l, l), bool))[None], s, -jnp.inf)
    if mask_rows is not None:
        s = jnp.where(mask_rows[:, None, :], s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    p = jnp.where(jnp.isfinite(s).any(axis=-1, keepdims=True), p, 0.0)
    return jnp.einsum("rij,rjd->rid", p, v)


CASES = [(64, 64, False, True), (64, 128, True, False), (200, 64, True, True),
         (200, 128, False, True), (130, 64, False, False),
         (130, 96, False, True)]  # D = 96: the speaker VQ's 768 / 8 heads


@pytest.mark.parametrize("l,d,causal,masked", CASES)
def test_plain_forward_and_backward_match_pallas(interpret, l, d, causal, masked):
    q, k, v, do, mask = _inputs(2, l, d, masked, seed=l + d)
    scale = d ** -0.5
    rows = _rows(mask) if masked else jnp.ones((2 * H, l), bool)
    o, lse = FA._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), rows, scale, causal)
    to, tlse = flash_attention_fwd_plain(*_t(q, k, v, mask), causal=causal, scale=scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse), rtol=FWD_TOL, atol=FWD_TOL)
    grads = FA._bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, jnp.asarray(do),
                    lse, rows, scale, causal)
    tgrads = flash_attention_bwd_plain(*_t(q, k, v, o, do, lse, mask), causal=causal,
                                       scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("l,d,causal,masked", CASES)
def test_plain_versions_match_dense_vjp(l, d, causal, masked):
    q, k, v, do, mask = _inputs(2, l, d, masked, seed=7 * l + d)
    scale = d ** -0.5
    rows = None if mask is None else _rows(mask)
    o, vjp = jax.vjp(lambda q, k, v: _dense(q, k, v, rows, causal, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    to, tlse = flash_attention_fwd_plain(*_t(q, k, v, mask), causal=causal, scale=scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(o), rtol=FWD_TOL, atol=FWD_TOL)
    tgrads = flash_attention_bwd_plain(*_t(q, k, v), to, *_t(do), tlse,
                                       *_t(mask), causal=causal, scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), tgrads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_autograd_equals_the_explicit_backward(causal):
    q, k, v, do, mask = _t(*_inputs(3, 96, 64, True, seed=11))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    before = dict(LAUNCHES)
    o = flash_attention(qr, kr, vr, mask, causal=causal, scale=0.125)
    o.backward(do)
    assert LAUNCHES == before  # CPU tensors run the plain version, no kernel
    ref_o, lse = flash_attention_fwd(q, k, v, mask, causal=causal, scale=0.125)
    assert torch.equal(o.detach(), ref_o)
    grads = flash_attention_bwd(q, k, v, ref_o, do, lse, mask, causal=causal, scale=0.125)
    for a, b in zip((qr.grad, kr.grad, vr.grad), grads):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_fully_masked_row_gives_zero_output_and_gradients():
    q, k, v, do, mask = _t(*_inputs(3, 80, 64, True, seed=12))
    mask[1] = False  # batch entry 1: every key masked
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    o = flash_attention(qr, kr, vr, mask, scale=0.125)
    o.backward(do)
    dead = slice(H, 2 * H)
    assert o[dead].abs().max() == 0.0
    for g in (qr.grad, kr.grad, vr.grad):
        assert torch.isfinite(g).all() and g[dead].abs().max() == 0.0
    _, lse = flash_attention_fwd(q, k, v, mask, causal=False, scale=0.125)
    assert torch.isinf(lse[dead]).all() and torch.isfinite(lse[:H]).all()
    dq, dk, dv = flash_attention_bwd(q, k, v, o.detach(), do, lse, mask, causal=False,
                                     scale=0.125)
    assert max(float(g[dead].abs().max()) for g in (dq, dk, dv)) == 0.0


def _bwd_with_bf16_operands(q, k, v, o, do, lse, mask, causal, scale):
    """``flash_attention_bwd_plain`` with P and dS rounded to bf16 before
    their products, as the tensor-core kernels round them."""
    s = A._scores(q, k, scale)
    keep = A._keep(q, mask, causal)
    if keep is not None:
        s = s.masked_fill(~keep, -A.INF)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.bfloat16().float().transpose(1, 2), dof)
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).bfloat16().float()
    return (torch.matmul(ds, k.float()).to(q.dtype),
            torch.matmul(ds.transpose(1, 2), q.float()).to(k.dtype), dv.to(v.dtype))


@pytest.mark.parametrize("l,causal,masked", [(255, True, False), (200, False, True)])
def test_bf16_operands_stay_inside_the_cards_gradient_tolerance(l, causal, masked):
    """Why the card's bf16 tolerance (2e-2 of the largest magnitude) holds for
    kernels that feed P and dS to the tensor cores in bf16: the rounding
    moves the gradients by a few e-3, and a fully masked entry's stay 0."""
    q, k, v, do, mask = _t(*_inputs(12, l, 64, masked, seed=l))
    q, k, v, do = (x.bfloat16() for x in (q, k, v, do))
    if masked:
        mask[1] = False
    o, lse = flash_attention_fwd_plain(q, k, v, mask, causal=causal, scale=0.125)
    refs = flash_attention_bwd_plain(q, k, v, o, do, lse, mask, causal=causal, scale=0.125)
    grads = _bwd_with_bf16_operands(q, k, v, o, do, lse, mask, causal, 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), grads, refs):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert 0.0 < err <= 2e-2, (name, err)
    if masked:
        dead = slice(H, 2 * H)
        assert max(float(g[dead].float().abs().max()) for g in grads) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_of_both_dtypes_reach_the_plain_version(dtype):
    q, k, v, do, mask = _t(*_inputs(2, 70, 64, True, seed=13))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    before = dict(LAUNCHES)
    o, lse = flash_attention_fwd(q, k, v, mask, causal=True, scale=0.125)
    ro, rlse = flash_attention_fwd_plain(q, k, v, mask, causal=True, scale=0.125)
    assert o.dtype == dtype and torch.equal(o, ro) and torch.equal(lse, rlse)
    grads = flash_attention_bwd(q, k, v, o, do, lse, mask, causal=True, scale=0.125)
    refs = flash_attention_bwd_plain(q, k, v, o, do, lse, mask, causal=True, scale=0.125)
    assert all(g.dtype == dtype and torch.equal(g, r) for g, r in zip(grads, refs))
    assert torch.equal(flash_attention(q, k, v, mask, causal=True, scale=0.125), ro)
    assert LAUNCHES == before


def test_float16_raises_on_the_cpu_too():
    q = torch.zeros(2, 8, 64, dtype=torch.float16)
    lse = torch.zeros(2, 8)
    for call in (lambda: flash_attention(q, q, q, scale=0.125),
                 lambda: flash_attention_fwd(q, q, q, causal=False, scale=0.125),
                 lambda: flash_attention_bwd(q, q, q, q, q, lse, causal=False, scale=0.125)):
        with pytest.raises(ValueError, match="float32 or bfloat16, got torch.float16"):
            call()


def test_other_devices_raise():
    q = torch.zeros(2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q, scale=0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q, q, q, causal=False, scale=0.125)


@pytest.mark.parametrize("causal,kv_heads", [(False, None), (True, 2), (False, 1)])
def test_xattention_flash_route_equals_matmul_route(monkeypatch, causal, kv_heads):
    """XAttention's flash route (flash_attention, K/V repeated to full heads
    under kv_heads; the kernels on the card, the plain version here) against
    its matmul route, forward and gradients."""
    calls = []
    monkeypatch.setattr(T, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash_attention(*a, **kw))
    torch.manual_seed(0)
    attn = T.XAttention(64, heads=4, dim_head=64, causal=causal, kv_heads=kv_heads)
    x = torch.randn(3, 40, 64)
    mask = torch.arange(40)[None, :] < torch.tensor([40, 23, 9])[:, None]

    def run(attn_mask):
        xr = x.clone().requires_grad_()
        out = attn(xr, key_mask=mask, attn_mask=attn_mask)
        out.square().sum().backward()
        grads = [xr.grad] + [p.grad.clone() for p in attn.parameters()]
        attn.zero_grad()
        return out.detach(), grads

    ref, ref_grads = run(torch.ones(40, 40, dtype=torch.bool))
    assert not calls
    out, grads = run(None)
    assert len(calls) == 1
    torch.testing.assert_close(out, ref, rtol=FWD_TOL, atol=FWD_TOL)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
