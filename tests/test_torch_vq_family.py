"""The rest of the VQ family and ``ops/`` in the torch port against the JAX
package on the CPU: ``VQAutoEncoder`` at ``quant_factor`` 1 and 2 (the
strided squasher, the ConvTranspose expander) and the vocaset variant,
``decode_feats``, ``decode_logit`` and ``get_logit``, ``CrossModalAttention``
and the cross-modal ``Transformer``, ``AudioEmbedding``, ``CrossModalLayer``,
``PositionEmbedding``, ``PeriodicPositionalEncoding``, ``init_biased_mask``,
``enc_dec_mask`` and ``get_model("stage1_vocaset")``.

The same numpy inputs (seeded) go through both; JAX-initialised weights go
through the port's bridge (``utils/weights.py``). fp32 within 1e-5 of the
reference's largest magnitude (``_close``; a VQ-VAE's reconstruction, of
magnitude ~5, carries its encoder's ~2e-7 rounding through the straight-
through latents), codes and masks exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.models import get_model as j_get_model
from dyadic_interaction_modeling_tpu.models.vq_vae import VQAutoEncoder as JVQ
from dyadic_interaction_modeling_tpu.models.vq_vae import get_logit as j_get_logit
from dyadic_interaction_modeling_tpu.ops import positional as JP
from dyadic_interaction_modeling_tpu.ops.convseq import ConvSquasher as JConvSquasher
from dyadic_interaction_modeling_tpu.ops import transformer as JT
from dyadic_interaction_modeling_tpu.utils.torch_export import flax_vq_to_torch
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.models import get_model
from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder, get_logit
from dyadic_interaction_modeling_tpu_torch.ops import positional as TP
from dyadic_interaction_modeling_tpu_torch.ops import transformer as TT
from dyadic_interaction_modeling_tpu_torch.ops.convseq import ConvExpander, ConvSquasher
from dyadic_interaction_modeling_tpu_torch.utils import weights as W

TOL = 1e-5
L = 16


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cfg_mod, **kw):
    cfg = cfg_mod.vq_listener_defaults()
    cfg.update(dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128, zquant_dim=32, n_embed=64))
    cfg.update(kw)
    return cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(variant="BIWI", seed=0, **kw):
    """The JAX VQAutoEncoder with seeded params and the port's twin loaded
    through ``jax_vq_to_state_dict`` (strict)."""
    jcfg, tcfg = _cfg(JC, **kw), _cfg(TC, **kw)
    jm = JVQ(jcfg, variant=variant)
    x = np.zeros((2, L, jcfg.in_dim), np.float32)
    args = (x, np.zeros((2, jcfg.in_dim), np.float32)) if variant == "vocaset" else (x,)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(seed), *args))
    tm = VQAutoEncoder(tcfg, variant=variant)
    tm.load_state_dict(W.jax_vq_to_state_dict(params, tcfg), strict=True)
    return jm, params, tm.eval(), tcfg


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("face_quan_num,quant_factor", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_vq_autoencoder_quant_factor_matches_jax(face_quan_num, quant_factor):
    """Reconstruction, quantization loss and perplexity within 1e-5, codes
    exact, and the bridge's state_dict equal to the JAX package's export of
    the same params (``flax_vq_to_torch``)."""
    jm, params, tm, tcfg = _pair(face_quan_num=face_quan_num, quant_factor=quant_factor)
    x = _x(1, 2, L, 56)
    dec, loss, enc = jax.jit(jm.apply)(params, x)
    with torch.no_grad():
        tdec, tloss, tenc = tm(torch.from_numpy(x))
    assert tdec.shape == (2, L, 56)
    assert tenc.indices.shape == (2, L // 2 ** quant_factor * face_quan_num)
    np.testing.assert_array_equal(tenc.indices.numpy(), np.asarray(enc.indices))
    _close(tdec.numpy(), dec)
    np.testing.assert_allclose(float(tloss), float(loss), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tenc.perplexity), float(enc.perplexity), rtol=TOL)
    ref = flax_vq_to_torch(params, _cfg(JC, face_quan_num=face_quan_num,
                                        quant_factor=quant_factor))
    ours = tm.state_dict()
    assert set(ref) == set(ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_vocaset_variant_with_template_matches_jax():
    """No pre/post embeddings, a biased output projection, the template
    subtracted before encoding and added back after decoding."""
    jm, params, tm, tcfg = _pair("vocaset", seed=2, hidden_size=32)
    assert not any("_post" in k or "_pre" in k for k in tm.state_dict())
    assert tm.decoder.vertice_map_reverse.bias is not None
    x, tmpl = _x(3, 2, L, 56), _x(4, 2, 56)
    dec, loss, enc = jax.jit(jm.apply)(params, x, tmpl)
    with torch.no_grad():
        tdec, tloss, tenc = tm(torch.from_numpy(x), torch.from_numpy(tmpl))
    np.testing.assert_array_equal(tenc.indices.numpy(), np.asarray(enc.indices))
    _close(tdec.numpy(), dec)
    np.testing.assert_allclose(float(tloss), float(loss), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="template"):
        tm(torch.from_numpy(x))


def test_get_model_builds_stage1_vocaset():
    cfg = _cfg(TC, hidden_size=32, arch="stage1_vocaset")
    model = get_model(cfg)
    assert isinstance(model, VQAutoEncoder) and model.variant == "vocaset"
    jmodel = j_get_model(_cfg(JC, hidden_size=32, arch="stage1_vocaset"))
    params = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                           np.zeros((1, 8, 56), np.float32),
                                           np.zeros((1, 56), np.float32)))
    model.load_state_dict(W.jax_vq_to_state_dict(params, cfg), strict=True)
    stage2 = TC.codetalker_defaults()  # CodeTalker, ported since: built, no longer refused
    stage2.update(hidden_size=32, feature_dim=32, vertice_dim=90, in_dim=90, n_head=2,
                  num_layers=1)
    assert type(get_model(stage2)).__name__ == "CodeTalker"


def test_decode_feats_matches_jax():
    jm, params, tm, _ = _pair(seed=5, face_quan_num=2)
    q = _x(6, 2, 32, 2 * L)
    ref = jax.jit(lambda p, q: jm.apply(p, q, method=JVQ.decode_feats))(params, q)
    with torch.no_grad():
        out = tm.decode_feats(torch.from_numpy(q))
    assert out.shape == (2, L, 64)
    _close(out.numpy(), ref)


def test_decode_logit_and_get_logit_match_jax():
    """The argmax branch exactly; the sampled branch exactly under the JAX
    draw's own Gumbel noise (``jax.random.categorical`` is the argmax of
    the log-probabilities plus ``jax.random.gumbel`` of their shape); top_p
    never applied."""
    jm, params, tm, tcfg = _pair(seed=7)
    logits = _x(8, 2, 10, 64) * 3
    ix, probs = j_get_logit(jax.random.PRNGKey(0), jnp.asarray(logits), sample=False)
    tix, tprobs = get_logit(torch.from_numpy(logits), sample=False)
    np.testing.assert_array_equal(tix.numpy(), np.asarray(ix))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), atol=1e-6, rtol=TOL)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ix, _ = j_get_logit(key, jnp.asarray(logits))
        noise = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape)))
        tix, _ = get_logit(torch.from_numpy(logits), gumbel=noise, top_p=0.1)
        np.testing.assert_array_equal(tix.numpy(), np.asarray(ix))
    drawn, _ = get_logit(torch.from_numpy(logits), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 10) and bool(((drawn >= 0) & (drawn < 64)).all())
    zshape = (2, 10, tcfg.zquant_dim)
    for inp in (logits, np.asarray(ix)):
        ref = jax.jit(lambda p, x: jm.apply(p, x, zshape, method=JVQ.decode_logit))(
            params, inp)
        with torch.no_grad():
            out = tm.decode_logit(torch.from_numpy(inp), zshape)
        _close(out.numpy(), ref)


@pytest.mark.parametrize("qf", [0, 1, 2])
def test_squash_expand_shapes(qf):
    """(B, L, C) -> L / 2 ** qf -> L (``tests/test_ops.py``'s case), and the
    audio expander's two extra blocks."""
    sq, ex = ConvSquasher(16, 16, qf), ConvExpander(16, 16, qf)
    y = sq(torch.randn(2, 32, 16))
    assert y.shape == (2, 32 // 2 ** qf, 16) and ex(y).shape == (2, 32, 16)
    if qf:
        assert len(ConvExpander(16, 16, qf, is_audio=True)) == qf + 2


@pytest.mark.parametrize("qf", [1, 2])
def test_masked_squash_needs_quant_factor_zero(qf):
    """The JAX package asserts; the port raises."""
    lengths = np.array([32, 20])
    x = _x(9, 2, 32, 16)
    with pytest.raises(AssertionError):
        JConvSquasher(dim=16, quant_factor=qf).init(jax.random.PRNGKey(0), x, lengths)
    with pytest.raises(ValueError, match="quant_factor == 0"):
        ConvSquasher(16, 16, qf)(torch.from_numpy(x), torch.from_numpy(lengths))
    with pytest.raises(ValueError, match="quant_factor == 0"):
        ConvExpander(16, 16, qf)(torch.from_numpy(x), torch.from_numpy(lengths))


def _attn_sd(p, prefix=""):
    sd = {}
    for nm in ("to_kv", "to_q"):
        W._dense(sd, f"{prefix}{nm}", p[nm], bias=False)
    W._dense(sd, f"{prefix}to_out", p["to_out"])
    return W._to_torch(sd)


@pytest.mark.parametrize("mask_kind", [None, "2d", "3d"])
def test_cross_modal_attention_matches_jax(mask_kind):
    a, b = _x(10, 2, 6, 32), _x(11, 2, 9, 32)
    mask = None
    if mask_kind == "2d":
        mask = np.random.default_rng(12).random((6, 9)) > 0.3
    elif mask_kind == "3d":
        mask = np.random.default_rng(12).random((2, 6, 9)) > 0.3
    if mask is not None:
        mask[:, ..., 0] = True
    jm = JT.CrossModalAttention(32, 4)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), a, b, mask))["params"]
    ref = jm.apply({"params": params}, a, b, mask)
    tm = TT.CrossModalAttention(32, 4)
    tm.load_state_dict(_attn_sd(params), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(a), torch.from_numpy(b),
                 None if mask is None else torch.from_numpy(mask))
    _close(out.numpy(), ref)


def test_cross_modal_transformer_matches_jax():
    """``Transformer(cross_modal=True)``: queries from the fixed context, the
    K/V stream normed and updated (the JAX TransformerBlock's context)."""
    x, ctx = _x(13, 2, 7, 32), _x(14, 2, 7, 32)
    jm = JT.Transformer(32, 2, 4, 64, cross_modal=True)
    params = _np_tree(jm.init(jax.random.PRNGKey(1), x, ctx))["params"]
    ref = jm.apply({"params": params}, x, ctx)
    sd = {}
    W._ref_transformer(sd, "m", params, 2)
    tm = TT.Transformer(32, 2, 4, 64, cross_modal=True)
    tm.load_state_dict({k[2:]: v for k, v in W._to_torch(sd).items()}, strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), context=torch.from_numpy(ctx))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("qf", [0, 1, 2])
def test_audio_embedding_matches_jax(qf):
    x = _x(15, 2, 16, 64)  # (B, C, L)
    jm = JT.AudioEmbedding(size=16, dim=8, quant_factor=qf)
    params = _np_tree(jm.init(jax.random.PRNGKey(2), x))["params"]
    ref = jm.apply({"params": params}, x)
    sd = {}
    W._dense(sd, "proj", params["proj"])
    tm = TT.AudioEmbedding(16, 8, qf)
    tm.load_state_dict(W._to_torch(sd), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (2, 8, 64 // 4 // 2 ** max(qf, 1))
    _close(out.numpy(), ref)


def test_cross_modal_layer_matches_jax():
    a, b = _x(16, 2, 6, 16), _x(17, 2, 6, 16)
    jm = JT.CrossModalLayer(in_dim=16, out_dim=5, sequence_length=32)
    params = _np_tree(jm.init(jax.random.PRNGKey(4), a, b))["params"]
    # the table is zero-initialised: give it values so the test sees it
    params["pos_embedding"] = _x(18, 32, 16)
    sd = {"pos_embedding": params["pos_embedding"]}
    W._ref_transformer(sd, "transformer_layer", params["transformer_layer"], 2)
    W._layernorm(sd, "cross_norm_layer", params["cross_norm_layer"])
    W._dense(sd, "cross_output_layer", params["cross_output_layer"], bias=False)
    tm = TT.CrossModalLayer(16, 5, 32)
    tm.load_state_dict(W._to_torch(sd), strict=True)
    for args in ((a, b), (a,)):
        ref = jm.apply({"params": params}, *args)
        with torch.no_grad():
            out = tm(*map(torch.from_numpy, args))
        assert out.shape == (2, 6 * len(args), 5)
        _close(out.numpy(), ref)
    with pytest.raises(ValueError, match="hidden sizes"):
        tm(torch.from_numpy(a), torch.zeros(2, 6, 8))


def test_position_embedding_and_periodic_encoding_match_jax():
    x = _x(19, 2, 12, 8)
    table = _x(20, 12, 8)
    ref = JP.PositionEmbedding(12, 8).apply({"params": {"pos_embedding": table}}, x)
    pe = TP.PositionEmbedding(12, 8)
    pe.load_state_dict({"pos_embedding": torch.from_numpy(table)}, strict=True)
    np.testing.assert_allclose(pe(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)
    ppe = TP.PeriodicPositionalEncoding(8, period=4, max_seq_len=16, dropout=0.1).eval()
    ref = JP.PeriodicPositionalEncoding(8, period=4, max_seq_len=16).apply({}, x)
    out = ppe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), atol=TOL, rtol=TOL)
    # the tiling of tests/test_ops.py: row t equals row t + period
    zero = ppe(torch.zeros(1, 12, 8))[0].numpy()
    np.testing.assert_allclose(zero[0], zero[4], atol=1e-7)
    np.testing.assert_allclose(zero[1], zero[9], atol=1e-7)
    assert tuple(ppe.pe.shape) == (1, 4 * (16 // 4 + 1), 8)


@pytest.mark.parametrize("n_head,max_len,period", [(4, 12, 3), (6, 20, 25), (12, 33, 5)])
def test_init_biased_mask_matches_jax(n_head, max_len, period):
    ref = np.asarray(JP.init_biased_mask(n_head, max_len, period))
    out = TP.init_biased_mask(n_head, max_len, period).numpy()
    assert out.dtype == np.float32 and out.shape == (n_head, max_len, max_len)
    np.testing.assert_array_equal(out, ref)
    assert np.isneginf(out[0, 0, 1]) and out[0, 5, 5] == 0.0


@pytest.mark.parametrize("dataset,t,s", [("BIWI", 4, 8), ("BIWI", 5, 7), ("vocaset", 4, 4)])
def test_enc_dec_mask_matches_jax(dataset, t, s):
    np.testing.assert_array_equal(TP.enc_dec_mask(dataset, t, s).numpy(),
                                  np.asarray(JP.enc_dec_mask(dataset, t, s)))
    with pytest.raises(ValueError):
        TP.enc_dec_mask("other", t, s)
