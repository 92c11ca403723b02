"""The torch port's VQ-VAE (BIWI variant) against the JAX package's, same
weights through ``utils.weights.jax_vq_to_state_dict`` (strict load)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.models.vq_vae import VQAutoEncoder as JVQ
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder
from dyadic_interaction_modeling_tpu_torch.ops import convseq, positional
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_vq_to_state_dict

SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, n_embed=64, zquant_dim=16)
B, L = 4, 24


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.vq_listener_defaults()
    jcfg.update(SMALL)
    tcfg = TC.vq_listener_defaults()
    tcfg.update(SMALL)
    jm = JVQ(jcfg)
    x = np.random.default_rng(0).standard_normal((B, L, 56)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = VQAutoEncoder(tcfg)
    tm.load_state_dict(jax_vq_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                            tcfg), strict=True)
    return jm, params, tm.eval(), x


def test_state_dict_keys_follow_reference_layout(pair):
    keys = set(pair[2].state_dict())
    for k in ("encoder.vertice_mapping.0.weight", "encoder.squasher.0.0.weight",
              "encoder.encoder_pos_embedding.pe",
              "encoder.encoder_transformer.net.0.fn.fn.to_qkv.weight",
              "encoder.encoder_transformer.net.1.fn.norm.bias",
              "decoder.expander.0.0.bias", "decoder.vertice_map_reverse.weight",
              "quantize.embedding.weight"):
        assert k in keys, k
    assert "decoder.vertice_map_reverse.bias" not in keys


def test_encode_indices_with_lengths_exact(pair):
    jm, params, tm, x = pair
    lens = np.array([24, 17, 9, 3], dtype=np.int32)
    ref = jax.jit(lambda p, x, n: jm.apply({"params": p}, x, n, method=JVQ.encode_indices))(
        params, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        out = tm.encode_indices(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_encode_indices_unmasked_batch_mode_exact(pair):
    jm, params, tm, x = pair
    ref = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=JVQ.encode_indices))(
        params, jnp.asarray(x))
    with torch.no_grad():
        out = tm.encode_indices(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("with_lengths", [False, True])
def test_decode_indices_matches(pair, with_lengths):
    """>= 3 rows, so the batch-indexed positional encoding (row b gets
    pe[b]) is exercised when no lengths are given."""
    jm, params, tm, _ = pair
    idx = np.random.default_rng(1).integers(0, 64, (B, L)).astype(np.int32)
    lens = np.array([24, 20, 11, 5], dtype=np.int32) if with_lengths else None
    ref = jax.jit(lambda p, i, n: jm.apply({"params": p}, i, lengths=n,
                                           method=JVQ.decode_indices))(
        params, jnp.asarray(idx), None if lens is None else jnp.asarray(lens))
    with torch.no_grad():
        out = tm.decode_indices(torch.from_numpy(idx),
                                None if lens is None else torch.from_numpy(lens))
    ref = np.asarray(ref)
    if lens is not None:  # padded positions carry masked garbage on both sides
        valid = np.arange(L)[None, :] < lens[:, None]
        out, ref = out.numpy()[valid], ref[valid]
    else:
        out = out.numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_positional_modes_and_table():
    from dyadic_interaction_modeling_tpu.ops.positional import sinusoid_table as jtab

    np.testing.assert_array_equal(positional.sinusoid_table(50, 16).numpy(),
                                  np.asarray(jtab(50, 16)))
    pe = positional.PositionalEncoding(8, max_len=20)
    x = torch.zeros(3, 5, 8)
    table = pe.pe[:, 0]
    assert torch.equal(pe(x, "batch")[:, 0], table[:3])
    assert torch.equal(pe(x, "single")[2, 4], table[0])
    assert torch.equal(pe(x, "time")[1], table[:5])


def test_masked_conv_block_equals_per_sample():
    """fill_pad_with_edge + masked instance norm == encoding each sample's
    unpadded sequence alone."""
    torch.manual_seed(0)
    blk = convseq._ConvINBlock(6, 5, affine=True)
    x = torch.randn(2, 12, 6)
    lens = torch.tensor([12, 7])
    with torch.no_grad():
        batched = blk(x, lens)
        alone = blk(x[1:, :7])
    torch.testing.assert_close(batched[1, :7], alone[0], atol=1e-5, rtol=1e-5)


def test_quant_factor_above_zero_is_not_implemented():
    """quant_factor > 0 builds and runs (held against the JAX package in
    ``tests/test_torch_vq_family.py``); what is not implemented there is the
    masked (lengths) path, which the JAX package asserts away."""
    cfg = TC.vq_listener_defaults()
    cfg.update(SMALL, quant_factor=1)
    model = VQAutoEncoder(cfg)
    x = torch.randn(2, 8, 56)
    assert model(x)[0].shape == (2, 8, 56)
    with pytest.raises(ValueError, match="quant_factor"):
        model.encode(x, torch.tensor([8, 5]))
