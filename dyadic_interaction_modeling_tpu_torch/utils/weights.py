"""Weight bridge: the JAX package's flax param trees -> the port's state_dicts.

Adapted from ``dyadic_interaction_modeling_tpu/utils/torch_export.py``
(``flax_vq_to_torch`` :140, ``flax_vq_speaker_to_torch`` :163,
``flax_slm_to_torch`` :260). The inputs are the
flax trees as nested mappings of numpy arrays; no JAX is imported.

Layout notes:

* VQ models follow ``models/stage1_BIWI.py`` module naming; the positional
  ``pe`` tables are buffers and are emitted (``_pe_buffer``) so loads can be
  ``strict=True``.
* The SLM transformer stack follows x-transformers 1.30: its LayerNorm saves
  ``gamma`` (param) + ``beta`` (zero buffer); positional tables are stored
  times ``dim ** 0.5`` because the forward applies ``dim ** -0.5``.
* Leaves absent from the flax tree (a never-used ``project_out``, SLMFT's
  speaker-VQ decoder and decoder ``pos_emb``) are absent from the port's
  modules too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.positional import sinusoid_table


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _dense(sd, prefix, node, bias=True):
    sd[f"{prefix}.weight"] = _np(node["kernel"]).T
    if bias:
        sd[f"{prefix}.bias"] = _np(node["bias"])


def _layernorm(sd, prefix, node):
    sd[f"{prefix}.weight"] = _np(node["scale"])
    sd[f"{prefix}.bias"] = _np(node["bias"])


def _conv1d(sd, prefix, node):
    # flax (k, in, out) -> torch Conv1d (out, in, k)
    sd[f"{prefix}.weight"] = _np(node["kernel"]).transpose(2, 1, 0)
    sd[f"{prefix}.bias"] = _np(node["bias"])


def _ref_transformer(sd, prefix, node, num_layers):
    for j in range(num_layers):
        a, m = 2 * j, 2 * j + 1
        blk = node[f"block_{j}"]
        _layernorm(sd, f"{prefix}.net.{a}.fn.norm", blk["norm_attn"])
        _dense(sd, f"{prefix}.net.{a}.fn.fn.to_qkv", blk["attn"]["to_qkv"], bias=False)
        _dense(sd, f"{prefix}.net.{a}.fn.fn.to_out", blk["attn"]["to_out"])
        _layernorm(sd, f"{prefix}.net.{m}.fn.norm", blk["norm_mlp"])
        _dense(sd, f"{prefix}.net.{m}.fn.fn.l1", blk["mlp"]["l1"])
        _dense(sd, f"{prefix}.net.{m}.fn.fn.l2", blk["mlp"]["l2"])


def _conv_block(sd, prefix, node, affine):
    blk = node["block_0"]
    _conv1d(sd, f"{prefix}.0.0", blk)
    if affine:
        sd[f"{prefix}.0.2.weight"] = _np(blk["in_scale"])
        sd[f"{prefix}.0.2.bias"] = _np(blk["in_bias"])


def _pe_buffer(d_model: int, max_len: int = 5000) -> np.ndarray:
    """The reference PositionalEncoding's ``pe`` buffer, (max_len, 1, d)."""
    return sinusoid_table(max_len, d_model).numpy()[:, None, :]


def _check_qf(cfg):
    if cfg.quant_factor != 0:
        raise NotImplementedError("the torch port implements quant_factor == 0 only")


def _vq(sd, p, cfg, prefix="", decoders=("decoder",)):
    _check_qf(cfg)
    if "encoder" in p:
        e, pre = p["encoder"], f"{prefix}encoder"
        _dense(sd, f"{pre}.vertice_mapping.0", e["vertice_mapping"])
        _conv_block(sd, f"{pre}.squasher", e["squasher"], cfg.INaffine)
        _dense(sd, f"{pre}.encoder_linear_embedding.net",
               e["encoder_linear_embedding"]["net"])
        sd[f"{pre}.encoder_pos_embedding.pe"] = _pe_buffer(cfg.hidden_size)
        _ref_transformer(sd, f"{pre}.encoder_transformer", e["encoder_transformer"],
                         cfg.num_hidden_layers)
        _dense(sd, f"{pre}.encoder_linear_embedding_post.net",
               e["encoder_linear_embedding_post"]["net"])
    for name in (n for n in decoders if n in p):
        d, pre = p[name], f"{prefix}{name}"
        _dense(sd, f"{pre}.decoder_linear_embedding_pre.net",
               d["decoder_linear_embedding_pre"]["net"])
        _conv_block(sd, f"{pre}.expander", d["expander"], cfg.INaffine)
        _dense(sd, f"{pre}.decoder_linear_embedding.net",
               d["decoder_linear_embedding"]["net"])
        sd[f"{pre}.decoder_pos_embedding.pe"] = _pe_buffer(cfg.hidden_size)
        _ref_transformer(sd, f"{pre}.decoder_transformer", d["decoder_transformer"],
                         cfg.num_hidden_layers)
        _dense(sd, f"{pre}.vertice_map_reverse", d["vertice_map_reverse"], bias=False)
    if "quantize" in p:
        sd[f"{prefix}quantize.embedding.weight"] = _np(p["quantize"]["embedding"])


def _xt_attn(sd, prefix, node):
    for nm in ("to_q", "to_k", "to_v", "to_out"):
        _dense(sd, f"{prefix}.{nm}", node[nm], bias=False)


def _xt_ff(sd, prefix, node):
    _dense(sd, f"{prefix}.ff.0.0", node["w1"])
    _dense(sd, f"{prefix}.ff.3", node["w2"])


def _xt_norm(sd, prefix, node):
    w = _np(node["scale"])
    sd[f"{prefix}.gamma"] = w
    sd[f"{prefix}.beta"] = np.zeros_like(w)


def _xt_continuous(sd, prefix, node, depth, dim):
    _dense(sd, f"{prefix}.project_in", node["project_in"])
    if "pos_emb" in node:
        sd[f"{prefix}.pos_emb.emb.weight"] = _np(node["pos_emb"]) * dim ** 0.5
    lay, pre = node["layers"], f"{prefix}.attn_layers"
    for i in range(depth):
        _xt_norm(sd, f"{pre}.layers.{2 * i}.0.0", lay[f"norm_attn_{i}"])
        _xt_attn(sd, f"{pre}.layers.{2 * i}.1", lay[f"attn_{i}"])
        _xt_norm(sd, f"{pre}.layers.{2 * i + 1}.0.0", lay[f"norm_ff_{i}"])
        _xt_ff(sd, f"{pre}.layers.{2 * i + 1}.1", lay[f"ff_{i}"])
    _xt_norm(sd, f"{pre}.final_norm", lay["final_norm"])
    if "project_out" in node:
        _dense(sd, f"{prefix}.project_out", node["project_out"])


def _xt_token_decoder(sd, prefix, node, depth, dim):
    sd[f"{prefix}.token_emb.emb.weight"] = _np(node["token_emb"]["embedding"])
    if "pos_emb" in node:
        sd[f"{prefix}.pos_emb.emb.weight"] = _np(node["pos_emb"]) * dim ** 0.5
    lay, pre = node["layers"], f"{prefix}.attn_layers"
    for i in range(depth):
        s, c, f = 3 * i, 3 * i + 1, 3 * i + 2
        _xt_norm(sd, f"{pre}.layers.{s}.0.0", lay[f"norm_self_{i}"])
        _xt_attn(sd, f"{pre}.layers.{s}.1", lay[f"self_{i}"])
        _xt_norm(sd, f"{pre}.layers.{c}.0.0", lay[f"norm_cross_{i}"])
        _xt_attn(sd, f"{pre}.layers.{c}.1", lay[f"cross_{i}"])
        _xt_norm(sd, f"{pre}.layers.{f}.0.0", lay[f"norm_ff_{i}"])
        _xt_ff(sd, f"{pre}.layers.{f}.1", lay[f"ff_{i}"])
    _xt_norm(sd, f"{pre}.final_norm", lay["final_norm"])
    _dense(sd, f"{prefix}.to_logits", node["to_logits"], bias=False)


def _unwrap(params) -> Mapping:
    inner = params.get("params") if isinstance(params, Mapping) else None
    return inner if isinstance(inner, Mapping) else params


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in sd.items()}


def jax_vq_to_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """``models.vq_vae.VQAutoEncoder`` (BIWI) params -> the port's
    ``VQAutoEncoder`` state_dict (fp32 tensors)."""
    sd: Dict[str, np.ndarray] = {}
    _vq(sd, _unwrap(params), cfg)
    return _to_torch(sd)


def jax_vq_speaker_to_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """``models.vq_vae.VQSpeakerAutoEncoder`` params -> the port's
    ``VQSpeakerAutoEncoder`` state_dict (fp32 tensors)."""
    sd: Dict[str, np.ndarray] = {}
    _vq(sd, _unwrap(params), cfg, decoders=("decoder_v", "decoder_a"))
    return _to_torch(sd)


def jax_slm_to_state_dict(params, slm_cfg, vq_cfg) -> Dict[str, torch.Tensor]:
    """``models.slm.SLM`` or ``SLMFT`` params -> the port's ``SLM`` or
    ``SLMFT`` state_dict: every part the tree holds (SLM's ``encoder_l``,
    ``norm_l``, ``norm``, speaker-VQ decoder and decoder ``pos_emb``
    included)."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    for vq in ("speaker_vq", "listener_vq"):
        if vq in p:
            _vq(sd, p[vq], vq_cfg, prefix=f"{vq}.")
    for nm in ("patch_embed_s", "patch_embed_l", "patch_embed_dec_s",
               "patch_embed_dec_l"):
        if nm in p:
            sd[nm] = _np(p[nm])
    for nm in ("norm_s", "norm_l", "norm"):
        if nm in p:
            _layernorm(sd, nm, p[nm])
    for enc in ("encoder_s", "encoder_l", "encoder_joint"):
        if enc in p:
            _xt_continuous(sd, enc, p[enc], slm_cfg.enc_depth, slm_cfg.dim)
    if "decoder_joint" in p:
        _xt_token_decoder(sd, "decoder_joint.net", p["decoder_joint"],
                          slm_cfg.dec_depth, slm_cfg.dim + slm_cfg.dim_audio)
    return _to_torch(sd)
