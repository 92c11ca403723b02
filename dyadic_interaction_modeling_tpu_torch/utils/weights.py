"""Weight bridge: the JAX package's flax param trees -> the port's state_dicts.

Adapted from ``dyadic_interaction_modeling_tpu/utils/torch_export.py``
(``flax_vq_to_torch`` :140, ``flax_vq_speaker_to_torch`` :163,
``flax_slm_to_torch`` :260, with its SpeakerSLMFT and EmocaConverter heads
:236-299, ``flax_listener_generator_to_torch`` :302), plus the seq2seq
listener path's ``ContinuousSeq2Seq`` and ``SimpleLSTM``, the speech path's
wav2vec2 / HuBERT trunk, ``CodeTalker`` and the sentiment probe, which the
JAX package does not export, and PIRender's ``FaceGenerator`` (adapted from
``render/import_torch.py:205``, ``flax_face_generator_to_torch``). The inputs are the flax trees as nested mappings of
numpy arrays; no JAX is imported.

Layout notes:

* VQ models follow ``models/stage1_BIWI.py`` module naming; the positional
  ``pe`` tables are buffers and are emitted (``_pe_buffer``) so loads can be
  ``strict=True``.
* The SLM transformer stack follows x-transformers 1.30: its LayerNorm saves
  ``gamma`` (param) + ``beta`` (zero buffer); positional tables are stored
  times ``dim ** 0.5`` because the forward applies ``dim ** -0.5``.
* The wav2vec2 trunk takes HF's ``Wav2Vec2Model`` names (the inverse of
  ``hf_wav2vec2_to_flax``, JAX ``models/wav2vec2.py:342``); CodeTalker's
  decoder takes torch ``nn.TransformerDecoder``'s, its q / k / v kernels
  stacked into ``in_proj_weight``.
* Leaves absent from the flax tree (a never-used ``project_out``, SLMFT's
  speaker-VQ decoder and decoder ``pos_emb``, SpeakerSLMFT's encoders,
  norms and second mesh head) are absent from the port's modules too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.positional import sinusoid_table
from ..models.codetalker import MAX_SEQ_LEN


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _dense(sd, prefix, node, bias=True):
    sd[f"{prefix}.weight"] = _np(node["kernel"]).T
    if bias:
        sd[f"{prefix}.bias"] = _np(node["bias"])


def _layernorm(sd, prefix, node):
    sd[f"{prefix}.weight"] = _np(node["scale"])
    sd[f"{prefix}.bias"] = _np(node["bias"])


def _ref_transformer(sd, prefix, node, num_layers):
    """``ops.transformer.Transformer``; a cross-modal block's attention has
    ``to_q`` and ``to_kv`` where a self-attention block has ``to_qkv``."""
    for j in range(num_layers):
        a, m = 2 * j, 2 * j + 1
        blk = node[f"block_{j}"]
        _layernorm(sd, f"{prefix}.net.{a}.fn.norm", blk["norm_attn"])
        for nm in ("to_qkv", "to_q", "to_kv"):
            if nm in blk["attn"]:
                _dense(sd, f"{prefix}.net.{a}.fn.fn.{nm}", blk["attn"][nm], bias=False)
        _dense(sd, f"{prefix}.net.{a}.fn.fn.to_out", blk["attn"]["to_out"])
        _layernorm(sd, f"{prefix}.net.{m}.fn.norm", blk["norm_mlp"])
        _dense(sd, f"{prefix}.net.{m}.fn.fn.l1", blk["mlp"]["l1"])
        _dense(sd, f"{prefix}.net.{m}.fn.fn.l2", blk["mlp"]["l2"])


def _conv_in(sd, prefix, node, affine, kernel="kernel", bias="bias", transpose=False):
    """One conv block: its (transposed) conv at ``prefix.0``, its affine
    instance norm at ``prefix.2``."""
    # flax (k, in, out) -> torch Conv1d (out, in, k) / ConvTranspose1d (in, out, k)
    sd[f"{prefix}.0.weight"] = _np(node[kernel]).transpose((1, 2, 0) if transpose
                                                          else (2, 1, 0))
    sd[f"{prefix}.0.bias"] = _np(node[bias])
    if affine:
        sd[f"{prefix}.2.weight"] = _np(node["in_scale"])
        sd[f"{prefix}.2.bias"] = _np(node["in_bias"])


def _conv_blocks(sd, prefix, node, affine):
    """A squasher's or expander's blocks: ``block_i`` at ``prefix.i``, and
    a quant_factor > 0 expander's transposed conv (``tconv_*`` with the
    node's own instance norm) at ``prefix.0`` (torch_export.py:73-96)."""
    if "tconv_kernel" in node:
        _conv_in(sd, f"{prefix}.0", node, affine, "tconv_kernel", "tconv_bias", transpose=True)
    for name, blk in node.items():
        if name.startswith("block_"):
            _conv_in(sd, f"{prefix}.{name[len('block_'):]}", blk, affine)


def _pe_buffer(d_model: int, max_len: int = 5000) -> np.ndarray:
    """The reference PositionalEncoding's ``pe`` buffer, (max_len, 1, d)."""
    return sinusoid_table(max_len, d_model).numpy()[:, None, :]


def _vq(sd, p, cfg, prefix="", decoders=("decoder",)):
    """A VQ-VAE's parts the tree holds. The variant and the expander's depth
    follow the tree: the vocaset variant has no ``*_post`` / ``*_pre``
    embeddings and a biased output projection."""
    if "encoder" in p:
        e, pre = p["encoder"], f"{prefix}encoder"
        _dense(sd, f"{pre}.vertice_mapping.0", e["vertice_mapping"])
        _conv_blocks(sd, f"{pre}.squasher", e["squasher"], cfg.INaffine)
        _dense(sd, f"{pre}.encoder_linear_embedding.net",
               e["encoder_linear_embedding"]["net"])
        sd[f"{pre}.encoder_pos_embedding.pe"] = _pe_buffer(cfg.hidden_size)
        _ref_transformer(sd, f"{pre}.encoder_transformer", e["encoder_transformer"],
                         cfg.num_hidden_layers)
        if "encoder_linear_embedding_post" in e:
            _dense(sd, f"{pre}.encoder_linear_embedding_post.net",
                   e["encoder_linear_embedding_post"]["net"])
    for name in (n for n in decoders if n in p):
        d, pre = p[name], f"{prefix}{name}"
        if "decoder_linear_embedding_pre" in d:
            _dense(sd, f"{pre}.decoder_linear_embedding_pre.net",
                   d["decoder_linear_embedding_pre"]["net"])
        _conv_blocks(sd, f"{pre}.expander", d["expander"], cfg.INaffine)
        _dense(sd, f"{pre}.decoder_linear_embedding.net",
               d["decoder_linear_embedding"]["net"])
        sd[f"{pre}.decoder_pos_embedding.pe"] = _pe_buffer(cfg.hidden_size)
        _ref_transformer(sd, f"{pre}.decoder_transformer", d["decoder_transformer"],
                         cfg.num_hidden_layers)
        _dense(sd, f"{pre}.vertice_map_reverse", d["vertice_map_reverse"],
               bias="bias" in d["vertice_map_reverse"])
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
    """``models.vq_vae.VQAutoEncoder`` params, either variant and any
    ``quant_factor`` -> the port's ``VQAutoEncoder`` state_dict (fp32
    tensors)."""
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


def _converter_heads(sd, p):
    """The EmocaConverter heads a tree holds (torch_export.py:241-257): the
    vertices front-end, the BiLSTM (torch's own names) and the mesh head."""
    if "vertice_mapping" in p:
        _dense(sd, "vertice_mapping.0", p["vertice_mapping"])
    if "squasher" in p:
        _conv_in(sd, "squasher.0", p["squasher"]["block_0"], affine=False)
    for k, v in p.get("vertice_map_reverse_lstm", {}).items():
        sd[f"vertice_map_reverse_lstm.{k}"] = _np(v)
    if "vertice_map_reverse" in p:
        _dense(sd, "vertice_map_reverse.0", p["vertice_map_reverse"]["l1"])
        _dense(sd, "vertice_map_reverse.2", p["vertice_map_reverse"]["l2"])


def jax_speaker_slmft_to_state_dict(params, slm_cfg, vq_cfg) -> Dict[str, torch.Tensor]:
    """``models.slm.SpeakerSLMFT`` params -> the port's ``SpeakerSLMFT``
    state_dict: the SLM stack's parts the tree holds, the converter
    front-end, the mesh head, ``speaker_embed`` and ``W``."""
    p = _unwrap(params)
    sd = {k: v.numpy() for k, v in jax_slm_to_state_dict(p, slm_cfg, vq_cfg).items()}
    _converter_heads(sd, p)
    sd["speaker_embed.weight"] = _np(p["speaker_embed"]["embedding"])
    sd["W"] = _np(p["W"])
    return _to_torch(sd)


def jax_converter_to_state_dict(params, vq_cfg) -> Dict[str, torch.Tensor]:
    """``models.slm.EmocaConverter`` params -> the port's ``EmocaConverter``
    state_dict: the speaker VQ and the heads."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    _vq(sd, p["speaker_vq"], vq_cfg, prefix="speaker_vq.")
    _converter_heads(sd, p)
    return _to_torch(sd)


def jax_listener_generator_to_state_dict(params, cfg, vq_cfg_speaker, vq_cfg_listener
                                         ) -> Dict[str, torch.Tensor]:
    """``models.listener_generator.ListenerGenerator`` params -> the port's
    ``ListenerGenerator`` state_dict, in the reference's ``seq2seq.py:138-236``
    layout (``flax_listener_generator_to_torch``, torch_export.py:302):
    ``speaker_vq.``, ``listener_vq.``, ``generator.encoder.``,
    ``generator.decoder.net.`` and, when the tree has them, the id
    embeddings and ``fc_speaker`` / ``fc_listener``."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    for vq, vq_cfg in (("speaker_vq", vq_cfg_speaker), ("listener_vq", vq_cfg_listener)):
        if vq in p:
            _vq(sd, p[vq], vq_cfg, prefix=f"{vq}.")
    gen = p["generator"]
    _xt_continuous(sd, "generator.encoder", gen["encoder"], cfg.enc_depth, cfg.dim)
    _xt_token_decoder(sd, "generator.decoder.net", gen["decoder"], cfg.dec_depth, cfg.dim)
    for emb in ("speaker_embeddings", "listener_embeddings"):
        if emb in p:
            sd[f"{emb}.weight"] = _np(p[emb]["embedding"])
    for fc in ("fc_speaker", "fc_listener"):
        if fc in p:
            _dense(sd, fc, p[fc])
    return _to_torch(sd)


def jax_continuous_seq2seq_to_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """``models.listener_generator.ContinuousSeq2Seq`` params -> the port's
    ``ContinuousSeq2Seq`` state_dict: ``encoder.`` and ``decoder.`` as
    x-transformers' ``ContinuousTransformerWrapper`` (the decoder with its
    ``project_out``)."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    _xt_continuous(sd, "encoder", p["encoder"], cfg.enc_depth, cfg.dim)
    _xt_continuous(sd, "decoder", p["decoder"], cfg.dec_depth, cfg.dim)
    return _to_torch(sd)


def jax_simple_lstm_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """``models.listener_generator.SimpleLSTM`` params -> the port's
    ``SimpleLSTM`` state_dict: the LSTM's torch-named leaves and ``fc``."""
    p = _unwrap(params)
    sd = {f"model.{k}": _np(v) for k, v in p["model"].items()}
    _dense(sd, "fc", p["fc"])
    return _to_torch(sd)


def _w2v(sd, p, prefix=""):
    """``models.wav2vec2.Wav2Vec2Model`` params under HF's names; the conv
    and encoder depths follow the tree."""
    fe = p["feature_extractor"]
    for i in range(len(fe)):
        c, pre = fe[f"conv_{i}"], f"{prefix}feature_extractor.conv_layers.{i}"
        sd[f"{pre}.conv.weight"] = _np(c["kernel"]).transpose(2, 1, 0)
        if "bias" in c:
            sd[f"{pre}.conv.bias"] = _np(c["bias"])
        if "gn_scale" in c:
            sd[f"{pre}.layer_norm.weight"] = _np(c["gn_scale"])
            sd[f"{pre}.layer_norm.bias"] = _np(c["gn_bias"])
        elif "ln" in c:
            _layernorm(sd, f"{pre}.layer_norm", c["ln"])
    _layernorm(sd, f"{prefix}feature_projection.layer_norm", p["fp_norm"])
    _dense(sd, f"{prefix}feature_projection.projection", p["fp_proj"])
    sd[f"{prefix}masked_spec_embed"] = _np(p["masked_spec_embed"])
    pos = f"{prefix}encoder.pos_conv_embed.conv"
    sd[f"{pos}.weight"] = _np(p["pos_conv"]["kernel"]).transpose(2, 1, 0)
    sd[f"{pos}.bias"] = _np(p["pos_conv"]["bias"])
    _layernorm(sd, f"{prefix}encoder.layer_norm", p["enc_norm"])
    n_layers = sum(k.startswith("layer_") for k in p)
    for i in range(n_layers):
        lay, pre = p[f"layer_{i}"], f"{prefix}encoder.layers.{i}"
        for nm in ("q", "k", "v", "out"):
            _dense(sd, f"{pre}.attention.{nm}_proj", lay[nm])
        _layernorm(sd, f"{pre}.layer_norm", lay["ln_attn"])
        _dense(sd, f"{pre}.feed_forward.intermediate_dense", lay["ff1"])
        _dense(sd, f"{pre}.feed_forward.output_dense", lay["ff2"])
        _layernorm(sd, f"{pre}.final_layer_norm", lay["ln_ff"])


def jax_wav2vec2_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """``models.wav2vec2.Wav2Vec2Model`` (or ``HubertModel``) params -> the
    port's ``Wav2Vec2Model`` state_dict."""
    sd: Dict[str, np.ndarray] = {}
    _w2v(sd, _unwrap(params))
    return _to_torch(sd)


def _mha(sd, prefix, lay, which):
    sd[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_np(lay[f"{which}_{nm}"]["kernel"]).T for nm in ("q", "k", "v")])
    sd[f"{prefix}.in_proj_bias"] = np.concatenate(
        [_np(lay[f"{which}_{nm}"]["bias"]) for nm in ("q", "k", "v")])
    _dense(sd, f"{prefix}.out_proj", lay[f"{which}_out"])


def jax_codetalker_to_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """``models.codetalker.CodeTalker`` params -> the port's ``CodeTalker``
    state_dict, the ``PPE.pe`` table included."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    _w2v(sd, p["audio_encoder"], "audio_encoder.")
    _dense(sd, "audio_feature_map", p["audio_feature_map"])
    _dense(sd, "vertice_map", p["vertice_map"])
    repeat = MAX_SEQ_LEN // cfg.period + 1
    sd["PPE.pe"] = np.tile(sinusoid_table(cfg.period, cfg.feature_dim).numpy(), (repeat, 1))[None]
    for i in range(cfg.num_layers):
        lay, pre = p[f"dec_{i}"], f"transformer_decoder.layers.{i}"
        _mha(sd, f"{pre}.self_attn", lay, "self")
        _mha(sd, f"{pre}.multihead_attn", lay, "cross")
        _dense(sd, f"{pre}.linear1", lay["ff1"])
        _dense(sd, f"{pre}.linear2", lay["ff2"])
        for nm in ("norm1", "norm2", "norm3"):
            _layernorm(sd, f"{pre}.{nm}", lay[nm])
    _dense(sd, "feat_map", p["feat_map"], bias=False)
    sd["learnable_style_emb.weight"] = _np(p["learnable_style_emb"]["embedding"])
    _vq(sd, p["autoencoder"], cfg, prefix="autoencoder.")
    return _to_torch(sd)


def jax_sentiment_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """``metrics.sentiment.SentimentMLP`` params -> the port's
    ``SentimentMLP`` state_dict."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    for nm in ("fc1", "fc2", "fc3"):
        _dense(sd, nm, p[nm])
    return _to_torch(sd)


def _fg_conv(sd, prefix, node, kind="conv"):
    """flax Conv (kh, kw, I, O) -> Conv2d (O, I, kh, kw); ConvTranspose
    (kh, kw, I, O), stored flipped in both spatial axes -> ConvTranspose2d
    (I, O, kh, kw) (render/import_torch.py:21-24); Conv1d (k, I, O) ->
    (O, I, k)."""
    k = _np(node["kernel"])
    if kind == "convT":
        k = k[::-1, ::-1].transpose(2, 3, 0, 1)
    elif kind == "conv1d":
        k = k.transpose(2, 1, 0)
    else:
        k = k.transpose(3, 2, 0, 1)
    sd[f"{prefix}.weight"] = np.ascontiguousarray(k)
    sd[f"{prefix}.bias"] = _np(node["bias"])


def _fg_adain(sd, prefix, node):
    for nm, key in (("mlp_shared", "mlp_shared.0"), ("mlp_gamma", "mlp_gamma"),
                    ("mlp_beta", "mlp_beta")):
        _dense(sd, f"{prefix}.{key}", node[nm])


def _fg_ln2d(sd, prefix, node):
    sd[f"{prefix}.weight"] = _np(node["weight"]).reshape(-1, 1, 1)
    sd[f"{prefix}.bias"] = _np(node["bias"]).reshape(-1, 1, 1)


def _count(node, stem):
    return sum(1 for k in node if k.startswith(stem) and k[len(stem):].isdigit())


def jax_face_generator_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """``render.generator.FaceGenerator`` params (use_spect False) -> the
    reference-layout state_dict that ``render.generator.FaceGenerator``
    loads with ``strict=True``: the layout of JAX's
    ``flax_face_generator_to_torch`` (render/import_torch.py:205), its
    depths read off the tree."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    m = p["mapping_net"]
    _fg_conv(sd, "mapping_net.pre", m["pre"], "conv1d")
    _fg_conv(sd, "mapping_net.first.0", m["first"], "conv1d")
    for i in range(_count(m, "encoder")):
        _fg_conv(sd, f"mapping_net.encoder{i}.1", m[f"encoder{i}"], "conv1d")

    w = p["warpping_net"]
    hg, pre = w["hourglass"], "warpping_net.hourglass"
    _fg_conv(sd, f"{pre}.encoder.input_layer", hg["input_layer"])
    for i in range(_count(hg, "encoder")):
        node, q = hg[f"encoder{i}"], f"{pre}.encoder.encoder{i}"
        for nm in ("norm_0", "norm_1"):
            _fg_adain(sd, f"{q}.{nm}", node[nm])
        for nm in ("conv_0", "conv_1"):
            _fg_conv(sd, f"{q}.{nm}", node[nm])
    for name in (k for k in hg if k.startswith("decoder")):
        node, q = hg[name], f"{pre}.decoder.{name}"
        for nm in ("norm_s", "norm_0", "norm_1"):
            _fg_adain(sd, f"{q}.{nm}", node[nm])
        _fg_conv(sd, f"{q}.conv_0", node["conv_0"])
        for nm in ("conv_s", "conv_1"):
            _fg_conv(sd, f"{q}.{nm}", node[nm], "convT")
    _fg_ln2d(sd, "warpping_net.flow_out.0", w["flow_norm"])
    _fg_conv(sd, "warpping_net.flow_out.2", w["flow_conv"])

    e = p["editing_net"]
    _fg_conv(sd, "editing_net.encoder.first.model.0", e["enc_first"])
    _fg_ln2d(sd, "editing_net.encoder.first.model.1", e["enc_first_norm"])
    for i in range(_count(e, "down")):
        for nm, part in (("down", "encoder"), ("up", "decoder"), ("jump", "decoder")):
            _fg_conv(sd, f"editing_net.{part}.{nm}{i}.model.0", e[f"{nm}{i}"])
            _fg_ln2d(sd, f"editing_net.{part}.{nm}{i}.model.1", e[f"{nm}{i}_norm"])
        for b in range(_count(e, f"res{i}_")):
            node, q = e[f"res{i}_{b}"], f"editing_net.decoder.res{i}.res{b}"
            for nm in ("conv1", "conv2"):
                _fg_conv(sd, f"{q}.{nm}", node[nm])
            for nm in ("norm1", "norm2"):
                _fg_adain(sd, f"{q}.{nm}", node[nm])
    _fg_conv(sd, "editing_net.decoder.final.model.0", e["final"])
    return _to_torch(sd)


def _pc_conv(sd, prefix, node, bias=True):
    """flax Conv (kh, kw, I, O) -> Conv2d (O, I, kh, kw)."""
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_np(node["kernel"]).transpose(3, 2, 0, 1))
    if bias:
        sd[f"{prefix}.bias"] = _np(node["bias"])


def _pc_bn(sd, prefix, node, eps):
    """A folded BN (``scale``, ``bias``) -> an eval BatchNorm2d that applies
    the same affine map: running mean 0, running variance 1 - eps."""
    scale = _np(node["scale"])
    sd[f"{prefix}.weight"] = scale
    sd[f"{prefix}.bias"] = _np(node["bias"])
    sd[f"{prefix}.running_mean"] = np.zeros_like(scale)
    sd[f"{prefix}.running_var"] = np.full_like(scale, 1.0 - eps)
    sd[f"{prefix}.num_batches_tracked"] = np.zeros(())


_VGG_CONV_SLOTS = {  # torchvision ``features`` indices of the convs
    name: [i for i, v in enumerate(
        [m for v in cfg for m in (("M",) if v == "M" else ("C", "R"))]) if v == "C"]
    for name, cfg in (("vgg19", [64, 64, "M", 128, 128, "M"] + [256] * 4 + ["M"]
                       + ([512] * 4 + ["M"]) * 2),
                      ("vgg16", [64, 64, "M", 128, 128, "M"] + [256] * 3 + ["M"]
                       + ([512] * 3 + ["M"]) * 2))}
_INCEPTION_BRANCHES = {
    "A": ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2",
          "branch3x3dbl_3", "branch_pool"),
    "B": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
    "C": ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
          "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5",
          "branch_pool"),
    "D": ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
          "branch7x7x3_4"),
    "E": ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"),
}
_INCEPTION_BLOCKS = (("Mixed_5b", "A"), ("Mixed_5c", "A"), ("Mixed_5d", "A"), ("Mixed_6a", "B"),
                     ("Mixed_6b", "C"), ("Mixed_6c", "C"), ("Mixed_6d", "C"), ("Mixed_6e", "C"),
                     ("Mixed_7a", "D"), ("Mixed_7b", "E"), ("Mixed_7c", "E"))
_VGGFACE_CONVS = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2", "conv3_3",
                  "conv4_1", "conv4_2", "conv4_3", "conv5_1", "conv5_2", "conv5_3")


def jax_perceptual_to_state_dict(network: str, params) -> Dict[str, torch.Tensor]:
    """The params of one of JAX ``render/perceptual.py``'s trunks (the
    ``PERCEPTUAL_NETWORKS`` names) -> the state_dict of the port's trunk of
    that name (``render.perceptual``, torchvision's layout), which it loads
    with ``strict=True``. A folded BN becomes an eval BatchNorm2d with
    running mean 0 and running variance 1 - eps. With it, the JAX default
    random-feature loss (``vgg_params=None``) is reproduced in the port."""
    p = _unwrap(params)
    sd: Dict[str, np.ndarray] = {}
    if network in _VGG_CONV_SLOTS:
        for i, slot in enumerate(_VGG_CONV_SLOTS[network]):
            if f"conv_{i}" in p:
                _pc_conv(sd, f"features.{slot}", p[f"conv_{i}"])
    elif network == "alexnet":
        for i, slot in enumerate((0, 3, 6, 8, 10)):
            _pc_conv(sd, f"features.{slot}", p[f"conv_{i}"])
    elif network in ("resnet50", "robust_resnet50"):
        _pc_conv(sd, "conv1", p["conv1"], bias=False)
        _pc_bn(sd, "bn1", p["bn1"], 1e-5)
        for si, blocks in enumerate((3, 4, 6, 3)):
            for bi in range(blocks):
                src, dst = f"layer{si + 1}_{bi}", f"layer{si + 1}.{bi}"
                for k in (1, 2, 3):
                    _pc_conv(sd, f"{dst}.conv{k}", p[f"{src}_c{k}"], bias=False)
                    _pc_bn(sd, f"{dst}.bn{k}", p[f"{src}_b{k}"], 1e-5)
                if bi == 0:
                    _pc_conv(sd, f"{dst}.downsample.0", p[f"{src}_down"], bias=False)
                    _pc_bn(sd, f"{dst}.downsample.1", p[f"{src}_down_bn"], 1e-5)
    elif network == "inception_v3":
        def basic(prefix, node):
            _pc_conv(sd, f"{prefix}.conv", node["conv"], bias=False)
            _pc_bn(sd, f"{prefix}.bn", node["bn"], 1e-3)

        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
                     "Conv2d_4a_3x3"):
            basic(name, p[name])
        for name, kind in _INCEPTION_BLOCKS:
            for branch in _INCEPTION_BRANCHES[kind]:
                basic(f"{name}.{branch}", p[name][branch])
    elif network == "vgg_face_dag":
        for i, name in enumerate(_VGGFACE_CONVS):
            _pc_conv(sd, name, p[f"conv_{i}"])
        for fc in ("fc6", "fc7", "fc8"):
            _dense(sd, fc, p[fc])
    else:
        raise ValueError(f"unknown perceptual network: {network}")
    return _to_torch(sd)
