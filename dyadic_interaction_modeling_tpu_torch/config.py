"""Configuration: attribute-access config dicts and the SLMFT default bundles.

A copy of the parts of ``dyadic_interaction_modeling_tpu/config.py`` that the
port's CLIs need (``CfgNode``, ``load_cfg_from_cfg_file``, ``slm_defaults``,
``vq_listener_defaults``, ``vq_speaker_defaults``,
``listener_generator_defaults``, ``codetalker_defaults``, the ``KEY VALUE`` override
merge) plus the ``vq_cfg_for`` rule of ``cli/common.py`` and the seq2seq
CLIs' VQ rule (``lg_vq_cfg``). The port keeps its
own copy so it never imports the JAX package.
"""

from __future__ import annotations

import copy
import os
from ast import literal_eval
from typing import Any, Dict, List, Optional


class CfgNode(dict):
    """Dict with attribute access; nested dicts become nested ``CfgNode``."""

    def __init__(self, init_dict: Optional[Dict[str, Any]] = None):
        init_dict = {} if init_dict is None else dict(init_dict)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                init_dict[k] = CfgNode(v)
        super().__init__(init_dict)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)


def load_cfg_from_cfg_file(file: str) -> CfgNode:
    """A sectioned YAML config (the reference's DATA / NETWORK / TRAIN / ...
    sections), flattened one level: every leaf key becomes a top-level key.
    Needs PyYAML, which only this function imports."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("--config needs PyYAML (the 'yaml' module), which is not "
                          "installed") from e
    if not (os.path.isfile(file) and file.endswith((".yaml", ".yml"))):
        raise ValueError(f"{file} is not a yaml file")
    with open(file) as f:
        cfg_from_file = yaml.safe_load(f) or {}
    cfg: Dict[str, Any] = {}
    for key, section in cfg_from_file.items():
        if isinstance(section, dict):
            cfg.update(section)
        else:
            cfg[key] = section
    return CfgNode(cfg)


def _decode_cfg_value(v: Any) -> Any:
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def merge_cfg_from_list(cfg: CfgNode, cfg_list: List[str]) -> CfgNode:
    """Merge trailing ``KEY VALUE`` CLI pairs into a copy of ``cfg``; a value
    must keep its key's type (int may widen to float, list <-> tuple)."""
    new_cfg = cfg.clone()
    if len(cfg_list) % 2 != 0:
        raise ValueError(f"Override list must have even length: {cfg_list}")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key = full_key.split(".")[-1]
        if key not in cfg:
            raise KeyError(f"Non-existent config key: {full_key}")
        value, original = _decode_cfg_value(v), cfg[key]
        if type(value) is not type(original) and original is not None:
            casts = [(tuple, list), (list, tuple), (int, float)]
            for from_type, to_type in casts:
                if type(value) is from_type and type(original) is to_type:
                    value = to_type(value)
                    break
            else:
                raise ValueError(f"Type mismatch ({type(original)} vs. "
                                 f"{type(value)}) for config key: {full_key}")
        setattr(new_cfg, key, value)
    return new_cfg


def vq_listener_defaults() -> CfgNode:
    """Listener / generic VQ-VAE (reference code/config.yaml)."""
    return CfgNode(dict(
        arch="stage1_BIWI",
        in_dim=56,
        hidden_size=384,
        num_hidden_layers=6,
        num_attention_heads=8,
        intermediate_size=1536,
        quant_factor=0,
        face_quan_num=1,
        neg=0.2,
        INaffine=False,
        n_embed=512,
        zquant_dim=128,
        quant_loss_weight=1.0,
        base_lr=1e-4,
        batch_size=1,
        batch_size_val=1,
        epochs=40,
        weight_decay=0.002,
        manual_seed=131,
        dtype="float32",
    ))


def vq_speaker_defaults() -> CfgNode:
    """Audio-visual speaker VQ-VAE (reference code/config_speaker.yaml): one
    encoder over 56 motion + 768 audio = 824 features, hidden 768 (8 heads of
    96), 8 codes a frame."""
    cfg = vq_listener_defaults()
    cfg.update(arch="stage1_speaker_BIWI", in_dim=824, hidden_size=768,
               face_quan_num=8, epochs=100)
    return cfg


def slm_defaults() -> CfgNode:
    """SLM / SLMFT transformer dims (seq2seq_pretrain.py:116-133)."""
    return CfgNode(dict(
        dim_in=56,
        dim=384,
        dim_audio=768,
        enc_depth=4,
        enc_heads=12,
        enc_max_seq_len=2048,
        dec_depth=4,
        dec_heads=12,
        dec_max_seq_len=2048,
        attn_dim_head=64,
        # grouped-query attention: K/V heads per attention (0 = heads)
        attn_kv_heads=0,
        num_tokens=512,
        mask_ratio=0.15,
        contrastive_temp=0.05,
        epochs=10,
        dtype="float32",
    ))


def listener_generator_defaults() -> CfgNode:
    """Seq2seq ListenerGenerator dims without pretraining (seq2seq.py:177-192)."""
    return CfgNode(dict(
        dim=512,
        enc_depth=6,
        enc_heads=8,
        enc_max_seq_len=1024,
        dec_num_tokens=512,
        dec_depth=6,
        dec_heads=8,
        dec_max_seq_len=1024,
        num_identities=100,
        id_embed_dim=256,
        epochs=10,
        dtype="float32",
    ))


def codetalker_defaults() -> CfgNode:
    """Stage-2 CodeTalker (reference code/models/stage2.py + BIWI config),
    ``config.py:296-315`` of the JAX package: the vertex VQ's motion dim is
    the mesh's, so ``in_dim == vertice_dim``."""
    cfg = vq_listener_defaults()
    cfg.update(dict(
        arch="stage2",
        dataset="BIWI",
        feature_dim=1024,
        vertice_dim=70110,
        in_dim=70110,
        n_head=4,
        num_layers=6,
        period=25,
        train_subjects="F2 F3 F4 M3 M4 M5",
        motion_weight=1.0,
        reg_weight=1.0,
    ))
    return cfg


def vq_cfg_for(slm_cfg, synthetic: bool = False) -> CfgNode:
    """VQ config consistent with an SLM config: the decoder predicts VQ code
    indices, so n_embed must equal num_tokens. With ``synthetic``, the VQ is
    shrunk to the (possibly tiny) SLM dims for smoke runs."""
    vq = vq_listener_defaults()
    vq.n_embed = slm_cfg.num_tokens
    if synthetic and slm_cfg.dim < 128:
        vq.update(dict(hidden_size=max(32, slm_cfg.dim),
                       num_hidden_layers=1, num_attention_heads=2,
                       intermediate_size=2 * max(32, slm_cfg.dim),
                       zquant_dim=32))
    return vq


def lg_vq_cfg(lg_cfg, synthetic: bool = False) -> CfgNode:
    """The listener VQ config of a ListenerGenerator config (both VQs take
    it, as the JAX CLIs build them, ``cli/train_s2s.py:130-135``): n_embed is
    the decoder's vocabulary; with ``synthetic`` and dim < 128 the VQ is
    shrunk for smoke runs."""
    vq = vq_listener_defaults()
    vq.n_embed = lg_cfg.dec_num_tokens
    if synthetic and lg_cfg.dim < 128:
        vq.update(dict(hidden_size=max(32, lg_cfg.dim), num_hidden_layers=1,
                       num_attention_heads=2, intermediate_size=2 * max(32, lg_cfg.dim),
                       zquant_dim=32))
    return vq
