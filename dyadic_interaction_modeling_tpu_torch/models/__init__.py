"""The port's models. ``get_model`` builds a stage-1 tokenizer, or the
stage-2 CodeTalker, by its config's ``arch``."""

from __future__ import annotations

from torch import nn

from .codetalker import CodeTalker
from .vq_vae import VQAutoEncoder, VQSpeakerAutoEncoder


def get_model(cfg) -> nn.Module:
    """The model named by ``cfg.arch`` (``models/__init__.py:17`` of the
    JAX package, the reference's ``models/__init__.get_model``)."""
    if cfg.arch == "stage1_BIWI":
        return VQAutoEncoder(cfg)
    if cfg.arch == "stage1_vocaset":
        return VQAutoEncoder(cfg, variant="vocaset")
    if cfg.arch in ("stage1_speaker_BIWI", "stage1_BIWI_speaker"):
        return VQSpeakerAutoEncoder(cfg)
    if cfg.arch == "stage2":
        return CodeTalker(cfg)
    raise ValueError(f"unknown arch: {cfg.arch}")
