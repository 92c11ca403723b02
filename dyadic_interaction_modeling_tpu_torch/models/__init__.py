"""The port's models. ``get_model`` builds a stage-1 tokenizer by its
config's ``arch``."""

from __future__ import annotations

from torch import nn

from .vq_vae import VQAutoEncoder, VQSpeakerAutoEncoder


def get_model(cfg) -> nn.Module:
    """The tokenizer named by ``cfg.arch`` (``models/__init__.py:17`` of the
    JAX package, the reference's ``models/__init__.get_model``)."""
    if cfg.arch == "stage1_BIWI":
        return VQAutoEncoder(cfg)
    if cfg.arch in ("stage1_speaker_BIWI", "stage1_BIWI_speaker"):
        return VQSpeakerAutoEncoder(cfg)
    if cfg.arch in ("stage1_vocaset", "stage2"):
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (ROADMAP.md, queue 1: the rest of "
            "the VQ family; the speaker and speech path)")
    raise ValueError(f"unknown arch: {cfg.arch}")
