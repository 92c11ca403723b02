"""Seeded weights, made on the device in one draw.

Every parameter of a model is cut from one ``torch.randn`` of the run's
seed in the dtype it is served in, then scaled by a rule on its name and
shape: matrices and convolutions N(0, 1 / fan_in), token tables N(0, 1)
(``nn.Embedding``'s own init), position tables N(0, dim) (the model
scales them by dim ** -0.5, so a position weighs as a token does),
patch embeddings N(0, 0.02^2), norm scales 1 + N(0, 0.1^2), biases
N(0, 0.02^2), VQ codebooks N(0, 1). Buffers (sinusoid tables, zero norm
shifts) are the model's own. The same dict is loaded into the program with
``load_state_dict(strict=True)`` and handed to the reference."""

from __future__ import annotations

import math
from typing import Dict

import torch


def _scale(name: str, shape) -> tuple:
    """(std, mean) of a parameter."""
    if name.endswith("quantize.embedding.weight"):
        return 1.0, 0.0
    if name.endswith("pos_emb.emb.weight"):
        return math.sqrt(shape[1]), 0.0
    if name.endswith("emb.weight"):
        return 1.0, 0.0
    if "patch_embed" in name:
        return 0.02, 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if name.endswith("gamma") or ("norm" in name and name.endswith("weight")):
        return 0.1, 1.0
    return 0.02, 0.0


def seeded_params(model: torch.nn.Module, g: torch.Generator, dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor for every parameter of ``model``, on its device."""
    named = list(model.named_parameters())
    device = named[0][1].device
    total = sum(p.numel() for _, p in named)
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, i = {}, 0
    for name, p in named:
        std, mean = _scale(name, tuple(p.shape))
        out[name] = flat[i: i + p.numel()].view(p.shape).mul_(std).add_(mean)
        i += p.numel()
    return out


def load(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """The params and the model's own buffers, loaded strictly."""
    state = {k: v for k, v in model.state_dict().items() if k not in params}
    state.update(params)
    model.load_state_dict(state, strict=True)
