"""Render evaluation metrics (reference ``Pirender/trainers/base.py:472-485``,
LPIPS tracking).

Counterpart of ``dyadic_interaction_modeling_tpu/render/metrics.py``:
``PerceptualDistance`` takes unit-normalised VGG19 feature differences
averaged over layers and space, which is LPIPS with uniform linear weights;
with the lpips package's learned linear weights (``lpips_lin_to_weights``)
it is LPIPS itself.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .perceptual import VGG19Features, apply_imagenet_normalization, load_trunk_state_dict

LPIPS_LAYERS = ("relu_1_2", "relu_2_2", "relu_3_4", "relu_4_4", "relu_5_4")


def lpips_lin_to_weights(state_dict: Mapping, layers: Sequence[str] = LPIPS_LAYERS
                         ) -> Dict[str, torch.Tensor]:
    """The lpips package's learned per-layer linear weights.

    The lpips checkpoint stores one 1x1 conv a tap as ``lin{i}.model.1.weight``
    of shape (1, C, 1, 1) (also ``lins.{i}.model.1.weight``, the ModuleList
    spelling). Returns ``{layer_name: (C,)}`` for
    ``PerceptualDistance(lin_weights=...)``. Every lin weight must be
    consumed and every layer covered."""
    found: Dict[int, torch.Tensor] = {}
    leftover = []
    for k, v in state_dict.items():
        parts = k.split(".")
        if (len(parts) == 4 and parts[0].startswith("lin")
                and parts[1:] == ["model", "1", "weight"]):
            idx = int(parts[0][3:])
        elif len(parts) == 5 and parts[0] == "lins" and parts[2:] == ["model", "1", "weight"]:
            idx = int(parts[1])
        else:
            leftover.append(k)
            continue
        arr = torch.as_tensor(np.asarray(v.detach().cpu() if hasattr(v, "detach") else v),
                              dtype=torch.float32)
        if arr.ndim != 4 or arr.shape[0] != 1 or tuple(arr.shape[2:]) != (1, 1):
            raise ValueError(f"{k}: expected (1, C, 1, 1), got {tuple(arr.shape)}")
        found[idx] = arr.reshape(-1)
    if leftover:
        raise KeyError(f"unrecognized lpips keys: {sorted(leftover)[:8]}")
    if sorted(found) != list(range(len(layers))):
        raise KeyError(f"expected lin0..lin{len(layers) - 1}, got {sorted(found)}")
    return {name: found[i] for i, name in enumerate(layers)}


class PerceptualDistance(torch.nn.Module):
    """LPIPS-style distance between NCHW image batches in [-1, 1] -> (B,).
    ``state_dict``: torchvision vgg19 weights (random init without)."""

    def __init__(self, state_dict: Optional[Mapping] = None,
                 layers: Sequence[str] = LPIPS_LAYERS,
                 lin_weights: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.layers = list(layers)
        self.model = VGG19Features(self.layers)
        if state_dict is not None:
            load_trunk_state_dict(self.model, state_dict)
        self.lin_weights = dict(lin_weights or {})

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fa = self.model(apply_imagenet_normalization(a))
        fb = self.model(apply_imagenet_normalization(b))
        total = a.new_zeros(a.shape[0])
        for name in self.layers:
            xa = fa[name] / fa[name].norm(dim=1, keepdim=True).clamp_min(1e-10)
            xb = fb[name] / fb[name].norm(dim=1, keepdim=True).clamp_min(1e-10)
            d = (xa - xb).square()
            if name in self.lin_weights:
                w = self.lin_weights[name].to(d.device, d.dtype).view(1, -1, 1, 1)
                total = total + (d * w).sum(1).mean((1, 2))
            else:
                total = total + d.mean((1, 2, 3))
        return total
