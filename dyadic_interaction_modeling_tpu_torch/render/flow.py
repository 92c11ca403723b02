"""Flow-field warping (reference ``Pirender/util/flow_util.py:3-56``).

Counterpart of ``dyadic_interaction_modeling_tpu/render/flow.py`` on NCHW
tensors. ``convert_flow_to_deformation`` turns pixel flow into [-1, 1]
offsets on the identity grid; ``warp_image`` resizes the deformation to the
image bilinearly where it is smaller and samples the source there with
``grid_sample`` (bilinear, zero padding, ``align_corners=False``).

Reference quirk, kept: the grid is built with align-corners coordinates,
``2 i / (w - 1) - 1``, but sampled with ``align_corners=False``, so zero flow
is not an identity warp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_coordinate_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity grid in [-1, 1], (h, w, 2) ordered (x, y)."""
    x = 2 * (torch.arange(w, dtype=dtype, device=device) / (w - 1)) - 1
    y = 2 * (torch.arange(h, dtype=dtype, device=device) / (h - 1)) - 1
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def convert_flow_to_deformation(flow: torch.Tensor) -> torch.Tensor:
    """flow (B, 2, H, W) pixel offsets (x, y) -> sampling grid (B, H, W, 2)."""
    _, _, h, w = flow.shape
    flow_norm = 2 * torch.cat([flow[:, :1] / (w - 1), flow[:, 1:] / (h - 1)], dim=1)
    grid = make_coordinate_grid(h, w, flow.dtype, flow.device)
    return grid[None] + flow_norm.permute(0, 2, 3, 1)


def warp_image(source_image: torch.Tensor, deformation: torch.Tensor) -> torch.Tensor:
    """source (B, C, H, W); deformation (B, Hd, Wd, 2), resized bilinearly to
    (H, W) when it differs (flow_util.py:50-56)."""
    h, w = source_image.shape[2:]
    if deformation.shape[1:3] != (h, w):
        deformation = F.interpolate(deformation.permute(0, 3, 1, 2), size=(h, w),
                                    mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    return F.grid_sample(source_image, deformation, mode="bilinear", padding_mode="zeros",
                         align_corners=False)
