"""K5: latent (MLA) decode attention (``csrc/latent_decode.cu``) and its
plain version.

Replaces no TPU kernel: the JAX package has no latent attention. It is the
attention of DeepSeek-V2's absorbed decode step (``models/deepseek_v2.py``):
16 query rows a cache row, keys 576 wide (512 latent || 64 rope), values the
first 512 of the same row. See the CUDA source for the design and its
bound.
"""

from __future__ import annotations

from typing import Union

import torch

from . import LAUNCHES
from .build import extension

Step = Union[int, torch.Tensor, None]
HEADS, DK, DV = 16, 576, 512  # LATENT_HEADS, LATENT_DK, LATENT_DV in csrc/kernels.h


def latent_decode_plain(q: torch.Tensor, cache: torch.Tensor, t: Step = None, *,
                        scale: float, dv: int = DV) -> torch.Tensor:
    """fp32 scores of q (R, NQ, Dk) against cache (R, L, Dk) at positions
    ``<= t`` (all L when None), softmax, probabilities cast to the cache's
    dtype, fp32 sum of the rows' first ``dv`` values, result in q's dtype."""
    l = cache.shape[1]
    dots = torch.matmul(q.float(), cache.float().transpose(1, 2)) * scale
    if t is not None:
        keep = torch.arange(l, device=q.device) <= t
        dots = dots.masked_fill(~keep, float("-inf"))
    attn = torch.softmax(dots, dim=-1)
    out = torch.matmul(attn.to(cache.dtype).float(), cache[..., :dv].float())
    return out.to(q.dtype)


def _kernel(q: torch.Tensor, cache: torch.Tensor, t: Step, scale: float, dv: int) -> torch.Tensor:
    if (q.dim() != 3 or cache.dim() != 3 or q.shape[1:] != (HEADS, DK)
            or cache.shape[2] != DK or cache.shape[0] != q.shape[0] or dv != DV):
        raise ValueError(f"latent_decode: the kernel takes q (R, {HEADS}, {DK}), cache (R, L, "
                         f"{DK}) and dv {DV}, got {tuple(q.shape)} {tuple(cache.shape)} dv {dv}")
    if q.dtype != torch.bfloat16 or cache.dtype != torch.bfloat16:
        raise ValueError(f"latent_decode: q and cache must be bfloat16, got {q.dtype}/{cache.dtype}")
    for name, x in (("q", q), ("cache", cache)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"latent_decode: {name} must be a contiguous, 16-byte aligned "
                             "tensor on q's device")
    t_tensor, t_val = None, cache.shape[1] - 1
    if isinstance(t, torch.Tensor):
        if t.numel() != 1 or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError("latent_decode: a tensor t must be a one-element int32 tensor "
                             f"on q's device, got {t.dtype} {t.device}")
        t_tensor = t
    elif t is not None:
        t_val = int(t)
    out = extension().latent_decode(q, cache, t_tensor, t_val, float(scale))
    LAUNCHES["latent_decode"] += 1
    return out


def latent_decode(q: torch.Tensor, cache: torch.Tensor, t: Step = None, *,
                  scale: float, dv: int = DV) -> torch.Tensor:
    """softmax(q cacheᵀ · scale) cache[..., :dv] over the positions ``<= t``.

    q: (R, NQ, Dk); cache: (R, L, Dk); t: a Python int or a one-element
    int32 tensor on the device (``None`` attends to all L). Returns (R, NQ,
    dv) in q's dtype. CUDA tensors run the kernel, which takes the published
    widths alone (NQ 16, Dk 576, dv 512, bfloat16) and raises on any other;
    CPU tensors run the plain version at any widths and float dtype."""
    if q.device.type == "cuda":
        return _kernel(q, cache, t, scale, dv)
    if q.device.type == "cpu":
        return latent_decode_plain(q, cache, t, scale=scale, dv=dv)
    raise ValueError(f"latent_decode: unsupported device {q.device}")
