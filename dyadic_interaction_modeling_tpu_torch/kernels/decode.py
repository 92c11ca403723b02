"""K1: single-step decode attention (``csrc/decode_attention.cu``) and its
plain version.

Replaces ``dyadic_interaction_modeling_tpu/ops/pallas/decode.py:129``
``decode_attention``. See the CUDA source for the design and its bound.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import LAUNCHES
from .build import extension

Step = Union[int, torch.Tensor, None]
MAX_NQ = 256  # query rows a cache row (DECODE_MAX_NQ in csrc/kernels.h)
KERNEL_D = (64, 128)


def _expand_mask(key_mask: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows // m, L) -> (rows, L): mask row i serves cache rows
    [i*m, (i+1)*m)."""
    return key_mask.bool().repeat_interleave(rows // key_mask.shape[0], dim=0)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           t: Step = None,
                           key_mask: Optional[torch.Tensor] = None, *,
                           scale: float) -> torch.Tensor:
    """The dense step of the JAX package (``models/xtrans.py:259-267`` and
    ``:340-349``): fp32 scores, keys ``<= t`` when bounded, key mask, softmax,
    zeros for a fully masked row, probabilities cast to v's dtype, fp32
    accumulation, result in q's dtype."""
    rows, _, l = q.shape[0], q.shape[1], k.shape[1]
    dots = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    keep = torch.ones(1, 1, l, dtype=torch.bool, device=q.device)
    if t is not None:
        keep = keep & (torch.arange(l, device=q.device) <= t)[None, None, :]
    if key_mask is not None:
        keep = keep & _expand_mask(key_mask, rows)[:, None, :]
    dots = dots.masked_fill(~keep, float("-inf"))
    attn = torch.softmax(dots, dim=-1)
    attn = torch.where(torch.isfinite(dots).any(dim=-1, keepdim=True), attn,
                       torch.zeros((), device=q.device))
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _kernel(q, k, v, t: Step, key_mask, scale: float) -> torch.Tensor:
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("decode_attention: q, k, v must share a dtype of "
                         f"float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("decode_attention: q (R, NQ, D), k and v (R, L, D), got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    rows, nq, d = q.shape
    l = k.shape[1]
    if k.shape[0] != rows or k.shape[2] != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be a contiguous, "
                             "16-byte aligned tensor on q's device")
    if key_mask is not None:
        if (key_mask.dim() != 2 or key_mask.shape[1] != l
                or rows % key_mask.shape[0] or key_mask.device != q.device):
            raise ValueError("decode_attention: key_mask must be (R // m, L) on "
                             f"q's device, got {tuple(key_mask.shape)}")
        if key_mask.dtype not in (torch.bool, torch.uint8) or not key_mask.is_contiguous():
            raise ValueError("decode_attention: key_mask must be a contiguous "
                             f"bool or uint8 tensor, got {key_mask.dtype}")
    t_tensor, t_val = None, l - 1
    if isinstance(t, torch.Tensor):
        if t.numel() != 1 or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError("decode_attention: a tensor t must be a one-element "
                             f"int32 tensor on q's device, got {t.dtype} {t.device}")
        t_tensor = t
    elif t is not None:
        t_val = int(t)
    out = extension().decode_attention(q, k, v, key_mask, t_tensor, t_val, float(scale))
    LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     t: Step = None, key_mask: Optional[torch.Tensor] = None, *,
                     scale: float) -> torch.Tensor:
    """Single-step attention of NQ query rows per cache row.

    q: (R, NQ, D); k, v: (R, L, D), float32 or bfloat16; t: attend to keys
    ``<= t`` (a Python int or a one-element int32 tensor on the device;
    ``None`` attends to all L); key_mask: (R, L), or (R // m, L) shared by m
    consecutive cache rows, True = attend. Returns (R, NQ, D) in q's dtype; a
    fully masked row gives 0. On every device NQ is at most ``MAX_NQ`` and D
    one of ``KERNEL_D``, the kernel's limits. CUDA tensors run the kernel,
    CPU tensors the plain version.
    """
    if q.dim() == 3 and q.shape[1] > MAX_NQ:
        raise ValueError(f"decode_attention: NQ={q.shape[1]} query rows a cache row, "
                         f"at most {MAX_NQ}")
    if q.dim() == 3 and q.shape[2] not in KERNEL_D:
        raise ValueError(f"decode_attention: the kernel takes D in {KERNEL_D} "
                         f"(so D % 8 == 0), got D={q.shape[2]}")
    if q.device.type == "cuda":
        return _kernel(q, k, v, t, key_mask, scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, t, key_mask, scale=scale)
    raise ValueError(f"decode_attention: unsupported device {q.device}")
