"""K6: the expert layer's routing, dispatch and combine
(``csrc/moe_route.cu``) and their plain versions.

Replaces no TPU kernel: the JAX package has no mixture of experts. It is the
data path around the grouped expert GEMMs of DeepSeek-V2's expert layer
(``models/deepseek_v2.MoE``): the router (fp32 softmax over the gate logits,
greedy top-k, ties to the lower expert), the (token, expert) pairs grouped
by expert with each expert's end, the routed rows, and after the experts
the weighted fp32 sum of each token's rows plus the shared experts' output.
See the CUDA source for the design and its bound.

The gate logits stay the fp32 product ``F.linear(x.float(), gate.float())``
on both devices (``router_logits``): the kernel takes them, so the card routes
on the very logits the plain version does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES
from .build import extension

MAX_EXPERTS, MAX_K = 256, 8  # MOE_MAX_EXPERTS, MOE_MAX_K in csrc/kernels.h

Dispatch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def router_logits(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(N, E) fp32 gate logits: x's rows times the gate rows, in fp32."""
    return F.linear(x.float(), gate.float())


def moe_dispatch_plain(x: torch.Tensor, gate: torch.Tensor, k: int, norm_topk: bool,
                       scaling: float, load: Optional[torch.Tensor] = None) -> Dispatch:
    """``moe_dispatch`` by stable sorts: of each token's scores (the top k,
    ties to the lower expert), then of the pairs by expert."""
    w, ids = router_logits(x, gate).softmax(dim=-1).sort(dim=-1, descending=True,
                                                         stable=True)
    w, ids = w[:, :k], ids[:, :k].to(torch.int32)
    if k > 1 and norm_topk:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * scaling
    flat = ids.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    experts = torch.arange(gate.shape[0], device=x.device)
    ends = torch.searchsorted(flat[order], experts, right=True)
    if load is not None:
        load.add_(torch.diff(ends, prepend=ends.new_zeros(1)))
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=x.device)
    return (w, ids, ends.to(torch.int32), pos.view(ids.shape).to(torch.int32),
            x[order // k])


def moe_combine_plain(ys: torch.Tensor, w: torch.Tensor, pos: torch.Tensor,
                      shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``moe_combine``: fp32 products summed in slot order, in ys' dtype,
    then the shared rows added in fp32 and rounded once."""
    acc = torch.zeros(w.shape[0], ys.shape[1], dtype=torch.float32, device=ys.device)
    for j in range(w.shape[1]):
        acc = acc + w[:, j: j + 1] * ys[pos[:, j].long()].float()
    y = acc.to(ys.dtype)
    if shared is not None:
        y = (y.float() + shared.float()).to(ys.dtype)
    return y


def _rows(name: str, t: torch.Tensor, device) -> None:
    if (t.dim() != 2 or t.dtype != torch.bfloat16 or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16 or t.shape[1] % 8):
        raise ValueError(f"moe_route: {name} must be contiguous, 16-byte aligned (N, H) "
                         f"bfloat16 rows with H a multiple of 8 on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")


def _dispatch_kernel(x, gate, k, norm_topk, scaling, load) -> Dispatch:
    _rows("x", x, x.device)
    n_experts = gate.shape[0]
    if gate.dim() != 2 or gate.shape[1] != x.shape[1] or n_experts > MAX_EXPERTS:
        raise ValueError(f"moe_dispatch: the kernel takes a gate of (E <= {MAX_EXPERTS}, "
                         f"{x.shape[1]}), got {tuple(gate.shape)}")
    if not 1 <= k <= min(MAX_K, n_experts) or x.shape[0] * k >= 2 ** 31:
        raise ValueError(f"moe_dispatch: the kernel takes 1 <= k <= {MAX_K} of {n_experts} "
                         f"experts and under 2^31 pairs, got k {k} over {x.shape[0]} rows")
    if load is not None and (load.shape != (n_experts,) or load.dtype != torch.int64
                             or load.device != x.device or not load.is_contiguous()):
        raise ValueError(f"moe_dispatch: load must be a contiguous ({n_experts},) int64 "
                         f"tensor on {x.device}")
    out = extension().moe_dispatch(router_logits(x, gate), x, k, bool(norm_topk),
                                   float(scaling), load)
    LAUNCHES["moe_dispatch"] += 1
    return tuple(out)


def _combine_kernel(ys, w, pos, shared) -> torch.Tensor:
    _rows("ys", ys, ys.device)
    n, k = w.shape
    if (w.dtype != torch.float32 or pos.dtype != torch.int32 or pos.shape != w.shape
            or not 1 <= k <= MAX_K or ys.shape[0] != n * k
            or any(t.device != ys.device or not t.is_contiguous() for t in (w, pos))):
        raise ValueError(f"moe_combine: the kernel takes w (N, k <= {MAX_K}) fp32 and pos "
                         "(N, k) int32 as moe_dispatch gives them, over ys (N k, H), got "
                         f"{tuple(w.shape)} {w.dtype}, {tuple(pos.shape)} {pos.dtype}, "
                         f"{tuple(ys.shape)}")
    if shared is not None:
        _rows("shared", shared, ys.device)
        if shared.shape != (n, ys.shape[1]):
            raise ValueError(f"moe_combine: shared must be ({n}, {ys.shape[1]}), got "
                             f"{tuple(shared.shape)}")
    y = extension().moe_combine(ys, w, pos, shared)
    LAUNCHES["moe_combine"] += 1
    return y


def moe_dispatch(x: torch.Tensor, gate: torch.Tensor, k: int, norm_topk: bool,
                 scaling: float, load: Optional[torch.Tensor] = None) -> Dispatch:
    """The routing of x (N, H) by the gate rows (E, H), and x's rows grouped
    by expert.

    Returns w (N, k) fp32 and ids (N, k) int32 (the greedy top-k of the
    softmax of ``router_logits``, ties to the lower expert, in order of
    score; normalised over the k when ``norm_topk`` and k > 1, then times
    ``scaling``), ends (E,) int32 (expert e's pairs end at ends[e]:
    ``torch._grouped_mm``'s ``offs``), pos (N, k) int32 (the row of each
    pair in the grouped order) and xs (N k, H) (x's rows in that order,
    token order within each expert). ``load`` (E,) int64, when given, gains each expert's count.
    CUDA tensors run the kernel (bf16 rows, H a multiple of 8, E <= 256, k
    <= 8; it raises on any other) with no host sync, so it can be captured
    in a CUDA graph; CPU tensors run the plain version."""
    if x.device.type == "cuda":
        return _dispatch_kernel(x, gate, k, norm_topk, scaling, load)
    if x.device.type == "cpu":
        return moe_dispatch_plain(x, gate, k, norm_topk, scaling, load)
    raise ValueError(f"moe_dispatch: unsupported device {x.device}")


def moe_combine(ys: torch.Tensor, w: torch.Tensor, pos: torch.Tensor,
                shared: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (N, H) in ys' dtype: each token's expert rows ``ys[pos[n, j]]``
    weighted by ``w[n, j]`` and summed in fp32 in slot order, rounded, then
    ``shared`` (N, H), when given, added in fp32 and rounded once. w and pos
    are ``moe_dispatch``'s. CUDA tensors run the kernel (bf16 rows, H a
    multiple of 8, k <= 8; it raises on any other); CPU tensors run the plain
    version."""
    if ys.device.type == "cuda":
        return _combine_kernel(ys, w, pos, shared)
    if ys.device.type == "cpu":
        return moe_combine_plain(ys, w, pos, shared)
    raise ValueError(f"moe_combine: unsupported device {ys.device}")
