"""K2/K3: flash attention forward and backward and their plain versions.

Replaces ``dyadic_interaction_modeling_tpu/ops/pallas/attention.py``:
``_fwd`` (:111) and ``_bwd`` (:152), bound together by the custom VJP of
``flash_attention`` (:194-213). On the card bf16 tensors run the kernels of
``csrc/flash_attention_mma.cu`` and fp32 tensors those of
``csrc/flash_attention.cu``, both on the tensor cores (the binding picks by
dtype); see the sources for the designs and their bounds. The bf16 backward
rounds P and dS to bf16 as operands of its products, which the plain version
keeps in fp32; the fp32 kernels split every operand into two TF32 terms and
multiply in three products (3xTF32), which keeps them within 1e-5 of it.

Rows are batch x head: q, k, v are (R, L, D). A key mask is (R // m, L),
True = attend, shared by m consecutive rows (m = heads), as K1 takes it. A
query row whose keys are all masked gets 0 output, lse = +inf and exactly 0
gradients, as the JAX package's dense path (``models/xtrans.py:216``) gives;
the Pallas kernel returns the mean of v there instead (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import LAUNCHES
from .build import extension

INF = float("inf")


def _keep(q: torch.Tensor, key_mask: Optional[torch.Tensor], causal: bool
          ) -> Optional[torch.Tensor]:
    """Which keys each query row attends, broadcastable to (R, L, L); None
    when all of them."""
    rows, l = q.shape[0], q.shape[1]
    keep = None
    if key_mask is not None:
        keep = key_mask.bool().repeat_interleave(rows // key_mask.shape[0], dim=0)[:, None, :]
    if causal:
        tri = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()[None]
        keep = tri if keep is None else keep & tri
    return keep


def _scores(q, k, scale):
    return torch.matmul(q.float(), k.float().transpose(1, 2)) * scale


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_mask: Optional[torch.Tensor] = None, *,
                              causal: bool, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 scores, masks, softmax, probabilities cast to v's dtype, fp32 P.V,
    result in q's dtype; also the fp32 row lse (+inf for a fully masked row).
    Differentiable by autograd, with exactly 0 gradients through a fully
    masked row (its scores are set to 0, not -inf, before the softmax)."""
    s = _scores(q, k, scale)
    keep = _keep(q, key_mask, causal)
    if keep is None:
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
    else:
        live = keep.any(dim=-1)
        s = torch.where(keep, s, torch.where(live[..., None], -INF, 0.0))
        lse0 = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse0[..., None]) * keep
        lse = torch.where(live, lse0, INF)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                              key_mask: Optional[torch.Tensor] = None, *,
                              causal: bool, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv from the saved lse, as the Pallas body computes them
    (``attention.py:83-108``): P = exp(s - lse), dv = Pᵀ do,
    dS = P (do vᵀ - rowsum(do o)) scale, dq = dS k, dk = dSᵀ q; fp32 sums,
    results in the inputs' dtypes."""
    s = _scores(q, k, scale)
    keep = _keep(q, key_mask, causal)
    if keep is not None:
        s = s.masked_fill(~keep, -INF)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.transpose(1, 2), dof)
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# the head widths the kernels are built for: 64 and 128 for the SLM stack, 48
# for the listener VQ-VAE's 384 / 8, 96 for the speaker VQ-VAE's 768 / 8. The
# call sites route any other width to their dense path (``models/xtrans.py``,
# ``ops/transformer.py``), and every wrapper refuses it on every device.
KERNEL_D = (48, 64, 96, 128)


def _check(name: str, q: torch.Tensor, tensors, key_mask) -> None:
    if q.dim() != 3 or q.shape[2] not in KERNEL_D:
        raise ValueError(f"{name}: q must be (R, L, D) with D in {KERNEL_D}, got "
                         f"shape {tuple(q.shape)}" + (f", D = {q.shape[2]}" if q.dim() == 3
                                                      else ""))
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: at most 65535 rows, got {q.shape[0]}")
    for t_name, x in tensors:
        if x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{name}: {t_name} must match q's dtype and shape, got "
                             f"{x.dtype} {tuple(x.shape)} for q {q.dtype} {tuple(q.shape)}")
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be a contiguous, 16-byte "
                             "aligned tensor on q's device")
    if key_mask is not None:
        if (key_mask.dim() != 2 or key_mask.shape[1] != q.shape[1]
                or key_mask.shape[0] == 0 or q.shape[0] % key_mask.shape[0]
                or key_mask.device != q.device):
            raise ValueError(f"{name}: key_mask must be (R // m, L) on q's device, "
                             f"got {tuple(key_mask.shape)}")
        if key_mask.dtype not in (torch.bool, torch.uint8) or not key_mask.is_contiguous():
            raise ValueError(f"{name}: key_mask must be a contiguous bool or uint8 "
                             f"tensor, got {key_mask.dtype}")


def _dispatch(name: str, q: torch.Tensor) -> bool:
    """True for the kernels (a CUDA tensor), False for the plain version (a
    CPU tensor); any other device, and any dtype but float32 and bfloat16 on
    either, raises."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    return q.device.type == "cuda"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None, *, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (o in q's dtype, lse (R, L) fp32). CUDA tensors run the kernel,
    CPU tensors the plain version; both take only what the kernel takes."""
    on_card = _dispatch("flash_attention_fwd", q)
    _check("flash_attention_fwd", q, (("k", k), ("v", v)), key_mask)
    if not on_card:
        return flash_attention_fwd_plain(q, k, v, key_mask, causal=causal, scale=scale)
    o, lse = extension().flash_attention_fwd(q, k, v, key_mask, causal, float(scale))
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None, *, causal: bool,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: (dq, dk, dv) in the inputs' dtype, self-attention (Lq == Lk). CUDA
    tensors run the kernel, CPU tensors the plain version; both take only
    what the kernel takes."""
    on_card = _dispatch("flash_attention_bwd", q)
    _check("flash_attention_bwd", q, (("k", k), ("v", v), ("o", o), ("do", do)),
           key_mask)
    if (lse.dtype != torch.float32 or lse.shape != q.shape[:2]
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be a contiguous (R, L) "
                         f"float32 tensor on q's device, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if not on_card:
        return flash_attention_bwd_plain(q, k, v, o, do, lse, key_mask,
                                         causal=causal, scale=scale)
    grads = extension().flash_attention_bwd(q, k, v, o, do, lse, key_mask, causal,
                                            float(scale))
    LAUNCHES["flash_attention_bwd"] += 1
    return tuple(grads)


class FlashAttention(torch.autograd.Function):
    """K2 forward, K3 backward. ``custom_fwd``/``custom_bwd`` run the
    backward under the forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, key_mask, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, key_mask, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, key_mask)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, o, lse, key_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse, key_mask,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: Optional[torch.Tensor] = None, *,
                          causal: bool = False, scale: float) -> torch.Tensor:
    """The plain forward's output, differentiated by autograd."""
    return flash_attention_fwd_plain(q, k, v, key_mask, causal=causal, scale=scale)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False, scale: float) -> torch.Tensor:
    """Differentiable softmax(q kᵀ · scale) v over (R, L, D) rows, with an
    optional causal mask and a (R // m, L) key mask. CUDA tensors go through
    ``FlashAttention`` (K2 forward, K3 backward); CPU tensors through the
    plain forward, which autograd differentiates. Both take only what the
    kernels take (``_check``)."""
    on_card = _dispatch("flash_attention", q)
    _check("flash_attention", q, (("k", k), ("v", v)), key_mask)
    if on_card:
        return FlashAttention.apply(q, k, v, key_mask, causal, scale)
    return flash_attention_plain(q, k, v, key_mask, causal=causal, scale=scale)
