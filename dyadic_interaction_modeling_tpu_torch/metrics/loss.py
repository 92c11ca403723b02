"""Training losses of the VQ-VAEs and the SLM family (reference
metrics/loss.py:6-27, seq2seq_pretrain.py:256-268).

A copy of ``calc_vq_loss``, ``calc_vq_loss_AV``, ``calc_logit_loss`` and
``pairwise_distance_loss`` from
``dyadic_interaction_modeling_tpu/metrics/loss.py:17-78``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def calc_vq_loss(pred: torch.Tensor, target: torch.Tensor, quant_loss: torch.Tensor,
                 quant_loss_weight: float = 1.0
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """L1 reconstruction + weighted quantization loss: (total, (rec, quant))."""
    rec_loss = (pred - target).abs().mean()
    quant_loss = quant_loss.mean()
    return quant_loss * quant_loss_weight + rec_loss, (rec_loss, quant_loss)


def calc_vq_loss_AV(pred: torch.Tensor, target: torch.Tensor, quant_loss: torch.Tensor,
                    quant_loss_weight: float = 1.0, motion_dim: int = 56
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The audio-visual split: separate L1 terms for the ``motion_dim``
    motion and the audio slices, summed."""
    rec_loss = ((pred[..., :motion_dim] - target[..., :motion_dim]).abs().mean()
                + (pred[..., motion_dim:] - target[..., motion_dim:]).abs().mean())
    quant_loss = quant_loss.mean()
    return quant_loss * quant_loss_weight + rec_loss, (rec_loss, quant_loss)


def calc_logit_loss(pred: torch.Tensor, target: torch.Tensor,
                    ignore_index: Optional[int] = None) -> torch.Tensor:
    """Cross entropy over flattened logits, in fp32; with ``ignore_index``
    the mean over the kept targets (torch's ``F.cross_entropy`` semantics,
    0 rather than NaN when none is kept)."""
    v = pred.shape[-1]
    labels = target.reshape(-1)
    lp = torch.log_softmax(pred.reshape(-1, v).float(), dim=-1)
    nll = -torch.gather(lp, 1, labels.clamp(0, v - 1).long()[:, None])[:, 0]
    if ignore_index is None:
        return nll.mean()
    keep = (labels != ignore_index).float()
    return (nll * keep).sum() / keep.sum().clamp_min(1.0)


def pairwise_distance_loss(pred: torch.Tensor, target: torch.Tensor,
                           mask: torch.Tensor, pose_dims: int = 6) -> torch.Tensor:
    """Masked mean L2-norm loss, pose and expression apart, summed.

    ``pred``/``target`` (N, C) are aligned frames and ``mask`` (N,) marks the
    frames that count. As torch's ``F.pairwise_distance``, eps = 1e-6 is
    added to the signed difference before the norm."""
    diff = pred - target + 1e-6
    d_pose = diff[..., :pose_dims].square().sum(dim=-1).sqrt()
    d_exp = diff[..., pose_dims:].square().sum(dim=-1).sqrt()
    m = mask.float()
    denom = m.sum().clamp_min(1.0)
    return (d_exp * m).sum() / denom + (d_pose * m).sum() / denom
