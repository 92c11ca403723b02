"""The continuous loss of the SLM family (seq2seq_pretrain.py:256-268).

A copy of ``pairwise_distance_loss`` from
``dyadic_interaction_modeling_tpu/metrics/loss.py:57-78``.
"""

from __future__ import annotations

import torch


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
