"""Optimizer with frozen submodules and global-norm clipping.

Counterpart of ``dyadic_interaction_modeling_tpu/engine/train_state.py:45-91``
(``make_optimizer``, ``create_train_state``). The JAX package freezes by an
``optax.multi_transform`` mask; here, as in the reference, frozen parameters
get ``requires_grad_(False)`` and stay out of the optimizer. optax clips
inside the "train" partition, so the global norm runs over the trainable
parameters only, as ``clip_by_global_norm`` computes it: every gradient
times ``max_norm / norm`` when ``norm > max_norm`` (torch's
``clip_grad_norm_`` divides by ``norm + 1e-6`` instead).
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn


def make_optimizer(model: nn.Module, learning_rate: float, weight_decay: float = 0.0,
                   frozen_prefixes: Iterable[str] = ()) -> torch.optim.AdamW:
    """``requires_grad_(False)`` on every parameter under one of the module
    prefixes, then AdamW (betas 0.9/0.999, eps 1e-8; Adam when
    ``weight_decay`` is 0) over the parameters left trainable."""
    prefixes = tuple(frozen_prefixes)
    trainable = []
    for name, p in model.named_parameters():
        if any(name == f or name.startswith(f + ".") for f in prefixes):
            p.requires_grad_(False)
        else:
            trainable.append(p)
    return torch.optim.AdamW(trainable, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the gradients of ``params``, in
    place and without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
