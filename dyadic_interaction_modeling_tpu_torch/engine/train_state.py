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


def freeze(model: nn.Module, frozen_prefixes: Iterable[str] = ()) -> list:
    """``requires_grad_(False)`` on every parameter under one of the module
    prefixes; returns the parameters left trainable. Freeze before a
    ``--mesh`` wrap (``parallel.MeshPlan.shard_state``), which reads it."""
    prefixes = tuple(frozen_prefixes)
    trainable = []
    for name, p in model.named_parameters():
        if any(name == f or name.startswith(f + ".") for f in prefixes):
            p.requires_grad_(False)
        else:
            trainable.append(p)
    return trainable


def make_optimizer(model: nn.Module, learning_rate: float, weight_decay: float = 0.0,
                   frozen_prefixes: Iterable[str] = ()) -> torch.optim.AdamW:
    """``freeze``, then AdamW (betas 0.9/0.999, eps 1e-8; Adam when
    ``weight_decay`` is 0) over the parameters left trainable. Under a
    tensor-parallel ``--mesh`` some parameters are DTensors and the rest
    plain tensors, which the foreach path cannot mix: there AdamW takes its
    per-parameter loop (the same arithmetic)."""
    trainable = freeze(model, frozen_prefixes)
    kinds = {_is_dtensor(p) for p in trainable}
    return torch.optim.AdamW(trainable, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay,
                             foreach=False if len(kinds) > 1 else None)


def _is_dtensor(t: torch.Tensor) -> bool:
    return type(t).__name__ == "DTensor"


@torch.no_grad()
def clip_by_global_norm(params: Iterable[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the gradients of ``params``, in
    place and without a host sync. Under a ``--mesh`` layout a sharded
    gradient (a DTensor, each placement ``Shard`` or ``Replicate``) adds the
    squares of its local part, weighted by its shard count over the world
    size, so one all-reduce of that sum gives the squares of every sharded
    gradient whole; each is then scaled in place."""
    grads = [p.grad for p in params if p.grad is not None]
    plain = [g for g in grads if not _is_dtensor(g)]
    sharded = [g for g in grads if _is_dtensor(g)]
    norms = list(torch._foreach_norm(plain)) if plain else []
    if sharded:
        import torch.distributed as dist

        world = dist.get_world_size()
        squares = sum(g.to_local().float().square().sum() * (_shard_count(g) / world)
                      for g in sharded)
        dist.all_reduce(squares)
        norms.append(squares.sqrt())
    scale = (max_norm / torch.linalg.vector_norm(torch.stack(norms))).clamp(max=1.0)
    if plain:
        torch._foreach_mul_(plain, scale)
    for g in sharded:
        g.to_local().mul_(scale)


def _shard_count(g) -> int:
    """The number of distinct pieces a DTensor is cut into over its mesh."""
    n = 1
    for dim, placement in enumerate(g.placements):
        if placement.is_shard():
            n *= g.device_mesh.size(dim)
    return n
