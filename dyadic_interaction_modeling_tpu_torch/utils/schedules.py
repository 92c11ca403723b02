"""Learning-rate schedules.

Counterpart of ``dyadic_interaction_modeling_tpu/utils/schedules.py:14-50``
(reference ``base/baseTrainer.py:10-19``): the reference's two policies as
plain functions, and ``make_lr_schedule``, the JAX package's optax schedule
as a factor of the base rate that ``torch.optim.lr_scheduler.LambdaLR`` takes:
``LambdaLR(opt, make_lr_schedule("poly", max_iter=n))`` on an optimizer built
with ``lr=base_lr`` sets ``base_lr * factor(step)``, the JAX schedule's value
at that step.
"""

from __future__ import annotations

from typing import Callable


def step_learning_rate(base_lr: float, epoch: int, step_epoch: int,
                       multiplier: float = 0.1) -> float:
    return base_lr * (multiplier ** (epoch // step_epoch))


def poly_learning_rate(base_lr: float, curr_iter: int, max_iter: int,
                       power: float = 0.9) -> float:
    """Poly LR policy (baseTrainer.py:15-18)."""
    return base_lr * (1 - float(curr_iter) / max_iter) ** power


def make_lr_schedule(kind: str, *, max_iter: int = 1, power: float = 0.9,
                     step_size: int = 1, gamma: float = 0.5,
                     warmup_steps: int = 0) -> Callable[[int], float]:
    """step -> factor of the base rate. ``kind``: 'constant' | 'poly' |
    'step'. ``warmup_steps`` > 1 prepends a linear warmup from 0, after which
    the schedule restarts its count (optax ``join_schedules``). Past
    ``max_iter`` the poly factor is 0, where the JAX schedule gives NaN."""
    if kind == "constant":
        def sched(step):
            return 1.0
    elif kind == "poly":
        def sched(step):
            return max(0.0, 1 - step / max_iter) ** power
    elif kind == "step":
        def sched(step):
            return gamma ** (step // step_size)
    else:
        raise ValueError(f"unknown schedule kind: {kind}")
    if not (warmup_steps and warmup_steps > 1):
        return sched

    def warmed(step):
        return step / warmup_steps if step < warmup_steps else sched(step - warmup_steps)

    return warmed
