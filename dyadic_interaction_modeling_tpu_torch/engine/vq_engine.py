"""VQ-VAE tokenizer training (reference train_vq.py:133-263).

Counterpart of ``dyadic_interaction_modeling_tpu/engine/vq_engine.py:27-115``:
one step is the VQ-VAE's forward, the L1 reconstruction plus the weighted
quantization loss (``metrics.loss.calc_vq_loss``), backward and an
optimizer step (AdamW from ``engine.train_state.make_optimizer``). The
loop reads the card's metrics back once per print window, not every step.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable

import torch

from ..metrics.loss import calc_vq_loss

log = logging.getLogger(__name__)
METRICS = ("loss", "rec_loss", "quant_loss", "perplexity")


def _metrics(model, batch, quant_loss_weight):
    dec, emb_loss, enc = model(batch)
    total, (rec, quant) = calc_vq_loss(dec, batch, emb_loss, quant_loss_weight)
    return total, {"loss": total, "rec_loss": rec, "quant_loss": quant,
                   "perplexity": enc.perplexity}


def make_vq_train_step(model, optimizer: torch.optim.Optimizer,
                       quant_loss_weight: float = 1.0) -> Callable:
    """batch (B, L, C) -> metrics: one optimizer step. The metrics are
    detached device tensors, so a step never waits for the card."""

    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        total, metrics = _metrics(model, batch, quant_loss_weight)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_vq_eval_step(model, quant_loss_weight: float = 1.0) -> Callable:
    """batch -> metrics, without gradients."""

    @torch.no_grad()
    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        return _metrics(model, batch, quant_loss_weight)[1]

    return step


def train_epoch(loader: Iterable, train_step: Callable, epoch: int = 0,
                print_freq: int = 500) -> Dict[str, float]:
    """One pass over ``loader``'s batches (train_vq.train's loop): the log
    line reads the metrics every ``print_freq`` steps, the only times the
    host waits for the card. Returns the last step's metrics."""
    metrics = None
    for i, batch in enumerate(loader):
        metrics = train_step(batch)
        if (i + 1) % print_freq == 0:
            log.info("Epoch %d iter %d: loss %.4f rec %.4f quant %.4f ppl %.1f", epoch, i + 1,
                     *(float(metrics[k]) for k in METRICS))
    return {} if metrics is None else {k: float(metrics[k]) for k in METRICS}


def validate(loader: Iterable, eval_step: Callable) -> Dict[str, float]:
    """Mean of the metrics over ``loader``'s batches (train_vq.validate)."""
    sums: Dict[str, float] = {}
    n = 0
    for batch in loader:
        for k, v in eval_step(batch).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}
