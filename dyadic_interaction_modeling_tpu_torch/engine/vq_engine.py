"""VQ-VAE tokenizer training (reference train_vq.py:133-263).

Counterpart of ``dyadic_interaction_modeling_tpu/engine/vq_engine.py:27-115``:
one step is the VQ-VAE's forward, the L1 reconstruction plus the weighted
quantization loss (``metrics.loss.calc_vq_loss``, or with ``audio_visual``
the speaker VQ's split motion + audio loss ``calc_vq_loss_AV``), backward
and an optimizer step (AdamW from ``engine.train_state.make_optimizer``).
The loop reads the card's metrics back once per print window, not every
step, into ``AverageMeter``s, and writes them to a ``MetricsWriter`` with the
reference's batch tags (train_vq.py:230-233).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional

import torch

from ..metrics.loss import calc_vq_loss, calc_vq_loss_AV
from ..utils.logging import AverageMeter

log = logging.getLogger(__name__)
METRICS = ("loss", "rec_loss", "quant_loss", "perplexity")


def _metrics(model, batch, quant_loss_weight, audio_visual):
    dec, emb_loss, enc = model(batch)
    loss = calc_vq_loss_AV if audio_visual else calc_vq_loss
    total, (rec, quant) = loss(dec, batch, emb_loss, quant_loss_weight)
    return total, {"loss": total, "rec_loss": rec, "quant_loss": quant,
                   "perplexity": enc.perplexity}


def make_vq_train_step(model, optimizer: torch.optim.Optimizer,
                       quant_loss_weight: float = 1.0, audio_visual: bool = False
                       ) -> Callable:
    """batch (B, L, C) -> metrics: one optimizer step. The metrics are
    detached device tensors, so a step never waits for the card.
    ``audio_visual`` takes the speaker VQ's split loss."""

    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        total, metrics = _metrics(model, batch, quant_loss_weight, audio_visual)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_vq_eval_step(model, quant_loss_weight: float = 1.0,
                      audio_visual: bool = False) -> Callable:
    """batch -> metrics, without gradients."""

    @torch.no_grad()
    def step(batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        return _metrics(model, batch, quant_loss_weight, audio_visual)[1]

    return step


def train_epoch(loader: Iterable, train_step: Callable, epoch: int = 0,
                print_freq: int = 500, writer=None, step_offset: int = 0,
                lr: Optional[float] = None) -> Dict[str, float]:
    """One pass over ``loader``'s batches (train_vq.train's loop): the meters
    read the metrics every ``print_freq`` steps, the only times the host waits
    for the card, and there the log line is written and, with a ``writer``
    (``utils.observability.MetricsWriter``), the batch scalars at global step
    ``step_offset + i + 1``: ``train_batch/loss`` (the reconstruction loss),
    ``train_batch/loss_2`` (the quantization loss) and, given ``lr``,
    ``learning_rate``. Returns the last step's metrics."""
    meters = {k: AverageMeter() for k in METRICS}
    metrics = None
    for i, batch in enumerate(loader):
        metrics = train_step(batch)
        if (i + 1) % print_freq == 0:
            for k in METRICS:
                meters[k].update(float(metrics[k]))
            log.info("Epoch %d iter %d: loss %.4f rec %.4f quant %.4f ppl %.1f", epoch, i + 1,
                     *(meters[k].val for k in METRICS))
            if writer is not None:
                step = step_offset + i + 1
                writer.add_scalar("train_batch/loss", meters["rec_loss"].val, step)
                writer.add_scalar("train_batch/loss_2", meters["quant_loss"].val, step)
                if lr is not None:
                    writer.add_scalar("learning_rate", lr, step)
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
