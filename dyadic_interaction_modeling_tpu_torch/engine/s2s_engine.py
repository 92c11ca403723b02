"""Training and evaluation loops of the seq2seq listener models (x_engine.py).

Counterpart of ``dyadic_interaction_modeling_tpu/engine/s2s_engine.py``:
``make_lg_train_step`` / ``train_epoch`` for ``ListenerGenerator`` batches
(src_v, tgt, mask, speaker_ids, listener_ids), ``make_continuous_train_step``
/ ``train_continuous_epoch`` / ``evaluate_continuous_epoch`` for
``ContinuousSeq2Seq`` batches (src, tgt, mask), and ``evaluate_epoch``: the
validation loss and the token perplexity over the targets that are not -100
(torcheval's ``Perplexity``, ``metrics.eval_utils.perplexity_from_logits``).
A step clips the trainable gradients to a global norm of ``clip_norm`` (none
when 0, the reference's setting) before the optimizer's step, and returns
its loss as a detached device tensor, so it never waits for the card.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..metrics.eval_utils import perplexity_from_logits
from ..models.xtrans import ar_inputs_targets
from .train_state import clip_by_global_norm

log = logging.getLogger(__name__)


def _step(optimizer: torch.optim.Optimizer, clip_norm: float, loss_fn: Callable) -> Callable:
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(*args) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(*args)
        loss.backward()
        if clip_norm > 0:
            clip_by_global_norm(params, clip_norm)
        optimizer.step()
        return loss.detach()

    return step


def make_lg_train_step(model, optimizer: torch.optim.Optimizer, clip_norm: float = 0.0,
                       use_ids: bool = False) -> Callable:
    """batch -> loss: one optimizer step of ``ListenerGenerator`` on (src_v,
    tgt, mask, speaker_ids, listener_ids), the ids used with ``use_ids``."""
    def loss_fn(batch):
        src, tgt, mask, sp, li = batch
        return model(src, tgt, mask, sp if use_ids else None,
                     li if use_ids else None).loss

    return _step(optimizer, clip_norm, loss_fn)


def train_epoch(loader: Iterable, step: Callable, epoch: int = 0,
                print_freq: int = 200) -> Optional[float]:
    """x_engine.train_epoch's loop (:8-36); the last step's loss."""
    loss = None
    for i, batch in enumerate(loader):
        loss = step(batch)
        if (i + 1) % print_freq == 0:
            log.info("Epoch %d batch %d: loss %.4f", epoch, i + 1, float(loss))
    return None if loss is None else float(loss)


def make_continuous_train_step(model, optimizer: torch.optim.Optimizer,
                               clip_norm: float = 0.0) -> Callable:
    """(src, tgt, mask) -> loss: one optimizer step of ``ContinuousSeq2Seq``,
    whose forward is its masked MSE (x_engine.train_continuous_epoch
    :38-62)."""
    return _step(optimizer, clip_norm, model)


def train_continuous_epoch(loader: Iterable, step: Callable, epoch: int = 0,
                           print_freq: int = 100) -> Optional[float]:
    """x_engine.train_continuous_epoch's loop: batches (src, tgt, mask), the
    mean loss logged every ``print_freq`` steps; the last step's loss."""
    losses = []
    for i, (src, tgt, mask) in enumerate(loader):
        losses.append(step(src, tgt, mask))
        if (i + 1) % print_freq == 0:
            log.info("Epoch %d batch %d: loss %.4f", epoch, i + 1,
                     float(torch.stack(losses).mean()))
            losses = []
    return float(losses[-1]) if losses else None


@torch.no_grad()
def evaluate_continuous_epoch(model, loader: Iterable) -> float:
    """Mean validation MSE (x_engine.evaluate_continuous_epoch :89-105)."""
    losses = [float(model(src, tgt, mask)) for src, tgt, mask in loader]
    return float(np.mean(losses)) if losses else float("nan")


@torch.no_grad()
def evaluate_epoch(model, loader: Iterable, use_ids: bool = False) -> Dict[str, float]:
    """Mean validation loss and token perplexity (x_engine.evaluate_epoch
    :64-88). The loss is the model's (with the ids under ``use_ids``); the
    perplexity that of the generator's logits without ids, over the
    listener codes that are not -100, as the JAX package computes it."""
    losses, ppls = [], []
    for src, tgt, mask, sp, li in loader:
        out = model(src, tgt, mask, sp if use_ids else None, li if use_ids else None)
        x_sp, z_li = model._encode_streams(src, tgt, mask)
        _, logits = model.generator(x_sp, z_li, mask, None)
        targets = ar_inputs_targets(z_li)[1]
        losses.append(float(out.loss))
        ppls.append(perplexity_from_logits(logits.float().cpu().numpy(),
                                           targets.cpu().numpy()))
    return {"loss": float(np.mean(losses)), "perplexity": float(np.mean(ppls))}
