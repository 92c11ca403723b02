"""SLM training and best-of-N listener generation (x_engine_pt.py).

Counterpart of ``dyadic_interaction_modeling_tpu/engine/pt_engine.py``:

* ``make_slm_train_step``, ``train_epoch``, ``evaluate_epoch`` (:51-162):
  one optimizer step of the SLM pretraining loss or the SLMFT finetune loss,
  with global-norm clipping over the trainable parameters and, on the card,
  bf16 autocast over fp32 parameters (the counterpart of flax
  ``dtype=bfloat16`` with fp32 ``param_dtype``);
* ``evaluate_finetune_epoch`` (:165-187): SLMFT's teacher-forced
  predictions for the metric battery;
* ``make_slmft_generator`` (:195-318) runs the N resamples of every clip as
  ONE batched generate whose N*B0 rows share the B0 clips' cross-attention
  context (``context_groups``), then decodes the tokens to motion; the
  per-clip pick by Frechet distance happens on the host.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..metrics.eval_utils import (
    calculate_activation_statistics,
    calculate_frechet_distance,
)
from ..models.slm import SLMFT
from ..models.xtrans import generate_tokens
from .train_state import clip_by_global_norm

log = logging.getLogger(__name__)


def _autocast(device: torch.device, amp_dtype: Optional[torch.dtype]):
    return torch.autocast(device_type=device.type, dtype=amp_dtype,
                          enabled=amp_dtype is not None)


def make_slm_train_step(model, optimizer: torch.optim.Optimizer, clip_norm: float,
                        amp_dtype: Optional[torch.dtype] = None) -> Callable:
    """(batch, generator=None, noise=None) -> logs: one optimizer step.

    batch = (src_v, tgt, src_a, mask) tensors on the model's device;
    ``model`` is SLM or SLMFT; ``generator`` draws the masking noise, or
    ``noise`` injects it (see ``SLM.forward``, ``SLMFT.forward``). The forward runs under autocast to ``amp_dtype`` when
    given; the cross-entropy's log-softmax stays fp32. The gradients of the
    optimizer's parameters are clipped to a global norm of ``clip_norm``
    (none when 0). Returns the six logs as detached device tensors, so a
    step never waits for the card."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, generator: Optional[torch.Generator] = None, noise=None
             ) -> Dict[str, torch.Tensor]:
        src_v, tgt, src_a, mask = batch
        optimizer.zero_grad(set_to_none=True)
        with _autocast(src_v.device, amp_dtype):
            out = model(src_v, tgt, src_a, mask, generator=generator, noise=noise)
        out.total_loss.backward()
        if clip_norm > 0:
            clip_by_global_norm(params, clip_norm)
        optimizer.step()
        return {k: v.detach() for k, v in out.logs.items()}

    return step


def train_epoch(loader: Iterable, train_step: Callable,
                generator: Optional[torch.Generator] = None, epoch: int = 0
                ) -> Dict[str, float]:
    """One pass over ``loader``'s tensor batches, logging every 200 steps
    (x_engine_pt.train_epoch's cadence); the last step's logs."""
    logs = {}
    for i, batch in enumerate(loader):
        logs = train_step(batch, generator)
        if (i + 1) % 200 == 0:
            log.info("Epoch %d batch %d: %s", epoch, i + 1,
                     " ".join(f"{k} {float(v):.4f}" for k, v in logs.items()))
    return {k: float(v) for k, v in logs.items()}


@torch.no_grad()
def evaluate_epoch(model, loader: Iterable, generator: Optional[torch.Generator] = None,
                   amp_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """Mean of the logs over ``loader``'s tensor batches: the teacher-forced
    validation loss (x_engine_pt.py:134-165)."""
    sums: Dict[str, float] = {}
    n = 0
    for src_v, tgt, src_a, mask in loader:
        with _autocast(src_v.device, amp_dtype):
            logs = model(src_v, tgt, src_a, mask, generator=generator).logs
        for k, v in logs.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


@torch.no_grad()
def evaluate_finetune_epoch(model: SLMFT, loader: Iterable,
                            generator: Optional[torch.Generator] = None,
                            amp_dtype: Optional[torch.dtype] = None,
                            noises: Optional[Iterable[torch.Tensor]] = None
                            ) -> Tuple[List, List, List, List]:
    """Teacher-forced predictions for the metric battery
    (x_engine_pt.py:201-230) over tensor batches (src_v, tgt, src_a, mask
    [, ids]). The inputs are corrupted as in training (``SLMFT.forward``),
    by noise drawn from ``generator`` or taken from ``noises``, one (B, L-1)
    tensor a batch. Returns (y_trues, y_preds, x, data_ids), lists of
    per-clip numpy arrays of length len - 1."""
    y_trues, y_preds, xs, ids = [], [], [], []
    noises = iter(noises) if noises is not None else None
    for batch in loader:
        src_v, tgt, src_a, mask = batch[:4]
        data_ids = batch[4] if len(batch) > 4 else [None] * src_v.shape[0]
        noise = next(noises) if noises is not None else None
        with _autocast(src_v.device, amp_dtype):
            pred = model(src_v, tgt, src_a, mask, generator=generator, noise=noise).pred
        pred = pred.float().cpu().numpy()
        lens = mask.sum(dim=1).cpu().numpy()
        tgt_np, src_np = tgt.cpu().numpy(), src_v.cpu().numpy()
        for j in range(src_np.shape[0]):
            lj = int(lens[j])
            y_preds.append(pred[j, : lj - 1])
            y_trues.append(tgt_np[j, 1:lj])
            xs.append(src_np[j, : lj - 1])
            ids.append(data_ids[j])
    return y_trues, y_preds, xs, ids


def make_slmft_generator(model: SLMFT) -> Callable:
    """Batched generator: (batch, generator, n_samples) -> (B, N, L-1, 56)
    candidate motions, batch = (src_v, tgt, src_a, mask) tensors on the
    model's device.

    The prompt is tiled sample-major (row s*B + b is sample s of clip b, as
    ``jnp.tile`` lays it out); the VQ decode then sees the N*B rows in that
    order, which its batch-indexed positional encoding depends on.
    ``greedy`` and ``gumbel`` (injected (L-1, N*B, vocab) noise) pass through
    to ``generate_tokens``; ``return_tokens`` also returns the (N*B, L-1)
    sampled codes."""

    @torch.no_grad()
    def generate(batch, generator: Optional[torch.Generator], n_samples: int, *,
                 greedy: bool = False, gumbel: Optional[torch.Tensor] = None,
                 return_tokens: bool = False):
        src_v, tgt, src_a, mask = batch
        b, l = src_v.shape[0], src_v.shape[1]
        ctx, prompt = model.encode_context(src_v, tgt, src_a, mask)
        tokens = generate_tokens(model.decoder, prompt.repeat(n_samples, 1), l - 1,
                                 ctx, mask, generator, greedy=greedy,
                                 context_groups=n_samples, gumbel=gumbel)
        motion = model.decode_tokens_to_motion(tokens)
        # (N*B, L-1, 56) -> (B, N, L-1, 56)
        cands = motion.reshape(n_samples, b, l - 1, -1).transpose(0, 1)
        return (cands, tokens) if return_tokens else cands

    return generate


def select_best_by_fd(candidates: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The candidate with the lowest Frechet distance to the target clip.
    candidates: (N, T, C); target: (T, C)."""
    mu1, s1 = calculate_activation_statistics(target)
    best, best_fd = None, float("inf")
    for cand in candidates:
        mu2, s2 = calculate_activation_statistics(cand)
        try:
            fd = calculate_frechet_distance(mu1, s1, mu2, s2)
        except ValueError:
            fd = float("inf")
        if fd < best_fd:
            best, best_fd = cand, fd
    return best if best is not None else candidates[0]


def select_best_by_l2(candidates: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The candidate with the lowest mean vertex L2 (x_engine_pt.py:328-334)."""
    d = np.mean(np.sqrt(np.sum((candidates - target[None]) ** 2, axis=-1)), axis=-1)
    return candidates[int(np.argmin(d))]


def evaluate_test_epoch(model: SLMFT, generate: Callable, loader: Iterable,
                        generator: Optional[torch.Generator], beam_size: int = 10,
                        select: str = "fd", device="cuda"
                        ) -> Tuple[List, List, List, List]:
    """Best-of-N sampled eval over numpy batches (src_v, tgt, src_a, mask
    [, ids]). Returns (y_trues, y_preds, x, data_ids), lists of per-clip
    numpy arrays of length len - 1."""
    y_trues, y_preds, xs, ids = [], [], [], []
    pick = select_best_by_fd if select == "fd" else select_best_by_l2
    for batch in loader:
        src_v, tgt, src_a, mask = batch[:4]
        data_ids = batch[4] if len(batch) > 4 else [None] * src_v.shape[0]
        tensors = tuple(torch.as_tensor(np.asarray(x), device=device)
                        for x in (src_v, tgt, src_a, mask))
        cands = generate(tensors, generator, beam_size).float().cpu().numpy()
        lens = np.asarray(mask).sum(axis=1)
        tgt_np, src_np = np.asarray(tgt), np.asarray(src_v)
        for j in range(src_np.shape[0]):
            lj = int(lens[j])
            target = tgt_np[j, 1:lj]
            y_trues.append(target)
            xs.append(src_np[j, : lj - 1])
            ids.append(data_ids[j])
            y_preds.append(pick(cands[j, :, : lj - 1], target))
    return y_trues, y_preds, xs, ids
