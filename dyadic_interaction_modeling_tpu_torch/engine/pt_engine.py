"""Best-of-N listener generation and its evaluation (x_engine_pt.py:232-277).

Counterpart of ``dyadic_interaction_modeling_tpu/engine/pt_engine.py:195-318``:
``make_slmft_generator`` runs the N resamples of every clip as ONE batched
generate whose N*B0 rows share the B0 clips' cross-attention context
(``context_groups``), then decodes the tokens to motion; the per-clip pick by
Frechet distance happens on the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..metrics.eval_utils import (
    calculate_activation_statistics,
    calculate_frechet_distance,
)
from ..models.slm import SLMFT
from ..models.xtrans import generate_tokens


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
