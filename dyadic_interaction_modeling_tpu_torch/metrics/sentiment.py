"""Sentiment probe (reference code/sentiment.py).

Counterpart of ``dyadic_interaction_modeling_tpu/metrics/sentiment.py``: a
small MLP over 56-d EMOCA frames (56 -> 256 -> 256 -> 3) that measures
whether generated listener motion carries sentiment, its class-weighted
training, and the reference's thresholded classifier on its softmax
(sentiment.py:105-121: negative if p[2] > 0.03, else neutral if p[0] > 0.41,
else positive).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class SentimentMLP(nn.Module):
    """fc1 -> relu -> fc2 -> relu -> fc3 (sentiment.py:13-32)."""

    def __init__(self, in_dim: int = 56, hidden: int = 256, n_classes: int = 3):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, n_classes)

    def extract(self, x: torch.Tensor) -> torch.Tensor:
        """The penultimate features (sentiment.py:29-32)."""
        return self.fc2(F.relu(self.fc1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.relu(self.extract(x)))


def threshold_classifier(probs: np.ndarray, neg_thresh: float = 0.03,
                         neutral_thresh: float = 0.41) -> np.ndarray:
    """The reference's prioritised thresholds (sentiment.py:111-120): class 2
    (negative) if p2 > 0.03, else class 0 (neutral) if p0 > 0.41, else
    class 1 (positive)."""
    probs = np.asarray(probs)
    out = np.ones(probs.shape[:-1], dtype=np.int32)
    out = np.where(probs[..., 0] > neutral_thresh, 0, out)
    return np.where(probs[..., 2] > neg_thresh, 2, out)


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross entropy with class weights, normalised by the batch's summed
    weight (torch's ``CrossEntropyLoss(weight=...)``, sentiment.py:49)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if class_weights is None:
        return nll.mean()
    w = torch.as_tensor(class_weights, device=logits.device)[labels.long()]
    return (nll * w).sum() / w.sum().clamp_min(1e-12)


# sentiment.py:49: [432/113, 423/195, 432/115]
DEFAULT_CLASS_WEIGHTS = np.asarray([432 / 113, 423 / 195, 432 / 115], dtype=np.float32)


def train_probe(frames: np.ndarray, labels: np.ndarray, *, epochs: int = 20,
                lr: float = 1e-4, batch_size: int = 256, seed: int = 0,
                init: Optional[Mapping[str, torch.Tensor]] = None,
                device="cuda") -> Tuple[SentimentMLP, Dict]:
    """Trains the per-frame probe (the reference's commented loop,
    sentiment.py:46-77): Adam ``lr``, the weighted cross entropy, the batches
    of each epoch from ``np.random.default_rng(seed).permutation`` with the
    tail that does not fill a batch dropped. ``init`` (a state_dict) sets
    the starting weights, else a torch init from ``seed``. frames (N, 56),
    labels (N,) in {0, 1, 2}; on ``device`` (the card unless the CPU is
    asked for)."""
    torch.manual_seed(seed)
    model = SentimentMLP(frames.shape[1])
    if init is not None:
        model.load_state_dict(init, strict=True)
    model = model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    weights = torch.as_tensor(DEFAULT_CLASS_WEIGHTS, device=device)
    x_all = torch.as_tensor(np.asarray(frames, np.float32), device=device)
    y_all = torch.as_tensor(np.asarray(labels), device=device).long()
    rng = np.random.default_rng(seed)
    n, loss = frames.shape[0], None
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.as_tensor(order[i: i + batch_size], device=device)
            loss = weighted_ce_loss(model(x_all[idx]), y_all[idx], weights)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return model, {"final_loss": float(loss.detach()) if loss is not None else None}


@torch.no_grad()
def classify_clips(model: SentimentMLP, clips: Sequence[np.ndarray]) -> np.ndarray:
    """Per-clip sentiment: the probe on the clip's mean frame, then the
    threshold classifier (sentiment.py:84-121)."""
    dev = next(model.parameters()).device
    preds = []
    for clip in clips:
        x = torch.as_tensor(np.asarray(clip).mean(axis=0), dtype=torch.float32, device=dev)[None]
        probs = torch.softmax(model(x), dim=-1)[0].cpu().numpy()
        preds.append(int(threshold_classifier(probs)))
    return np.asarray(preds)
