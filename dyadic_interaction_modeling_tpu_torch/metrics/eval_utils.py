"""Evaluation metric primitives, host-side numpy/scipy.

A copy of ``dyadic_interaction_modeling_tpu/metrics/eval_utils.py`` (reference
``metrics/eval_utils.py``). The one difference: ``calcuate_sid`` clusters
with the numpy k-means below instead of scikit-learn's ``KMeans`` (the port
depends on torch, numpy and scipy only). Where the data has clear clusters
both find the same partition and the SID values agree to rounding; on data
without clear clusters the two may settle in different local optima, and the
SID values then differ.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import linalg


def calculate_activation_statistics(activations: np.ndarray
                                    ) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(activations, axis=0)
    cov = np.cov(activations, rowvar=False)
    return mu, cov


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (eval_utils.py:12-46)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError("mean or covariance shapes differ")
    diff = mu1 - mu2

    def _sqrtm(a):
        out = linalg.sqrtm(a)
        return out[0] if isinstance(out, tuple) else out

    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_variance(activations: np.ndarray) -> float:
    """The summed per-dimension variance (eval_utils.py:48-49)."""
    return float(np.sum(np.var(activations, axis=0)))


def _sq_dists(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    return ((x * x).sum(1)[:, None] + (centers * centers).sum(1)[None, :]
            - 2.0 * x @ centers.T)


def kmeans(x: np.ndarray, k: int, seed: int = 0, iters: int = 100) -> np.ndarray:
    """Lloyd's k-means with greedy k-means++ seeding (as scikit-learn seeds
    it: of 2 + ln(k) candidates drawn by squared distance, keep the one that
    lowers the total most); returns (k, D) centers."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float64)
    trials = 2 + int(np.log(k))
    centers = [x[rng.integers(len(x))]]
    d2 = np.clip(_sq_dists(x, centers[0][None])[:, 0], 0, None)
    for _ in range(1, k):
        cand = np.searchsorted(np.cumsum(d2), rng.uniform(size=trials) * d2.sum())
        cand = np.minimum(cand, len(x) - 1)
        new_d2 = np.minimum(d2[None], np.clip(_sq_dists(x, x[cand]).T, 0, None))
        best = int(np.argmin(new_d2.sum(1)))
        centers.append(x[cand[best]])
        d2 = new_d2[best]
    centers = np.asarray(centers)
    for _ in range(iters):
        labels = assign(x, centers)
        new = np.asarray([x[labels == c].mean(0) if np.any(labels == c) else centers[c]
                          for c in range(k)])
        if np.allclose(new, centers):
            break
        centers = new
    return centers


def assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    return np.argmin(_sq_dists(np.asarray(x, dtype=np.float64), centers), axis=1)


def calcuate_sid(gt: Sequence[np.ndarray], pred: Sequence[np.ndarray],
                 type: str = "exp") -> float:
    """Style Intensity Diversity: entropy of the k-means cluster histogram of
    the predictions, clusters fit on the ground truth (k=40 for expression
    dims 6:, k=20 for pose :6)."""
    k = 40 if type == "exp" else 20
    sl = slice(6, None) if type == "exp" else slice(0, 6)
    merge_gt = np.concatenate(gt, axis=0)[:, sl]
    centers = kmeans(merge_gt, min(k, len(merge_gt)))
    labels = assign(np.concatenate(pred, axis=0)[:, sl], centers)
    hist = np.bincount(labels, minlength=k).astype(np.float64)
    hist = hist / hist.sum()
    return -float(np.sum(hist * np.log2(hist + 1e-6)))


def sts(x: np.ndarray, y: np.ndarray, timestep: float = 0.1) -> float:
    """Temporal-derivative distance (eval_utils.py:85-91)."""
    dx, dy = np.diff(x, axis=0), np.diff(y, axis=0)
    return float(np.sqrt(np.sum((dx - dy) ** 2) / timestep))


def perplexity_from_logits(logits: np.ndarray, targets: np.ndarray,
                           ignore_index: int = -100) -> float:
    """torcheval.metrics.Perplexity equivalent (x_engine.py:68-88):
    exp(mean NLL over the targets that are not ``ignore_index``), in fp64."""
    logits = np.asarray(logits, dtype=np.float64)
    targets = np.asarray(targets)
    logp = logits - logits.max(axis=-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=-1, keepdims=True))
    keep = targets != ignore_index
    safe = np.clip(targets, 0, logits.shape[-1] - 1)
    nll = -np.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
    return float(np.exp(nll[keep].mean()))
