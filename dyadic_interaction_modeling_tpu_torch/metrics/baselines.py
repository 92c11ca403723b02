"""Retrieval and random baselines (reference ``baselines.py``).

Counterpart of ``dyadic_interaction_modeling_tpu/metrics/baselines.py``:
random-retrieval, nearest-neighbor-by-motion and nearest-neighbor-by-audio
predictors on L2L-format data, grouped per source clip and scored with the
models' Frechet distances (``eval_utils``), to bound the metrics' ranges.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .eval_utils import calculate_activation_statistics, calculate_frechet_distance


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return -1.0
    return float(np.dot(a, b) / (na * nb))


def random_retrieval_baseline(train_listener: Sequence[np.ndarray],
                              test_speaker: Sequence[np.ndarray],
                              test_listener: Sequence[np.ndarray],
                              test_ids: Sequence[str],
                              rng: np.random.Generator,
                              pool: int = 5,
                              window: int = 64) -> Tuple[List, List, List]:
    """Random pick from the first ``pool`` training listener windows
    (baselines.py:84-113: ``listener_X[np.random.randint(0, 5)]``)."""
    pred_d, gt_d, x_d = {}, {}, {}
    for sp, li, cid in zip(test_speaker, test_listener, test_ids):
        pred = train_listener[int(rng.integers(0, pool))]
        if not (len(pred) == len(li) == len(sp) == window):
            continue
        pred_d.setdefault(cid, []).append(pred)
        gt_d.setdefault(cid, []).append(li)
        x_d.setdefault(cid, []).append(sp)
    return _concat_groups(pred_d, gt_d, x_d)


def nn_motion_baseline(train_speaker: Sequence[np.ndarray],
                       train_listener: Sequence[np.ndarray],
                       test_speaker: Sequence[np.ndarray],
                       test_listener: Sequence[np.ndarray],
                       test_ids: Sequence[str],
                       window: int = 64) -> Tuple[List, List, List]:
    """Nearest neighbor by mean speaker-motion cosine (baselines.py:60-82)."""
    train_means = np.stack([np.asarray(s).mean(axis=0) for s in train_speaker])
    pred_d, gt_d, x_d = {}, {}, {}
    for sp, li, cid in zip(test_speaker, test_listener, test_ids):
        v = np.asarray(sp).mean(axis=0)
        sims = train_means @ v / (np.linalg.norm(train_means, axis=1)
                                  * np.linalg.norm(v) + 1e-12)
        pred = train_listener[int(np.argmax(sims))]
        if not (len(pred) == len(li) == len(sp) == window):
            continue
        pred_d.setdefault(cid, []).append(pred)
        gt_d.setdefault(cid, []).append(li)
        x_d.setdefault(cid, []).append(sp)
    return _concat_groups(pred_d, gt_d, x_d)


def nn_audio_baseline(train_audio: Sequence[np.ndarray],
                      train_listener: Sequence[np.ndarray],
                      test_audio: Sequence[np.ndarray],
                      test_listener: Sequence[np.ndarray],
                      test_speaker: Sequence[np.ndarray],
                      test_ids: Sequence[str],
                      window: int = 64) -> Tuple[List, List, List]:
    """Nearest neighbor by mean audio-feature cosine."""
    train_means = np.stack([np.asarray(a).mean(axis=0) for a in train_audio])
    pred_d, gt_d, x_d = {}, {}, {}
    for au, li, sp, cid in zip(test_audio, test_listener, test_speaker, test_ids):
        v = np.asarray(au).mean(axis=0)
        sims = train_means @ v / (np.linalg.norm(train_means, axis=1)
                                  * np.linalg.norm(v) + 1e-12)
        pred = train_listener[int(np.argmax(sims))]
        if not (len(pred) == len(li) == len(sp) == window):
            continue
        pred_d.setdefault(cid, []).append(pred)
        gt_d.setdefault(cid, []).append(li)
        x_d.setdefault(cid, []).append(sp)
    return _concat_groups(pred_d, gt_d, x_d)


def _concat_groups(pred_d: Dict, gt_d: Dict, x_d: Dict) -> Tuple[List, List, List]:
    """Concatenate per-clip windows into sequences (baselines.py:106-113)."""
    pred, gt, x = [], [], []
    for key in pred_d:
        try:
            pred.append(np.concatenate(pred_d[key], axis=0))
            gt.append(np.concatenate(gt_d[key], axis=0))
            x.append(np.concatenate(x_d[key], axis=0))
        except ValueError:
            continue
    return pred, gt, x


def score_baseline(gt: Sequence[np.ndarray], pred: Sequence[np.ndarray],
                   exp_slice=slice(0, 50), pose_slice=slice(50, None)
                   ) -> Dict[str, float]:
    """FD over exp/pose splits (baselines.py:116-131; L2L layout stores
    expression first, pose last)."""
    def _fd(sl):
        fids = []
        for g, p in zip(gt, pred):
            mu1, s1 = calculate_activation_statistics(g[:, sl])
            mu2, s2 = calculate_activation_statistics(p[:, sl])
            fids.append(calculate_frechet_distance(mu1, s1, mu2, s2))
        return float(np.mean(fids))

    return {"fid_exp": _fd(exp_slice), "fid_pose": _fd(pose_slice)}
