"""Post-processing and export, numpy in and numpy out.

Counterpart of ``dyadic_interaction_modeling_tpu/postprocess/smoothing.py``:

* ``smooth_logits_matrix`` - per-channel moving-average smoothing, window 10
  (reference ``postprocess2emoca.py:7-29``),
* EMOCA per-frame export: ``{id}/{frame:05d}/pose.npy, exp.npy``
  (postprocess2emoca.py:81-105) - the layout PIRender inference consumes,
* BIWI merge: smoothed 56-d predictions + GT cam/shape into EMOCA dirs
  (``emoca2flame.py:36-70``, ``postprocess_biwi.py``).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np


def smooth_logits_matrix(matrix: np.ndarray, window: int = 10,
                         edge_mode: str = "zero") -> np.ndarray:
    """Per-channel centered moving average (postprocess2emoca.py:7-29).

    QUIRK (reproduced with ``edge_mode='zero'``, the reference behavior): the
    output is initialised to zeros and only rows ``[w//2 : T - w//2 + 1)``
    receive the valid-mode convolution - the first and last ~w/2 frames stay
    ZERO. ``edge_mode='copy'`` keeps the unsmoothed input at the edges
    instead (sane alternative for production use).
    """
    matrix = np.asarray(matrix, dtype=np.float64)
    t, c = matrix.shape
    out = np.zeros_like(matrix) if edge_mode == "zero" else matrix.copy()
    if t < window:
        return out if edge_mode == "zero" else matrix.copy()
    kernel = np.ones(window) / window
    lo = window // 2
    hi = t - window // 2 + 1
    for j in range(c):
        out[lo:hi, j] = np.convolve(matrix[:, j], kernel, mode="valid")
    return out


def export_emoca_dirs(out_root: str, clip_id: str, coeffs: np.ndarray,
                      pose_dims: int = 6, smooth_window: Optional[int] = 10
                      ) -> str:
    """Write per-frame ``pose.npy`` / ``exp.npy`` under ``{out_root}/{clip_id}/
    {frame:05d}/`` (postprocess2emoca.py:81-105)."""
    if smooth_window:
        coeffs = smooth_logits_matrix(coeffs, smooth_window)
    clip_dir = os.path.join(out_root, clip_id)
    for i, frame in enumerate(coeffs):
        frame_dir = os.path.join(clip_dir, f"{i:05d}")
        os.makedirs(frame_dir, exist_ok=True)
        np.save(os.path.join(frame_dir, "pose.npy"),
                frame[:pose_dims].astype(np.float32))
        np.save(os.path.join(frame_dir, "exp.npy"),
                frame[pose_dims:].astype(np.float32))
    return clip_dir


def merge_biwi_to_emoca(out_root: str, clip_id: str, pred_coeffs: np.ndarray,
                        gt_frames: Mapping[str, Mapping[str, np.ndarray]],
                        smooth_window: int = 10) -> str:
    """BIWI export (emoca2flame.py:36-70): smoothed predicted pose (dims :6)
    and expression (last 50 dims) merged with ground-truth ``cam``/``shape``
    per frame.

    ``gt_frames`` maps the GT pickle's frame-id strings (ending in the
    1-indexed frame number, e.g. ``frame_007``) to dicts with at least
    ``cam`` and ``shape`` arrays - directory names follow the GT keys
    exactly like the reference.
    """
    coeffs = smooth_logits_matrix(pred_coeffs, smooth_window)
    clip_dir = os.path.join(out_root, clip_id)
    for frame_id in sorted(gt_frames):
        try:
            frame_num = int(str(frame_id).split("_")[-1])
            pred_frame = coeffs[frame_num - 1]
        except (ValueError, IndexError):
            continue  # reference skips unparsable/missing frames (:70)
        frame_dir = os.path.join(clip_dir, str(frame_id))
        os.makedirs(frame_dir, exist_ok=True)
        np.save(os.path.join(frame_dir, "exp.npy"),
                pred_frame[-50:].astype(np.float32))
        np.save(os.path.join(frame_dir, "pose.npy"),
                pred_frame[:6].astype(np.float32))
        for key in ("cam", "shape"):
            if key in gt_frames[frame_id]:
                np.save(os.path.join(frame_dir, f"{key}.npy"),
                        np.asarray(gt_frames[frame_id][key], dtype=np.float32))
    return clip_dir
