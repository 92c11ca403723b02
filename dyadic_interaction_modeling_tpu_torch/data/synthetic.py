"""Synthetic ViCo-shaped clips, so the pipeline runs without the licensed data.

A copy of ``synthetic_vico_dataset``, ``synthetic_candor_dataset`` and
``synthetic_biwi_dataset`` from
``dyadic_interaction_modeling_tpu/data/synthetic.py``: smooth band-limited
motion (sums of random sinusoids per channel) plus Gaussian audio features,
the same numbers for the same seed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _smooth_motion(rng: np.random.Generator, length: int, dim: int,
                   n_waves: int = 4, scale: float = 0.3) -> np.ndarray:
    t = np.arange(length)[:, None] / 30.0  # 30 fps
    freqs = rng.uniform(0.2, 3.0, size=(n_waves, dim))
    phases = rng.uniform(0, 2 * np.pi, size=(n_waves, dim))
    amps = rng.uniform(0.2, 1.0, size=(n_waves, dim)) * scale
    out = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in zip(amps, freqs, phases))
    return out.astype(np.float32)


def synthetic_vico_clip(rng: np.random.Generator, length: int,
                        motion_dim: int = 56, audio_dim: int = 768) -> Dict:
    return {
        "video_speaker": _smooth_motion(rng, length, motion_dim),
        "video_listener": _smooth_motion(rng, length, motion_dim),
        "audio": rng.standard_normal((length, audio_dim)).astype(np.float32) * 0.1,
    }


class ListDataset:
    def __init__(self, items: List):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def synthetic_vico_dataset(n_clips: int = 16, min_len: int = 24, max_len: int = 96,
                           seed: int = 0, motion_dim: int = 56,
                           audio_dim: int = 768) -> ListDataset:
    """Items shaped like ViCoDataset.__getitem__ output: (combined speaker
    features (L, 56 + 768), listener motion (L, 56), name, speaker id,
    listener id, sentiment)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_clips):
        length = int(rng.integers(min_len, max_len + 1))
        clip = synthetic_vico_clip(rng, length, motion_dim, audio_dim)
        combined = np.concatenate([np.ones_like(clip["video_speaker"]),
                                   clip["audio"]], axis=1)
        items.append((combined, clip["video_listener"], f"synthetic_{i}", i % 7,
                      i % 5, i % 3))
    return ListDataset(items)


def synthetic_candor_dataset(n_clips: int = 16, min_len: int = 24, max_len: int = 96,
                             seed: int = 0) -> ListDataset:
    """CANDOR-shaped items for SLM pretraining: (speaker motion (56) + audio
    (768) features, listener motion, name, 0, 0, 0)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_clips):
        length = int(rng.integers(min_len, max_len + 1))
        clip = synthetic_vico_clip(rng, length)
        combined = np.concatenate([clip["video_speaker"], clip["audio"]], axis=1)
        items.append((combined, clip["video_listener"], f"candor_{i}", 0, 0, 0))
    return ListDataset(items)


def synthetic_biwi_dataset(n_clips: int = 4, length: int = 32, n_vertices: int = 23370,
                           seed: int = 0, subjects=("F2", "F3")) -> Tuple[List[Dict], Dict]:
    """BIWI-layout items (name ``{subject}_{i:02d}.wav``, template, vertices
    (length, 3 * n_vertices) of smooth motion about the template, raw audio
    of length * 533 samples) and the subjects' templates."""
    rng = np.random.default_rng(seed)
    templates = {s: rng.standard_normal(n_vertices * 3).astype(np.float32) * 0.01
                 for s in subjects}
    items = []
    for i in range(n_clips):
        s = subjects[i % len(subjects)]
        motion = _smooth_motion(rng, length, n_vertices * 3, n_waves=2, scale=0.002)
        items.append({
            "name": f"{s}_{i + 1:02d}.wav",
            "template": templates[s],
            "vertice": motion + templates[s][None, :],
            "audio": rng.standard_normal(length * 533).astype(np.float32),
        })
    return items, templates
