"""Synthetic clips written as the reference's ViCo and CANDOR files, so the
file readers and the CLI twins run where the licensed data is not at hand.

``write_vico`` lays out ``<root>/vico_processed_30fps/<uid>.pkl`` (dicts of
``video_speaker`` (L, 56), ``video_listener`` (L, 56) and ``audio``
(L, 768)) and ``<root>/RLD_data.csv`` (sentiment, uid, listener file,
speaker file, listener id, speaker id, split; integer ids), the layout
``data.datasets.ViCoDataset`` reads (the reference's
``dataset/data_loader.py:108-152``). ``write_candor`` lays out
``<root>/candor_processed/{speaker,listener}/<conversation>_<n>.pkl`` (dicts
of ``video`` and, for the speaker, ``audio``), which ``candor_split`` reads.
The motion is ``data.synthetic``'s: sums of random sinusoids per channel.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Sequence, Tuple

import numpy as np

from .synthetic import synthetic_vico_clip

SENTIMENTS = ("neutral", "positive", "negative")


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def write_vico(root: str, lengths: Sequence[int], splits: Sequence[str], seed: int = 0
               ) -> Tuple[str, str]:
    """One clip per entry of ``lengths`` in the split of the same entry of
    ``splits`` (``train`` / ``test``), clip i named ``clip{i:04d}`` with
    listener id 100 + i and speaker id 200 + i. Returns (data dir, CSV)."""
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "vico_processed_30fps")
    rows = []
    for i, (length, split) in enumerate(zip(lengths, splits)):
        uid = f"clip{i:04d}"
        _dump(os.path.join(data_dir, f"{uid}.pkl"), synthetic_vico_clip(rng, int(length)))
        rows.append([SENTIMENTS[i % 3], uid, f"{uid}_listener.mp4", f"{uid}_speaker.mp4",
                     100 + i, 200 + i, split])
    meta = os.path.join(root, "RLD_data.csv")
    with open(meta, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sentiment", "uid", "listener_file", "speaker_file", "listener_id",
                    "speaker_id", "split"])
        w.writerows(rows)
    return data_dir, meta


def write_candor(root: str, n_conversations: int, utterances: int, min_len: int,
                 max_len: int, seed: int = 0) -> Tuple[str, str]:
    """``utterances`` speaker/listener pairs for each of ``n_conversations``
    conversations, each min_len..max_len frames long. Returns (speaker dir,
    listener dir)."""
    rng = np.random.default_rng(seed)
    sp_root = os.path.join(root, "candor_processed", "speaker")
    li_root = os.path.join(root, "candor_processed", "listener")
    for c in range(n_conversations):
        for u in range(utterances):
            clip = synthetic_vico_clip(rng, int(rng.integers(min_len, max_len + 1)))
            name = f"conv{c:04d}_{u}.pkl"
            _dump(os.path.join(sp_root, name), {"video": clip["video_speaker"],
                                                 "audio": clip["audio"]})
            _dump(os.path.join(li_root, name), {"video": clip["video_listener"]})
    return sp_root, li_root
