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
``write_biwi`` lays out a BIWI tree as ``data.datasets.read_biwi_emoca_data``
reads it (the reference's ``dataset/biwi.py:70-76``): ``wav/<stem>.wav``
(16 kHz, 16-bit PCM), ``vertices_npy/<stem>.npy``,
``emoca_biwi/<stem>.pkl`` (a dict of frames, each ``pose`` (6) and ``exp``
(50)) and ``templates.pkl``. ``write_lm_listener`` writes LM-Listener's
``segments_{mode}.pth`` (a ``torch.save``d list of segment dicts: ``p0_*``
the listener's and ``p1_*`` the speaker's ``pose`` (L, 6) and ``exp``
(L, 50), ``hubert_feat`` (H, 768) at its own frame rate,
``split_start_time`` / ``split_end_time`` and ``fname``), which
``data.datasets.LmListenerDataset`` reads. The motion is ``data.synthetic``'s: sums of
random sinusoids per channel.
"""

from __future__ import annotations

import csv
import os
import pickle
import wave
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .synthetic import _smooth_motion, synthetic_vico_clip

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


def _write_wav(path: str, pcm: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())


def write_biwi(root: str, clips: Sequence[Tuple[str, int]], n_frames: int,
               n_vertices: int, wav_samples: int = 8000, seed: int = 0,
               corrupt_clip: Optional[Tuple[str, int]] = None) -> Dict[str, np.ndarray]:
    """One clip per (subject, sentence) of ``clips``, stem
    ``{subject}_{sentence:02d}``, of ``n_frames`` vertex and EMOCA frames
    and ``wav_samples`` audio samples; ``corrupt_clip``'s EMOCA file is not a
    pickle. Returns the subjects' (n_vertices, 3) templates."""
    rng = np.random.default_rng(seed)
    templates: Dict[str, np.ndarray] = {}
    for subj, sent in clips:
        stem = f"{subj}_{sent:02d}"
        if subj not in templates:
            templates[subj] = rng.standard_normal((n_vertices, 3)).astype(np.float32)
        _write_wav(os.path.join(root, "wav", f"{stem}.wav"),
                   rng.standard_normal(wav_samples) * 3000)
        verts = templates[subj].reshape(1, -1) + _smooth_motion(rng, n_frames, 3 * n_vertices)
        path = os.path.join(root, "vertices_npy", f"{stem}.npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, verts.astype(np.float32))
        motion = _smooth_motion(rng, n_frames, 56)
        emoca = {f"{t:06d}": {"pose": motion[t, :6], "exp": motion[t, 6:]}
                 for t in range(n_frames)}
        if (subj, sent) == corrupt_clip:
            os.makedirs(os.path.join(root, "emoca_biwi"), exist_ok=True)
            with open(os.path.join(root, "emoca_biwi", f"{stem}.pkl"), "wb") as f:
                f.write(b"not a pickle")
        else:
            _dump(os.path.join(root, "emoca_biwi", f"{stem}.pkl"), emoca)
    _dump(os.path.join(root, "templates.pkl"), templates)
    return templates


def write_lm_listener(root: str, clips: Sequence[Dict], mode: str = "train",
                      seed: int = 0) -> str:
    """One segment a dict of ``clips``: ``length`` speaker frames,
    ``listener_length`` listener frames (default ``length``),
    ``hubert_frames`` rows of HuBERT features (absent: the segment has no
    ``hubert_feat``) and ``split`` its (start, end) times (default
    (0, length / 30)). Returns the file's path."""
    import torch

    rng = np.random.default_rng(seed)
    segments = []
    for i, spec in enumerate(clips):
        n_sp = int(spec["length"])
        n_li = int(spec.get("listener_length", n_sp))
        sp, li = _smooth_motion(rng, n_sp, 56), _smooth_motion(rng, n_li, 56)
        start, end = spec.get("split", (0.0, n_sp / 30.0))
        seg = {"fname": f"seg{i:04d}", "p1_pose": sp[:, :6], "p1_exp": sp[:, 6:],
               "p0_pose": li[:, :6], "p0_exp": li[:, 6:], "split_start_time": start,
               "split_end_time": end}
        if "hubert_frames" in spec:
            seg["hubert_feat"] = (rng.standard_normal((int(spec["hubert_frames"]), 768))
                                  .astype(np.float32) * 0.1)
        segments.append(seg)
    path = os.path.join(root, f"segments_{mode}.pth")
    os.makedirs(root, exist_ok=True)
    torch.save(segments, path)
    return path
