"""Readers of the reference's ViCo and CANDOR files.

A copy of the ViCo and CANDOR readers of
``dyadic_interaction_modeling_tpu/data/datasets.py:38-177`` (the reference's
``dataset/data_loader.py:44-206, 357-387``), with their quirks:

* ``ViCoDataset``: a pickle a clip with ``video_speaker`` / ``video_listener``
  / ``audio``; the speaker video is REPLACED BY ONES (``data_loader.py:147``);
  sentiment and the speaker and listener ids come from ``RLD_data.csv``;
  clips keep 5 <= len <= 1024 with their three streams aligned.
* ``ViCoListenerDataset`` / ``ViCoSpeakerDataset``: one stream of those clips.
* ``candor_split``: speaker/listener utterance pickles, split 95/5 by
  conversation id with ``random.Random(42)``, 5 <= len <= 250.

The JAX package reads ``RLD_data.csv`` with pandas; the port declares torch,
numpy and scipy only, so ``read_csv_rows`` reads it with the ``csv`` module
and types each column as pandas infers it: int when every cell is an integer,
float when every cell is a number (an empty cell is NaN), str otherwise.
"""

from __future__ import annotations

import csv
import os
import pickle
import random
from typing import Any, List, Sequence, Tuple

import numpy as np

SENTIMENT2IDX = {"neutral": 0, "positive": 1, "negative": 2}


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _column_type(cells: Sequence[str]):
    """The Python type pandas gives a column of these cells."""
    for kind in (int, float):
        try:
            for c in cells:
                if c != "" or kind is int:
                    kind(c)
            return kind
        except ValueError:
            continue
    return str


def read_csv_rows(path: str) -> List[List[Any]]:
    """The data rows of a CSV with a header, each cell typed as
    ``pandas.read_csv(path).values`` types it (see the module docstring)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    if not rows:
        return []
    kinds = [_column_type([r[j] for r in rows]) for j in range(len(rows[0]))]
    return [[float("nan") if c == "" else k(c) for c, k in zip(r, kinds)] for r in rows]


def _vico_paths(data_path: str, meta: List[List[Any]], mode: str, min_len: int,
                max_len: int) -> List[str]:
    """The pickles of the split's clips whose three streams are aligned and
    min_len <= len <= max_len long."""
    paths = []
    for did in (row[1] for row in meta if row[6] == mode):
        p = os.path.join(data_path, f"{did}.pkl")
        if not os.path.exists(p):
            continue
        d = _load_pickle(p)
        if (len(d["video_speaker"]) == len(d["audio"]) == len(d["video_listener"])
                and max_len >= len(d["video_speaker"]) >= min_len):
            paths.append(p)
    print(f"Loaded {len(paths)} data points for {mode}")
    return paths


class ViCoDataset:
    """Dyadic ViCo clips: (speaker features (L, 56 + 768) with the speaker
    video replaced by ones, listener motion (L, 56), pickle path, speaker id,
    listener id, sentiment)."""

    def __init__(self, data_path: str, meta_data_path: str, mode: str = "train",
                 min_len: int = 5, max_len: int = 1024):
        meta = read_csv_rows(meta_data_path)
        self.paths = _vico_paths(data_path, meta, mode, min_len, max_len)
        self.id2speaker = {row[1]: row[5] for row in meta}
        self.id2listener = {row[1]: row[4] for row in meta}
        self.id2sentiment = {row[1]: SENTIMENT2IDX[row[0]] for row in meta}

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int):
        p = self.paths[index]
        d = _load_pickle(p)
        uid = os.path.basename(p).split(".")[0]
        # reference quirk: the speaker video is replaced by ones (:147)
        video_speaker = np.ones_like(np.asarray(d["video_speaker"], dtype=np.float32))
        audio = np.asarray(d["audio"], dtype=np.float32)
        listener = np.asarray(d["video_listener"], dtype=np.float32)
        return (np.concatenate([video_speaker, audio], axis=1), listener, p,
                self.id2speaker[uid], self.id2listener[uid], self.id2sentiment[uid])


class _SingleStreamViCo:
    """One stream (``key``) of the ViCo clips: (motion (L, 56), path)."""

    key: str = "video_listener"

    def __init__(self, data_path: str, meta_data_path: str, mode: str = "train",
                 min_len: int = 5, max_len: int = 1024):
        self.paths = _vico_paths(data_path, read_csv_rows(meta_data_path), mode, min_len,
                                 max_len)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int):
        d = _load_pickle(self.paths[index])
        return np.asarray(d[self.key], dtype=np.float32), self.paths[index]


class ViCoListenerDataset(_SingleStreamViCo):
    key = "video_listener"


class ViCoSpeakerDataset(_SingleStreamViCo):
    key = "video_speaker"


def candor_split(speaker_root: str, listener_root: str, min_len: int = 5,
                 max_len: int = 250, train_frac: float = 0.95, seed: int = 42
                 ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """(train, val) lists of (speaker, listener) utterance pickles: 95/5 by
    conversation id (the file name's prefix before ``_``), shuffled by
    ``random.Random(42)`` (data_loader.py:357-387)."""
    all_data = sorted(os.listdir(speaker_root))
    unique_ids = list(set(f.split("_")[0] for f in all_data))
    # a set of strings iterates in an order that varies between processes
    # (hash randomisation), as in the reference and the JAX package; within one
    # process all of them shuffle the same list
    rng = random.Random(seed)
    rng.shuffle(unique_ids)
    train_ids = set(unique_ids[: int(len(unique_ids) * train_frac)])
    train, val = [], []
    for fid in all_data:
        sp = os.path.join(speaker_root, fid)
        lp = os.path.join(listener_root, fid)
        if not os.path.exists(lp):
            continue
        ds, dl = _load_pickle(sp), _load_pickle(lp)
        if not (min_len <= len(ds["video"]) <= max_len) or \
                len(ds["audio"]) != len(ds["video"]) or \
                len(ds["video"]) != len(dl["video"]):
            continue
        (train if fid.split("_")[0] in train_ids else val).append((sp, lp))
    return train, val


class CandorDataset:
    """Dyadic CANDOR utterances (data_loader.py:83-106): (speaker motion +
    audio (L, 824), listener motion (L, 56), speaker path, 0, 0, 0); the
    speaker path names the clip (the collate's ``name``, the VQ token
    cache's key)."""

    def __init__(self, pairs: Sequence[Tuple[str, str]]):
        self.pairs = list(pairs)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index: int):
        sp, lp = self.pairs[index]
        ds, dl = _load_pickle(sp), _load_pickle(lp)
        combined = np.concatenate([np.asarray(ds["video"], dtype=np.float32),
                                   np.asarray(ds["audio"], dtype=np.float32)], axis=1)
        return combined, np.asarray(dl["video"], dtype=np.float32), sp, 0, 0, 0


class CandorListenerDataset:
    """One CANDOR stream: (motion (L, 56), path)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = list(paths)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int):
        return np.asarray(_load_pickle(self.paths[index])["video"], dtype=np.float32), \
            self.paths[index]


class CandorSpeakerDataset(CandorListenerDataset):
    pass
