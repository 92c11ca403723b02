"""Batching and padding of ragged clips (reference ``pad_collate``).

A copy of ``bucket_length``, ``pad_collate``, ``PaddedBatchLoader`` and
``slm_batch_from_collated`` from ``dyadic_interaction_modeling_tpu/
data/loader.py``, and of the VQ training collate of
``dyadic_interaction_modeling_tpu/cli/train_vq.py:25-37`` (``vq_collate``).
Lengths are padded up to a power-of-two bucket, as there, so both packages
see the same padded batches.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Iterator, Sequence, Tuple

import numpy as np


def bucket_length(n: int, min_bucket: int = 32, max_len: int = 1024) -> int:
    """Smallest power of two >= n, clamped to [min_bucket, max_len]."""
    b = max(min_bucket, 1 << max(0, math.ceil(math.log2(max(n, 1)))))
    return min(b, max_len)


def pad_to(arr: np.ndarray, length: int, value: float = 0.0) -> np.ndarray:
    if arr.shape[0] >= length:
        return arr[:length]
    pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=value)


def pad_collate(batch: Sequence[Tuple], min_bucket: int = 32, max_len: int = 1024):
    """(combined, listener, name, speaker_id, listener_id, sentiment) items ->
    (src, tgt, lengths, mask, (speaker_ids, listener_ids), names)."""
    xs = [b[0] for b in batch]
    ys = [b[1] for b in batch]
    names = [b[2] for b in batch]
    sp_ids = np.asarray([b[3] for b in batch], dtype=np.int32)
    li_ids = np.asarray([b[4] for b in batch], dtype=np.int32)
    lens = np.asarray([len(x) for x in xs], dtype=np.int32)
    L = bucket_length(int(lens.max()), min_bucket, max_len)
    src = np.stack([pad_to(x, L) for x in xs])
    tgt = np.stack([pad_to(y, L) for y in ys])
    mask = np.arange(L)[None, :] < lens[:, None]
    return src, tgt, lens, mask, (sp_ids, li_ids), names


def vq_collate(batch: Sequence[Tuple], min_bucket: int = 32, max_len: int = 1024
               ) -> np.ndarray:
    """Single-stream clips (motion first in each item) -> a dense (B, L, C)
    batch: L is the bucket of the longest clip, at most ``max_len``, and each
    clip is padded by repeating its last frame (the reference trains its VQs
    on dense clips without lengths, at batch size 1)."""
    xs = [b[0] for b in batch]
    L = bucket_length(max(len(x) for x in xs), min_bucket, max_len)
    return np.stack([np.concatenate(
        [x[:L], np.repeat(x[-1:], max(0, L - len(x)), axis=0)], axis=0) for x in xs])


class PaddedBatchLoader:
    """Minimal batch loader over an indexable dataset, yielding ``collate``
    of each batch (``pad_collate`` tuples by default; shuffled with
    ``seed + epoch`` when ``shuffle``)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 collate: Callable = pad_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.collate = collate
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return math.ceil(len(self.dataset) / self.batch_size)

    def __iter__(self) -> Iterator:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            yield self.collate([self.dataset[j] for j in idx[i: i + self.batch_size]])


def slm_batch_from_collated(collated) -> Tuple:
    """(src, tgt, lens, mask, ids, names) -> (src_v, tgt, src_a, mask),
    splitting the 824 speaker features into 56 motion + 768 audio."""
    src, tgt, _lens, mask, _ids, _names = collated
    return (src[..., :56], tgt, src[..., 56:], mask)
