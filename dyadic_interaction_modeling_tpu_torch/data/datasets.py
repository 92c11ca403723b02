"""Readers of the reference's ViCo, CANDOR and BIWI files.

A copy of the ViCo and CANDOR readers of
``dyadic_interaction_modeling_tpu/data/datasets.py:38-177`` (the reference's
``dataset/data_loader.py:44-206, 357-387``), with their quirks:

* ``ViCoDataset``: a pickle a clip with ``video_speaker`` / ``video_listener``
  / ``audio``; the speaker video is REPLACED BY ONES (``data_loader.py:147``);
  sentiment and the speaker and listener ids come from ``RLD_data.csv``;
  clips keep 5 <= len <= 1024 with their three streams aligned.
* ``ViCoListenerDataset`` / ``ViCoSpeakerDataset``: one stream of those clips.
* ``LmListenerDataset`` (JAX ``:192``): LM-Listener's ``segments_{mode}.pth``
  (HuBERT features interpolated to the motion, 24-frame minimum, chunks of
  1024 frames).
* ``candor_split``: speaker/listener utterance pickles, split 95/5 by
  conversation id with ``random.Random(42)``, 5 <= len <= 250.
* ``read_biwi_emoca_data`` / ``BiwiEmocaDataset`` (JAX ``:243-364``, the
  reference's ``dataset/biwi.py:37-166``): a BIWI tree of ``wav/``,
  ``vertices_npy/``, ``emoca_biwi/*.pkl`` and ``templates.pkl``; a clip that
  fails to read is skipped; split by subject and sentence, val equal to
  test (sentences 37-40); audio features interpolated to the vertex frames.
* ``BiwiDataset`` (JAX ``:366-447``, the reference's
  ``data_loader.py:14-42, 247-307``): the stage-2 (CodeTalker) reader of the
  same tree without EMOCA, split by ``BIWI_SPLITS``; with ``read_audio`` the
  raw 16 kHz waveform, normalized as HF's ``Wav2Vec2Processor`` does.

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
from typing import Any, Dict, List, Sequence, Tuple

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


def _interp_to_length(array: np.ndarray, new_t: int) -> np.ndarray:
    """torch ``F.interpolate(mode='linear', align_corners=True)`` over time
    (biwi.py:37-43)."""
    t = array.shape[0]
    if t == new_t:
        return np.asarray(array, np.float32)
    pos = np.linspace(0.0, t - 1.0, new_t)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = (pos - lo)[:, None]
    return (array[lo] * (1 - w) + array[hi] * w).astype(np.float32)


class LmListenerDataset:
    """LM-Listener segments (``segments_{mode}.pth``; the reference's
    ``data_loader.py:208-245`` + ``l2l.py:31-76``): pose and expression
    concatenated; the precomputed ``hubert_feat`` audio interpolated to the
    motion length (a split whose start equals its end skipped), or zero
    768-d audio; clips of mismatched lengths or under 24 frames skipped; a
    clip of ``chunk`` frames or more cut into ``chunk``-frame pieces.
    Items: (speaker pose+exp || audio (L, 56 + 768), listener pose+exp
    (L, 56), fname)."""

    def __init__(self, data_path: str, mode: str = "train", chunk: int = 1024,
                 use_hubert: bool = True):
        import torch

        payload = torch.load(os.path.join(data_path, f"segments_{mode}.pth"),
                             map_location="cpu", weights_only=False)
        self.data = []
        for item in payload:
            if use_hubert and "hubert_feat" in item:
                s, e = item.get("split_start_time"), item.get("split_end_time")
                if s is not None and s == e:
                    continue  # l2l.py:41-43
                item = dict(item)
                item["hubert_feat"] = _interp_to_length(
                    np.asarray(item["hubert_feat"]), len(item["p0_exp"]))
            if len(item["p0_exp"]) != len(item["p1_exp"]) or len(item["p0_exp"]) < 24:
                continue
            if len(item["p0_exp"]) < chunk:
                self.data.append(item)
                continue
            keys = ("p0_exp", "p1_exp", "p0_pose", "p1_pose") + (
                ("hubert_feat",) if "hubert_feat" in item else ())
            for j in range(len(item["p0_exp"]) // chunk):
                piece = {k: item[k][j * chunk: (j + 1) * chunk] for k in keys}
                piece["fname"] = item["fname"]
                self.data.append(piece)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int):
        it = self.data[index]
        sp = np.concatenate([np.asarray(it["p1_pose"], np.float32),
                             np.asarray(it["p1_exp"], np.float32)], axis=1)
        li = np.concatenate([np.asarray(it["p0_pose"], np.float32),
                             np.asarray(it["p0_exp"], np.float32)], axis=1)
        if "hubert_feat" in it:
            audio = np.asarray(it["hubert_feat"], np.float32)
        else:
            audio = np.zeros((sp.shape[0], 768), dtype=np.float32)
        return np.concatenate([sp, audio], axis=1), li, it["fname"]


def load_wav_16k(path: str) -> np.ndarray:
    """A 16 kHz mono waveform: soundfile when installed, else the standard
    library's ``wave`` (16-bit PCM); other rates resampled linearly."""
    try:
        import soundfile as sf

        data, sr = sf.read(path, dtype="float32")
        if data.ndim > 1:
            data = data.mean(axis=1)
    except ImportError:
        import wave

        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            raw = w.readframes(w.getnframes())
            data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
            if w.getnchannels() > 1:
                data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    if sr != 16000:
        n_out = int(len(data) * 16000 / sr)
        data = np.interp(np.linspace(0, len(data) - 1, n_out),
                         np.arange(len(data)), data).astype(np.float32)
    return data


class BiwiEmocaDataset:
    """BIWI speaker items (biwi.py:45-66): (audio features interpolated to
    the vertex-frame count, vertices, template, EMOCA, name), or without
    ``read_audio`` the last four."""

    def __init__(self, items: Sequence[Dict], data_type: str = "train",
                 read_audio: bool = True):
        self.items = list(items)
        self.data_type = data_type
        self.read_audio = read_audio

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int):
        d = self.items[index]
        vertice = np.asarray(d["vertice"], np.float32)
        template = np.asarray(d["template"], np.float32)
        emoca = np.asarray(d["emoca"], np.float32)
        if self.read_audio:
            audio = _interp_to_length(np.asarray(d["audio"]), vertice.shape[0])
            return audio, vertice, template, emoca, d["name"]
        return vertice, template, emoca, d["name"]


# the speaker reader's sentence splits: val == test == 37-40 (biwi.py:151-152)
BIWI_EMOCA_SPLITS = {
    "vocaset": {"train": range(1, 41), "val": range(21, 41), "test": range(21, 41)},
    "BIWI": {"train": range(1, 33), "val": range(37, 41), "test": range(37, 41)},
}
BIWI_EMOCA_TRAIN_SUBJECTS = "F2 F3 F4 M3 M4 M5"
BIWI_EMOCA_TEST_SUBJECTS = "F1 F5 F6 F7 F8 M1 M2 M6"


def read_biwi_emoca_data(data_root: str, hubert_extractor=None, *,
                         wav_path: str = "wav", vertices_path: str = "vertices_npy",
                         template_file: str = "templates.pkl",
                         emoca_dir: str = "emoca_biwi", dataset: str = "BIWI",
                         train_subjects: str = BIWI_EMOCA_TRAIN_SUBJECTS,
                         val_subjects: str = BIWI_EMOCA_TRAIN_SUBJECTS,
                         test_subjects: str = BIWI_EMOCA_TEST_SUBJECTS):
    """A BIWI tree -> (train, val, test, subjects) item lists for
    ``BiwiEmocaDataset`` (biwi.py:69-166).

    Per wav clip with its vertices: the 16 kHz waveform through
    ``hubert_extractor`` (any callable; None reads no audio, as
    ``read_audio=False``), the subject's template, the vertices (every
    second frame for vocaset), and the EMOCA pose + exp of each frame in
    sorted frame order. A clip whose files fail to read is skipped."""
    audio_dir = os.path.join(data_root, wav_path)
    vert_dir = os.path.join(data_root, vertices_path)
    emoca_root = os.path.join(data_root, emoca_dir)
    templates = _load_pickle_latin1(os.path.join(data_root, template_file))
    data: Dict[str, Dict] = {}
    for r, _, fs in os.walk(audio_dir):
        for fname in sorted(fs):
            if not fname.endswith("wav"):
                continue
            try:
                key = fname.replace("wav", "npy")
                vert_path = os.path.join(vert_dir, key)
                if not os.path.exists(vert_path):
                    continue
                audio = None
                if hubert_extractor is not None:
                    audio = np.asarray(hubert_extractor(
                        load_wav_16k(os.path.join(r, fname))), np.float32)
                subject_id = "_".join(key.split("_")[:-1])
                vertice = np.load(vert_path, allow_pickle=True)
                if dataset == "vocaset":
                    vertice = vertice[::2, :]
                emoca_data = _load_pickle(os.path.join(emoca_root,
                                                       fname.split(".")[0] + ".pkl"))
                emoca = np.array([np.concatenate([emoca_data[f]["pose"], emoca_data[f]["exp"]])
                                  for f in sorted(emoca_data.keys())])
                data[key] = {"name": fname, "audio": audio,
                             "template": np.asarray(templates[subject_id]).reshape(-1),
                             "vertice": vertice, "emoca": emoca}
            except Exception:  # noqa: BLE001 - the reference skips a corrupt clip
                continue
    subjects = {"train": train_subjects.split(" "), "val": val_subjects.split(" "),
                "test": test_subjects.split(" ")}
    splits = BIWI_EMOCA_SPLITS[dataset]
    out = {"train": [], "val": [], "test": []}
    for k, v in data.items():
        subject_id = "_".join(k.split("_")[:-1])
        sentence_id = int(k.split(".")[0][-2:])
        for part in ("train", "val", "test"):
            if subject_id in subjects[part] and sentence_id in splits[part]:
                out[part].append(v)
    return out["train"], out["val"], out["test"], subjects


# the stage-2 reader's sentence splits (data_loader.py:282-285)
BIWI_SPLITS = {
    "vocaset": {"train": range(1, 41), "val": range(21, 41), "test": range(21, 41)},
    "BIWI": {"train": range(1, 33), "val": range(33, 37), "test": range(37, 41)},
}


class BiwiDataset:
    """BIWI vertices and templates, with the raw audio under ``read_audio``
    (data_loader.py:14-42): items (vertice (L, V*3), template (V*3,),
    one_hot, name), the normalized waveform first with ``read_audio``.
    ``one_hot`` is the subject's row of the training subjects' identity in
    ``train``, the whole identity otherwise."""

    def __init__(self, items: Sequence[Dict], train_subjects: Sequence[str],
                 data_type: str = "train", read_audio: bool = False):
        self.items = list(items)
        self.train_subjects = list(train_subjects)
        self.data_type = data_type
        self.read_audio = read_audio
        self.one_hot_labels = np.eye(len(self.train_subjects), dtype=np.float32)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int):
        d = self.items[index]
        name = d["name"]
        vertice = np.asarray(d["vertice"], dtype=np.float32)
        template = np.asarray(d["template"], dtype=np.float32)
        if self.data_type == "train":
            one_hot = self.one_hot_labels[self.train_subjects.index("_".join(name.split("_")[:-1]))]
        else:
            one_hot = self.one_hot_labels
        if self.read_audio:
            return np.asarray(d["audio"], dtype=np.float32), vertice, template, one_hot, name
        return vertice, template, one_hot, name

    @classmethod
    def read_data(cls, data_root: str, wav_path: str, vertices_path: str, template_file: str,
                  dataset: str, train_subjects: str, val_subjects: str, test_subjects: str,
                  read_audio: bool = False):
        """A BIWI tree -> (train, val, test, subjects) item lists
        (data_loader.py:247-307): a wav clip with its vertices (every second
        frame for vocaset) and its subject's template, the waveform through
        ``load_wav_16k`` and ``processor_normalize`` with ``read_audio``.
        Clips are read in sorted order of their names."""
        from ..models.wav2vec2 import processor_normalize

        audio_dir = os.path.join(data_root, wav_path)
        vert_dir = os.path.join(data_root, vertices_path)
        templates = _load_pickle_latin1(os.path.join(data_root, template_file))
        data: Dict[str, Dict] = {}
        for r, _, fs in os.walk(audio_dir):
            for fname in sorted(fs):
                if not fname.endswith("wav"):
                    continue
                key = fname.replace("wav", "npy")
                vert_path = os.path.join(vert_dir, key)
                if not os.path.exists(vert_path):
                    continue
                vertice = np.load(vert_path, allow_pickle=True)
                if dataset == "vocaset":
                    vertice = vertice[::2, :]
                data[key] = {"name": fname, "vertice": vertice, "audio": None,
                             "template": np.asarray(templates["_".join(key.split("_")[:-1])]
                                                    ).reshape(-1)}
                if read_audio:
                    data[key]["audio"] = processor_normalize(load_wav_16k(os.path.join(r, fname)))
        subjects = {"train": train_subjects.split(" "), "val": val_subjects.split(" "),
                    "test": test_subjects.split(" ")}
        splits = BIWI_SPLITS[dataset]
        out = {"train": [], "val": [], "test": []}
        for k, v in data.items():
            subject_id = "_".join(k.split("_")[:-1])
            sentence_id = int(k.split(".")[0][-2:])
            for part in ("train", "val", "test"):
                if subject_id in subjects[part] and sentence_id in splits[part]:
                    out[part].append(v)
        return out["train"], out["val"], out["test"], subjects


def _load_pickle_latin1(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")
