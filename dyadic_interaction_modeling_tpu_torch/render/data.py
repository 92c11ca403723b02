"""PIRender's inference data (reference ``Pirender/data/vox_dataset.py``,
``vox_video_dataset.py``).

Counterpart of the inference side of
``dyadic_interaction_modeling_tpu/render/data.py``, numpy in and numpy out,
images (H, W, 3) in [-1, 1]:

* ``semantic_window``: the coefficient window of radius ``semantic_radius``
  around a frame, clamped at the clip's ends -> (C, 2r + 1),
* ``FramePairDataset`` / ``synthetic_render_dataset``: source and target
  frames of one clip with their windows,
* ``VoxLmdbDataset`` / ``VoxVideoDataset``: the reference's prepared-VoxCeleb
  LMDB (``utils.lmdb_lite``), item for item as the JAX package draws them
  from Python's ``random.Random(seed)``,
* ``emoca_to_coeff3dmm``, ``write_vox_lmdb`` (that LMDB layout) and
  ``load_coeff_dir_clip`` (an exported EMOCA coefficient directory).

* ``load_clip_dirs``: rendered clips on disk (frames and an exported
  coefficient directory a clip) as ``FramePairDataset`` clips.

PNG frames go through ``render.image_io``; JPEG frames and resizing through
Pillow. The training side (the datasets' ``batches``, ``VoxLMDirDataset``)
comes with the renderer's trainer.
"""

from __future__ import annotations

import os
import random
from io import BytesIO
from typing import Dict, Sequence

import numpy as np

from ..utils.lmdb_lite import LmdbReader, format_for_lmdb, write_lmdb
from .image_io import decode_rgb, encode_png, pillow, read_rgb


def semantic_window(coeffs: np.ndarray, frame_index: int, radius: int) -> np.ndarray:
    """(T, C) coefficients -> (C, 2r+1) window centred at the frame, indices
    clamped to the clip (the reference clamps with max/min)."""
    t = coeffs.shape[0]
    idx = [min(max(i, 0), t - 1)
           for i in range(frame_index - radius, frame_index + radius + 1)]
    return coeffs[idx].T.astype(np.float32)


class FramePairDataset:
    """Items: dict(source_image, target_image, source_semantics,
    target_semantics), the FaceTrainer batch contract."""

    def __init__(self, clips: Sequence[Dict], semantic_radius: int = 13,
                 minimal_sample_distance: int = 1, seed: int = 0):
        """clips: list of {'frames': (T, H, W, 3) in [-1, 1], 'coeffs': (T, C)}."""
        self.clips = list(clips)
        self.radius = semantic_radius
        self.min_dist = minimal_sample_distance
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        clip = self.clips[index]
        t = clip["frames"].shape[0]
        i = self.rng.randrange(t)
        j = self.rng.randrange(t)
        while abs(i - j) < self.min_dist and t > self.min_dist:
            j = self.rng.randrange(t)
        return {
            "source_image": clip["frames"][i],
            "target_image": clip["frames"][j],
            "source_semantics": semantic_window(clip["coeffs"], i, self.radius),
            "target_semantics": semantic_window(clip["coeffs"], j, self.radius),
        }


def synthetic_render_dataset(n_clips: int = 2, frames_per_clip: int = 8,
                             resolution: int = 64, coeff_dim: int = 58,
                             semantic_radius: int = 13,
                             seed: int = 0) -> FramePairDataset:
    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(n_clips):
        base = rng.uniform(-0.5, 0.5, (1, resolution, resolution, 3))
        drift = rng.normal(0, 0.05, (frames_per_clip, 1, 1, 3))
        frames = np.clip(base + drift, -1, 1).astype(np.float32)
        coeffs = rng.normal(0, 0.3, (frames_per_clip, coeff_dim)).astype(np.float32)
        clips.append({"frames": frames, "coeffs": coeffs})
    return FramePairDataset(clips, semantic_radius=semantic_radius)


class VoxLmdbDataset:
    """The reference's prepared-VoxCeleb LMDB data.

    Layout (``prepare_vox_lmdb.py`` -> ``vox_dataset.py:345-449``): an LMDB
    environment at ``{root}/{resolution}`` with keys ``{video}-{frame:07d}``
    (encoded image bytes), ``{video}-length`` and ``{video}-coeff_3dmm``
    (float32 (T, 260) Deep3DFace coefficients + crop), plus
    ``{root}/train_list.txt`` / ``test_list.txt``. Items follow
    ``VoxDataset_old.__getitem__``: a person, a random video of theirs, two
    random frames (vox_dataset.py:434-437), images to [-1, 1], semantics by
    ``transform_semantic``: exp[80:144], angles[224:227],
    translation[254:257] and crop[257:260], a 73-d vector windowed at
    ``semantic_radius`` (vox_dataset.py:439-460).
    """

    def __init__(self, root: str, resolution: int = 256,
                 is_inference: bool = False, semantic_radius: int = 13,
                 multiplier: int = 100, seed: int = 0):
        self.env = LmdbReader(os.path.join(root, str(resolution)))
        self.radius = semantic_radius
        list_file = os.path.join(
            root, "test_list.txt" if is_inference else "train_list.txt")
        with open(list_file) as f:
            videos = [ln.strip() for ln in f if ln.strip()]
        self.video_items = []
        for name in videos:
            length = int(self.env.get(format_for_lmdb(name, "length")).decode())
            self.video_items.append(
                {"video_name": name, "person_id": name.split("#")[0],
                 "num_frame": length})
        self.person_ids = sorted({v["video_name"].split("#")[0]
                                  for v in self.video_items})
        self.idx_by_person = {}
        for i, v in enumerate(self.video_items):
            self.idx_by_person.setdefault(v["person_id"], []).append(i)
        # the reference repeats persons x100 so an "epoch" is long
        # (vox_dataset.py:370)
        self.person_ids = self.person_ids * multiplier
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.person_ids)

    def _decode_image(self, raw: bytes) -> np.ndarray:
        return decode_rgb(raw).astype(np.float32) / 127.5 - 1.0

    def _semantics(self, coeffs: np.ndarray, frame: int) -> np.ndarray:
        win = semantic_window(coeffs, frame, self.radius)  # (260, 2r+1)
        return np.concatenate([win[80:144], win[224:227], win[254:257],
                               win[257:260]], axis=0)

    def _coeffs(self, item: Dict) -> np.ndarray:
        return np.frombuffer(self.env.get(format_for_lmdb(item["video_name"], "coeff_3dmm")),
                             dtype=np.float32).reshape(item["num_frame"], -1)

    def _frame(self, name: str, index: int) -> np.ndarray:
        return self._decode_image(self.env.get(format_for_lmdb(name, index)))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        person = self.person_ids[index]
        item = self.video_items[self.rng.choice(self.idx_by_person[person])]
        name, t = item["video_name"], item["num_frame"]
        i, j = self.rng.randrange(t), self.rng.randrange(t)
        coeffs = self._coeffs(item)
        return {
            "source_image": self._frame(name, i),
            "target_image": self._frame(name, j),
            "source_semantics": self._semantics(coeffs, i),
            "target_semantics": self._semantics(coeffs, j),
        }


class VoxVideoDataset(VoxLmdbDataset):
    """Whole-video reenactment data over the prepared-VoxCeleb LMDB
    (reference ``Pirender/data/vox_video_dataset.py:14-102``).

    ``load_next_video`` yields one clip at a time: the source frame (frame 0
    of the driving clip, or with ``cross_id`` of a random other person's
    clip), every target frame, and the per-frame 73-d windows. With
    ``cross_id`` and ``norm_crop_param`` the crop-scale column (257) is
    renormalised by the source / target ratio at the target frame nearest
    the source in expression and pose (vox_video_dataset.py:72-78, 91-92).
    """

    def __init__(self, root: str, resolution: int = 256,
                 is_inference: bool = True, semantic_radius: int = 13,
                 cross_id: bool = False, norm_crop_param: bool = True,
                 seed: int = 0):
        super().__init__(root, resolution, is_inference, semantic_radius,
                         multiplier=1, seed=seed)
        self.video_index = -1
        self.cross_id = cross_id
        self.norm_crop_param = norm_crop_param

    def __len__(self):
        return len(self.video_items)

    def _random_video(self, target_item: Dict) -> Dict:
        """Reference quirk kept: on drawing the target's own person it draws
        again exactly once (vox_video_dataset.py:62-70), so a same-person
        "cross" pairing is possible with three persons or more."""
        persons = sorted(self.idx_by_person)
        if len(persons) < 2:
            raise ValueError("cross_id needs at least two persons")
        pid = self.rng.choice(persons)
        if pid == target_item["person_id"]:
            pid = self.rng.choice(persons)
        return self.video_items[self.rng.choice(self.idx_by_person[pid])]

    @staticmethod
    def find_crop_norm_ratio(source_coeff: np.ndarray,
                             target_coeffs: np.ndarray) -> np.ndarray:
        """vox_video_dataset.py:72-78: the target frame nearest the source
        in 0.3 |exp| + 0.7 |angles| gives the crop-scale ratio."""
        alpha = 0.3
        exp_diff = np.mean(np.abs(target_coeffs[:, 80:144]
                                  - source_coeff[:, 80:144]), 1)
        angle_diff = np.mean(np.abs(target_coeffs[:, 224:227]
                                    - source_coeff[:, 224:227]), 1)
        index = int(np.argmin(alpha * exp_diff + (1 - alpha) * angle_diff))
        return source_coeff[:, -3] / target_coeffs[index: index + 1, -3]

    def load_next_video(self) -> Dict:
        self.video_index += 1
        item = self.video_items[self.video_index]
        src_item = self._random_video(item) if self.cross_id else item
        name, t = item["video_name"], item["num_frame"]
        coeffs = self._coeffs(item).copy()
        if self.cross_id and self.norm_crop_param:
            coeffs[:, 257] *= self.find_crop_norm_ratio(self._coeffs(src_item)[0:1], coeffs)
        source_image = self._frame(src_item["video_name"], 0)
        target_images = np.stack([self._frame(name, f) for f in range(t)])
        semantics = np.stack([self._semantics(coeffs, f) for f in range(t)])
        out_name = name if not self.cross_id else (
            os.path.splitext(os.path.basename(
                src_item["video_name"]))[0] + "_to_" + name)
        return {"source_image": source_image, "target_images": target_images,
                "target_semantics": semantics, "video_name": out_name}


def emoca_to_coeff3dmm(emoca: np.ndarray,
                       crop: "np.ndarray | None" = None) -> np.ndarray:
    """EMOCA (T, 56) pose + exp coefficients in the 260-d Deep3DFace layout
    of the LMDB: exp -> [80:130] (of the 64-wide exp slot), pose[:3] ->
    angles [224:227], pose[3:6] -> translation [254:257], an optional crop
    (T, 3) -> [257:260]. The inverse of VoxLmdbDataset's slicing for the
    dimensions EMOCA fills."""
    emoca = np.asarray(emoca, np.float32)
    t = emoca.shape[0]
    out = np.zeros((t, 260), np.float32)
    out[:, 80:80 + emoca.shape[1] - 6] = emoca[:, 6:]
    out[:, 224:227] = emoca[:, 0:3]
    out[:, 254:257] = emoca[:, 3:6]
    if crop is not None:
        out[:, 257:260] = np.asarray(crop, np.float32)
    return out


def _encode_frame(frame: np.ndarray, resolution: int, img_format: str) -> bytes:
    """A uint8 frame as ``img_format`` bytes at ``resolution``: PNG at that
    size through ``image_io``; JPEG, or any resize (bicubic), through Pillow."""
    size = (resolution, resolution)
    if img_format.lower() == "png" and frame.shape[1::-1] == size:
        return encode_png(frame)
    img = pillow().fromarray(frame)
    if img.size != size:
        img = img.resize(size, pillow().BICUBIC)
    buf = BytesIO()
    img.save(buf, format=img_format)
    return buf.getvalue()


def write_vox_lmdb(root: str, clips: Dict[str, Dict], resolution: int = 256,
                   test_names: Sequence[str] = (), img_format: str = "jpeg"):
    """Write clips in the reference's prepared-data layout
    (``prepare_vox_lmdb.py:120-143``): an LMDB environment at
    ``{root}/{resolution}`` plus the train and test list files.

    clips: ``{video_name: {'frames': (T, H, W, 3) in [-1, 1] or uint8,
    'coeff_3dmm': (T, 260) float32}}`` (``emoca_to_coeff3dmm`` builds the
    260-d rows from EMOCA's 56-d exports). ``img_format`` "png" needs no
    Pillow when the frames are ``resolution`` square.
    """
    os.makedirs(root, exist_ok=True)
    items = [(format_for_lmdb("length"), format_for_lmdb(len(clips)))]
    for name, clip in clips.items():
        frames = np.asarray(clip["frames"])
        if frames.dtype != np.uint8:
            frames = ((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)
        items.append((format_for_lmdb(name, "length"),
                      format_for_lmdb(len(frames))))
        for fi, frame in enumerate(frames):
            items.append((format_for_lmdb(name, fi),
                          _encode_frame(frame, resolution, img_format)))
        coeff = np.ascontiguousarray(clip["coeff_3dmm"], np.float32)
        items.append((format_for_lmdb(name, "coeff_3dmm"), coeff.tobytes()))
    write_lmdb(os.path.join(root, str(resolution)), items)
    test_set = set(test_names)
    for fname, keep in (("train_list.txt", lambda n: n not in test_set),
                        ("test_list.txt", lambda n: n in test_set)):
        with open(os.path.join(root, fname), "w") as f:
            for name in clips:
                if keep(name):
                    f.write(name + "\n")


def load_coeff_dir_clip(clip_dir: str, pose_first: bool = True) -> np.ndarray:
    """An exported EMOCA coefficient directory ({frame}/pose.npy, exp.npy,
    optionally cam.npy and shape.npy) -> (T, 56+) coefficients, the
    inference input (Pirender/inference_newmodel.py)."""
    frames = []
    for d in sorted(os.listdir(clip_dir)):
        fd = os.path.join(clip_dir, d)
        if not os.path.isdir(fd):
            continue
        pose = np.load(os.path.join(fd, "pose.npy"))
        exp = np.load(os.path.join(fd, "exp.npy"))
        parts = [pose, exp] if pose_first else [exp, pose]
        for extra in ("cam", "shape"):
            p = os.path.join(fd, f"{extra}.npy")
            if os.path.exists(p):
                parts.append(np.load(p).reshape(-1))
        frames.append(np.concatenate(parts, axis=0))
    return np.asarray(frames, dtype=np.float32)


def load_clip_dirs(root: str, frames_subdir: str = "frames",
                   coeffs_subdir: str = "coeffs", resolution: int = 256,
                   max_clips: int = 0) -> list:
    """Rendered clips on disk -> ``FramePairDataset`` clips, one directory a
    clip (the ViCo/VoxCeleb export convention):

        root/<clip_id>/frames/00000.png ...     RGB frames
        root/<clip_id>/coeffs/<frame>/pose.npy, exp.npy[, cam.npy, shape.npy]

    Frames load to [-1, 1] (H, W, 3) at ``resolution`` (``image_io.read_rgb``:
    a PNG at that size without Pillow, a resize or a JPEG through it);
    coefficients through ``load_coeff_dir_clip``, so a directory that
    ``postprocess.export_emoca_dirs`` wrote is read as it is. Clips under 2
    frames are skipped, and a clip keeps as many frames as it has both
    images and coefficients for.
    """
    clips = []
    for clip_id in sorted(os.listdir(root)):
        cdir = os.path.join(root, clip_id)
        fdir = os.path.join(cdir, frames_subdir)
        codir = os.path.join(cdir, coeffs_subdir)
        if not (os.path.isdir(fdir) and os.path.isdir(codir)):
            continue
        names = sorted(f for f in os.listdir(fdir) if f.endswith((".png", ".jpg", ".jpeg")))
        coeffs = load_coeff_dir_clip(codir)
        n = min(len(names), coeffs.shape[0])
        if n < 2:
            continue
        frames = np.stack([read_rgb(os.path.join(fdir, f), (resolution, resolution))
                           .astype(np.float32) / 127.5 - 1.0 for f in names[:n]])
        clips.append({"name": clip_id, "frames": frames, "coeffs": coeffs[:n]})
        if max_clips and len(clips) >= max_clips:
            break
    return clips
