"""The preprocessing entry points: twins of the reference's offline scripts,
one subcommand each (counterpart of
``dyadic_interaction_modeling_tpu/cli/preprocess.py``):

| subcommand | reference script | output |
|---|---|---|
| candor    | ``preprocessing.py``          | per-utterance speaker/listener pkls |
| vico      | ``vico_preprocessing.py``     | per-clip {audio, video_speaker, video_listener} pkls |
| vico-l2l  | ``vico_preprocessing_l2l.py`` | p0/p1_*_clean_deca.npy window export |
| elp       | ``elp_preprocessing.py``      | {mode}_elp.npy shard list with sentiment |
| l2l       | ``l2l_preprocessing_l2l.py``  | p0/p1_*_clean_deca.npy from segments_{mode}.pth |
| deception | ``preprocess_deception.py``   | left/right split videos |
| voca      | ``voca_preprocessing.py``     | per-camera frame copies |
| render-prep      | (``prepare_vox_lmdb.py``'s input) | the renderer's clip directories |
| render-prep-lmdb | ``prepare_vox_lmdb.py``  | the prepared-VoxCeleb LMDB |

Every subcommand takes ``--synthetic``: a tiny input tree is made under the
output directory and the real pipeline runs over it, the smoke test of the
read -> transform -> write path without the datasets. Nothing here runs a
model, so there is no ``--device``. The video subcommands (deception,
render-prep) need OpenCV, imported where they use it.

Usage: ``python -m dyadic_interaction_modeling_tpu_torch.cli.preprocess <sub> ...``
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import sys

import numpy as np

from ..data import preprocessing as PP
from ..utils.logging import get_logger

WINDOW_KEYS = ("list_faces", "speak_audio", "speak_faces", "speak_files")


# ---------------------------------------------------------------------------
# synthetic input trees
# ---------------------------------------------------------------------------


def _write_emoca_frames(root: str, n: int, rng: np.random.RandomState) -> None:
    for i in range(n):
        d = os.path.join(root, str(i).zfill(6))
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "pose.npy"), rng.randn(6).astype(np.float32))
        np.save(os.path.join(d, "exp.npy"), rng.randn(50).astype(np.float32))
        np.save(os.path.join(d, "detail.npy"), rng.randn(128).astype(np.float32))


def _write_wav(path: str, seconds: float, sr: int = 16000) -> None:
    from scipy.io import wavfile

    t = np.arange(int(seconds * sr)) / sr
    wave = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    wavfile.write(path, sr, wave)


def _read_wav(path: str) -> np.ndarray:
    from scipy.io import wavfile

    sr, w = wavfile.read(path)
    w = w.astype(np.float32)
    if w.dtype != np.float32 or np.abs(w).max() > 2.0:
        w = w / 32768.0
    if w.ndim > 1:
        w = w.mean(axis=1)
    return w


# ---------------------------------------------------------------------------
# candor (preprocessing.py)
# ---------------------------------------------------------------------------


def _candor_synthetic(root: str) -> dict:
    rng = np.random.RandomState(0)
    fid = "conv0"
    os.makedirs(os.path.join(root, "databases", fid, "transcription"), exist_ok=True)
    rows = [["u0", "spkA", 0.0, 2.0] + [""] * 7,
            ["u1", "spkB", 2.0, 4.0] + [""] * 7]
    with open(os.path.join(root, "databases", fid, "transcription",
                           "transcript_cliffhanger.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["utterance_id", "speaker", "start", "stop"] + [f"c{i}" for i in range(7)])
        w.writerows(rows)
    os.makedirs(os.path.join(root, "audio_feats"), exist_ok=True)
    with open(os.path.join(root, "audio_feats", f"{fid}.pkl"), "wb") as f:
        pickle.dump([rng.randn(220, 768).astype(np.float32)], f)
    os.makedirs(os.path.join(root, "video_feats"), exist_ok=True)
    for spk in ("spkA", "spkB"):
        feats = {str(i).zfill(6): rng.randn(56).astype(np.float32)
                 for i in range(25)}
        with open(os.path.join(root, "video_feats", f"{fid}_{spk}.pkl"), "wb") as f:
            pickle.dump(feats, f)
    return dict(data=os.path.join(root, "databases"),
                audio_feats=os.path.join(root, "audio_feats"),
                video_feats=os.path.join(root, "video_feats"))


def run_candor(args) -> int:
    logger = get_logger()
    if args.synthetic:
        paths = _candor_synthetic(os.path.join(args.out, "_synthetic_in"))
        args.data, args.audio_feats, args.video_feats = (
            paths["data"], paths["audio_feats"], paths["video_feats"])
    os.makedirs(os.path.join(args.out, "speaker"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "listener"), exist_ok=True)
    written = 0
    for file_id in sorted(os.listdir(args.data)):
        try:
            with open(os.path.join(args.data, file_id, "transcription",
                                   "transcript_cliffhanger.csv")) as f:
                rows = list(csv.reader(f))[1:]
            with open(os.path.join(args.audio_feats, f"{file_id}.pkl"), "rb") as f:
                audio = np.asarray(pickle.load(f)[0])
            speakers = sorted(set(r[1] for r in rows))
            video = {}
            for spk in speakers:
                with open(os.path.join(args.video_feats,
                                       f"{file_id}_{spk}.pkl"), "rb") as f:
                    video[spk] = pickle.load(f)
        except Exception:
            logger.warning(f"Error processing {file_id}")
            continue
        windows = PP.candor_utterance_windows(rows, audio, video)
        for uid, feats in windows.items():
            unique = f"{file_id}_{uid}"
            with open(os.path.join(args.out, "speaker", f"{unique}.pkl"), "wb") as f:
                pickle.dump(feats["speaker"], f, protocol=pickle.HIGHEST_PROTOCOL)
            with open(os.path.join(args.out, "listener", f"{unique}.pkl"), "wb") as f:
                pickle.dump(feats["listener"], f, protocol=pickle.HIGHEST_PROTOCOL)
            written += 1
    logger.info(f"candor: wrote {written} utterance pairs to {args.out}")
    return written


# ---------------------------------------------------------------------------
# vico (vico_preprocessing.py)
# ---------------------------------------------------------------------------


def _vico_synthetic(root: str) -> dict:
    rng = np.random.RandomState(1)
    os.makedirs(os.path.join(root, "audio_feats"), exist_ok=True)
    with open(os.path.join(root, "audio_feats", "clip0.pkl"), "wb") as f:
        pickle.dump([rng.randn(200, 768).astype(np.float32)], f)
    for role, name in (("spk", "v_spk0"), ("lst", "v_lst0")):
        _write_emoca_frames(os.path.join(root, "video_feats", name,
                                         "EMOCA_v2_lr_mse_20"), 100, rng)
    with open(os.path.join(root, "mapping.csv"), "w", newline="") as f:
        csv.writer(f).writerows([["id", "listener", "speaker"],
                                 ["clip0", "v_lst0", "v_spk0"]])
    return dict(audio_feats=os.path.join(root, "audio_feats"),
                video_feats=os.path.join(root, "video_feats"),
                mapping=os.path.join(root, "mapping.csv"))


def _read_mapping(path: str) -> dict:
    """id -> (speaker_dir, listener_dir) from a csv with id,listener,speaker
    columns (the reference reads this from its dataset csv)."""
    out = {}
    with open(path) as f:
        for row in list(csv.reader(f))[1:]:
            out[row[0]] = (row[2], row[1])
    return out


def run_vico(args) -> int:
    logger = get_logger()
    if args.synthetic:
        paths = _vico_synthetic(os.path.join(args.out, "_synthetic_in"))
        args.audio_feats, args.video_feats, args.mapping = (
            paths["audio_feats"], paths["video_feats"], paths["mapping"])
    mapping = _read_mapping(args.mapping)
    os.makedirs(args.out, exist_ok=True)
    written = 0
    for fname in sorted(os.listdir(args.audio_feats)):
        uid = fname.split(".")[0]
        if uid not in mapping:
            logger.warning(f"erron on {uid}")  # reference's message
            continue
        spk_dir, lst_dir = mapping[uid]
        with open(os.path.join(args.audio_feats, fname), "rb") as f:
            audio = np.asarray(pickle.load(f)[0])
        spk = PP.read_emoca_frames(
            os.path.join(args.video_feats, spk_dir, "EMOCA_v2_lr_mse_20"))
        lst = PP.read_emoca_frames(
            os.path.join(args.video_feats, lst_dir, "EMOCA_v2_lr_mse_20"))
        clip = PP.vico_process_clip(audio, spk, lst)
        with open(os.path.join(args.out, f"{uid}.pkl"), "wb") as f:
            pickle.dump(clip, f, protocol=pickle.HIGHEST_PROTOCOL)
        written += 1
    logger.info(f"vico: wrote {written} clips to {args.out}")
    return written


# ---------------------------------------------------------------------------
# vico-l2l (vico_preprocessing_l2l.py) and elp (elp_preprocessing.py)
# ---------------------------------------------------------------------------


def _vico_l2l_synthetic(root: str) -> dict:
    rng = np.random.RandomState(2)
    for role, name in (("spk", "v_spk0"), ("lst", "v_lst0")):
        _write_emoca_frames(os.path.join(root, "video_feats", name,
                                         "EMOCA_v2_lr_mse_20"), 140, rng)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    _write_wav(os.path.join(root, "wavs", "clip0.wav"), seconds=5.0)
    with open(os.path.join(root, "mapping.csv"), "w", newline="") as f:
        csv.writer(f).writerows([["id", "listener", "speaker"],
                                 ["clip0", "v_lst0", "v_spk0"]])
    return dict(video_feats=os.path.join(root, "video_feats"),
                wavs=os.path.join(root, "wavs"),
                mapping=os.path.join(root, "mapping.csv"))


def run_vico_l2l(args) -> int:
    logger = get_logger()
    if args.synthetic:
        paths = _vico_l2l_synthetic(os.path.join(args.out, "_synthetic_in"))
        args.video_feats, args.wavs, args.mapping = (
            paths["video_feats"], paths["wavs"], paths["mapping"])
    mapping = _read_mapping(args.mapping)
    acc = {f"p0_{k}": [] for k in WINDOW_KEYS}
    acc.update({f"p1_{k}": [] for k in WINDOW_KEYS})
    for uid, (spk_dir, lst_dir) in sorted(mapping.items()):
        # l2l format: 184-d exp+pose+detail (vico_preprocessing_l2l.py:150-159)
        spk = PP.read_emoca_frames(
            os.path.join(args.video_feats, spk_dir, "EMOCA_v2_lr_mse_20"),
            order="exp_pose_detail", with_detail=True)
        lst = PP.read_emoca_frames(
            os.path.join(args.video_feats, lst_dir, "EMOCA_v2_lr_mse_20"),
            order="exp_pose_detail", with_detail=True)
        wav = _read_wav(os.path.join(args.wavs, f"{uid}.wav"))
        win = PP.l2l_export_windows(spk, lst, wav, uid)
        # reference quirk: the 'coin flip' is random() < 1.0 - ALWAYS p0
        # (vico_preprocessing_l2l.py:166-185); p1 arrays stay empty
        for k in WINDOW_KEYS:
            acc[f"p0_{k}"].extend(win[k])
    out_dir = os.path.join(args.out, args.mode)
    os.makedirs(out_dir, exist_ok=True)
    for key, vals in acc.items():
        np.save(os.path.join(out_dir, f"{key}_clean_deca.npy"), np.asarray(vals))
    n = len(acc["p0_list_faces"])
    logger.info(f"vico-l2l: wrote {n} windows to {out_dir}")
    return n


def run_elp(args) -> int:
    logger = get_logger()
    if args.synthetic:
        paths = _vico_synthetic(os.path.join(args.out, "_synthetic_in"))
        args.audio_feats, args.video_feats, args.mapping = (
            paths["audio_feats"], paths["video_feats"], paths["mapping"])
        sentiments = {"clip0": 1}
    else:
        sentiments = {}
        if args.sentiment_csv:
            with open(args.sentiment_csv) as f:
                sentiments = {r[0]: int(r[1]) for r in list(csv.reader(f))[1:]}
    mapping = _read_mapping(args.mapping)
    output = []
    for fname in sorted(os.listdir(args.audio_feats)):
        uid = fname.split(".")[0]
        if uid not in mapping:
            logger.warning(f"erron on {uid}")
            continue
        spk_dir, lst_dir = mapping[uid]
        with open(os.path.join(args.audio_feats, fname), "rb") as f:
            audio = np.asarray(pickle.load(f)[0])
        audio30 = PP.downsample_mean(audio, 0.6)
        spk = PP.read_emoca_frames(
            os.path.join(args.video_feats, spk_dir, "EMOCA_v2_lr_mse_20"))
        lst = PP.read_emoca_frames(
            os.path.join(args.video_feats, lst_dir, "EMOCA_v2_lr_mse_20"))
        n = min(audio30.shape[0], spk.shape[0], lst.shape[0])
        for shard in range(n // args.num_frames):
            s, e = shard * args.num_frames, (shard + 1) * args.num_frames
            output.append({"audio": audio30[s:e], "video_speaker": spk[s:e],
                           "video_listener": lst[s:e], "id": uid,
                           "sentiment": sentiments.get(uid, 0)})
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.mode}_elp.npy")
    np.save(path, np.asarray(output, dtype=object), allow_pickle=True)
    logger.info(f"elp: wrote {len(output)} shards to {path}")
    return len(output)


# ---------------------------------------------------------------------------
# l2l (l2l_preprocessing_l2l.py)
# ---------------------------------------------------------------------------


def run_l2l(args) -> int:
    import torch

    logger = get_logger()
    if args.synthetic:
        root = os.path.join(args.out, "_synthetic_in")
        os.makedirs(root, exist_ok=True)
        rng = np.random.RandomState(3)
        data = [{f"p{p}_{k}": torch.from_numpy(
            rng.randn(140, d).astype(np.float32))
            for p in (0, 1) for k, d in (("detail", 128), ("exp", 50), ("pose", 6))}
            | {f"p{p}_speak_audio": torch.from_numpy(
                rng.randn(140 * 4, 128).astype(np.float32)) for p in (0, 1)}
            | {"fname": "seg0"}]
        args.segments = os.path.join(root, f"segments_{args.mode}.pth")
        torch.save(data, args.segments)
    data = torch.load(args.segments, map_location="cpu", weights_only=False)
    acc = {f"p{p}_{k}": [] for p in (0, 1) for k in WINDOW_KEYS}
    target = args.num_frames
    for i, item in enumerate(data):
        for p, q in ((0, 1), (1, 0)):
            pose = np.asarray(item[f"p{p}_pose"])
            exp = np.asarray(item[f"p{p}_exp"])
            detail = np.asarray(item[f"p{p}_detail"])
            faces = np.concatenate([exp, pose, detail], axis=-1)
            other = np.concatenate([np.asarray(item[f"p{q}_exp"]),
                                    np.asarray(item[f"p{q}_pose"]),
                                    np.asarray(item[f"p{q}_detail"])], axis=-1)
            audio = np.asarray(item.get(f"p{q}_speak_audio",
                                        np.zeros((len(faces) * 4, 128), np.float32)))
            for j in range(len(faces) // target):
                s, e = j * target, (j + 1) * target
                if e * 4 > len(audio):
                    continue
                acc[f"p{p}_list_faces"].append(faces[s:e])
                acc[f"p{q}_speak_faces"].append(other[s:e])
                acc[f"p{q}_speak_audio"].append(audio[s * 4: e * 4])
                acc[f"p{q}_speak_files"].append(
                    [[str(item.get("fname", i)), str(q), str(s + t)]
                     for t in range(target)])
    out_dir = os.path.join(args.out, args.mode)
    os.makedirs(out_dir, exist_ok=True)
    for key, vals in acc.items():
        np.save(os.path.join(out_dir, f"{key}_clean_deca.npy"), np.asarray(vals))
    n = len(acc["p0_list_faces"])
    logger.info(f"l2l: wrote {n} p0 windows to {out_dir}")
    return n


# ---------------------------------------------------------------------------
# deception (preprocess_deception.py) / voca (voca_preprocessing.py)
# ---------------------------------------------------------------------------


def run_deception(args) -> int:
    logger = get_logger()
    if args.synthetic:
        import cv2

        root = os.path.join(args.out, "_synthetic_in")
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, "interview.mp4")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (64, 32))
        rng = np.random.RandomState(4)
        for _ in range(10):
            w.write(rng.randint(0, 255, (32, 64, 3), dtype=np.uint8))
        w.release()
        args.videos = root
    n = 0
    for fname in sorted(os.listdir(args.videos)):
        if not fname.endswith(".mp4") or "_left" in fname or "_right" in fname:
            continue
        left, right = PP.split_video_lr(os.path.join(args.videos, fname))
        logger.info(f"deception: {fname} -> {os.path.basename(left)}, "
                    f"{os.path.basename(right)}")
        n += 1
    return n


def run_voca(args) -> int:
    logger = get_logger()
    if args.synthetic:
        root = os.path.join(args.out, "_synthetic_in")
        sent = os.path.join(root, "imagessubject8", "FaceTalk_0", "sentence01")
        os.makedirs(sent, exist_ok=True)
        for cam in ("26_C", "27_C"):
            for i in range(3):
                with open(os.path.join(sent, f"f{i}.{cam}.jpg"), "wb") as f:
                    f.write(b"\xff\xd8\xff\xd9")
        args.original = root
    n = PP.voca_copy_frames(args.original, os.path.join(args.out, "voca_frames"),
                            camera_tag=args.camera,
                            subjects=[int(s) for s in args.subjects.split(",")])
    logger.info(f"voca: copied {n} frames")
    return n


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def run_render_prep(args) -> str:
    """Package videos / frame dirs + per-clip coefficient matrices into the
    renderer's clip-dir layout (``render.data.load_clip_dirs``):

        out/<clip>/frames/00000.png ...
        out/<clip>/coeffs/<frame>/pose.npy, exp.npy

    This is the role ``Pirender/scripts/prepare_vox_lmdb.py`` plays for the
    reference's lmdb VoxDataset; ``render-prep-lmdb`` converts this tree
    into that exact LMDB layout (``render.data.write_vox_lmdb``, pure-Python
    lmdb in ``utils.lmdb_lite``) so the reference's prepared data and ours
    interchange both ways. The upstream keypoint / 3DMM extraction steps
    (``scripts/coeff_detector.py``, ``face_recon_*.py``) depend on external
    pretrained face models that are not bundled - this step consumes their
    OUTPUT: one ``(T, C)`` ``.npy`` coefficient matrix per clip (pose-first,
    default 6+50 EMOCA split).
    """
    from ..postprocess.smoothing import export_emoca_dirs

    logger = get_logger()
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        rng = np.random.RandomState(0)
        src_v = os.path.join(args.out, "_synthetic_videos")
        src_c = os.path.join(args.out, "_synthetic_coeffs")
        os.makedirs(src_c, exist_ok=True)
        import cv2

        for clip in ("clipA", "clipB"):
            os.makedirs(src_v, exist_ok=True)
            path = os.path.join(src_v, f"{clip}.mp4")
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 25, (64, 64))
            for _ in range(6):
                wr.write(rng.randint(0, 255, (64, 64, 3), np.uint8))
            wr.release()
            np.save(os.path.join(src_c, f"{clip}.npy"),
                    rng.randn(6, 56).astype(np.float32))
        args.videos, args.coeffs = src_v, src_c

    import cv2

    n_clips = 0
    for fname in sorted(os.listdir(args.videos)):
        stem, ext = os.path.splitext(fname)
        if ext.lower() not in (".mp4", ".avi", ".mov", ".mkv"):
            continue
        coeff_path = os.path.join(args.coeffs, stem + ".npy")
        if not os.path.exists(coeff_path):
            logger.info(f"render-prep: no coeffs for {stem}, skipped")
            continue
        coeffs = np.load(coeff_path)
        cap = cv2.VideoCapture(os.path.join(args.videos, fname))
        fdir = os.path.join(args.out, stem, "frames")
        os.makedirs(fdir, exist_ok=True)
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok or i >= coeffs.shape[0]:
                break
            frame = cv2.resize(frame, (args.resolution, args.resolution))
            cv2.imwrite(os.path.join(fdir, f"{i:05d}.png"), frame)
            i += 1
        cap.release()
        # frame/coeff lengths must agree for FramePairDataset
        export_emoca_dirs(os.path.join(args.out, stem), "coeffs",
                          coeffs[:i], pose_dims=args.pose_dims,
                          smooth_window=None)
        n_clips += 1
        logger.info(f"render-prep: {stem}: {i} frames")
    logger.info(f"render-prep: wrote {n_clips} clip dirs under {args.out}")
    if args.synthetic:
        # smoke: the produced tree must load through the real reader
        from ..render.data import load_clip_dirs

        clips = load_clip_dirs(args.out, resolution=args.resolution)
        assert len(clips) == n_clips, (len(clips), n_clips)
        logger.info(f"render-prep: load_clip_dirs round-trip OK ({len(clips)})")
    return args.out


def run_render_prep_lmdb(args) -> str:
    """Convert a render-prep clip-dir tree into the reference's prepared
    LMDB layout (``prepare_vox_lmdb.py``): env at ``{out}/{resolution}``
    with ``{clip}-{frame:07d}`` images + ``{clip}-coeff_3dmm`` (T, 260)
    rows (EMOCA coefficients embedded via ``emoca_to_coeff3dmm``), plus
    train/test list files - loadable by BOTH the reference's
    ``VoxDataset_old`` (real liblmdb) and our ``VoxLmdbDataset``."""
    from ..render.data import (
        emoca_to_coeff3dmm,
        load_clip_dirs,
        write_vox_lmdb,
    )

    logger = get_logger()
    if args.synthetic:
        sub_args = argparse.Namespace(
            out=os.path.join(args.out, "_clip_dirs"), synthetic=True,
            videos=None, coeffs=None, resolution=args.resolution,
            pose_dims=6)
        args.clips = run_render_prep(sub_args)
    if not args.clips:
        raise SystemExit("pass --clips <render-prep tree> or --synthetic")
    raw = load_clip_dirs(args.clips, resolution=args.resolution)
    clips = {c["name"]: {"frames": c["frames"],
                         "coeff_3dmm": emoca_to_coeff3dmm(c["coeffs"][:, :56])}
             for c in raw}
    test_names = args.test_clips.split(",") if args.test_clips else []
    write_vox_lmdb(args.out, clips, resolution=args.resolution,
                   test_names=test_names, img_format=args.img_format)
    logger.info(f"render-prep-lmdb: wrote {len(clips)} clips to "
                f"{args.out}/{args.resolution}")
    if args.synthetic:
        from ..render.data import VoxLmdbDataset

        ds = VoxLmdbDataset(args.out, resolution=args.resolution,
                            multiplier=1)
        item = ds[0]
        assert item["source_semantics"].shape[0] == 73
        logger.info("render-prep-lmdb: VoxLmdbDataset round-trip OK")
    return args.out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="DIM preprocessing (reference offline scripts)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--out", type=str, required=True)
        p.add_argument("--synthetic", action="store_true")

    p = sub.add_parser("candor")
    common(p)
    p.add_argument("--data", type=str, help="CANDOR database dir")
    p.add_argument("--audio-feats", type=str)
    p.add_argument("--video-feats", type=str)

    p = sub.add_parser("vico")
    common(p)
    p.add_argument("--audio-feats", type=str)
    p.add_argument("--video-feats", type=str)
    p.add_argument("--mapping", type=str, help="csv: id,listener,speaker")

    p = sub.add_parser("vico-l2l")
    common(p)
    p.add_argument("--video-feats", type=str)
    p.add_argument("--wavs", type=str)
    p.add_argument("--mapping", type=str)
    p.add_argument("--mode", type=str, default="train")

    p = sub.add_parser("elp")
    common(p)
    p.add_argument("--audio-feats", type=str)
    p.add_argument("--video-feats", type=str)
    p.add_argument("--mapping", type=str)
    p.add_argument("--sentiment-csv", type=str, default=None)
    p.add_argument("--mode", type=str, default="test")
    p.add_argument("--num-frames", type=int, default=64)

    p = sub.add_parser("l2l")
    common(p)
    p.add_argument("--segments", type=str, help="segments_{mode}.pth")
    p.add_argument("--mode", type=str, default="train")
    p.add_argument("--num-frames", type=int, default=64)

    p = sub.add_parser("deception")
    common(p)
    p.add_argument("--videos", type=str)

    p = sub.add_parser("voca")
    common(p)
    p.add_argument("--original", type=str)
    p.add_argument("--camera", type=str, default="26_C")
    p.add_argument("--subjects", type=str, default="8")

    p = sub.add_parser("render-prep")
    common(p)
    p.add_argument("--videos", type=str, help="dir of clip videos")
    p.add_argument("--coeffs", type=str,
                   help="dir of per-clip (T, C) coefficient .npy files")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--pose-dims", type=int, default=6)

    p = sub.add_parser("render-prep-lmdb")
    common(p)
    p.add_argument("--clips", type=str,
                   help="render-prep clip-dir tree to convert")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--img-format", type=str, default="jpeg")
    p.add_argument("--test-clips", type=str, default=None,
                   help="comma-separated clip names for test_list.txt")

    args = parser.parse_args(argv)
    runner = {"candor": run_candor, "vico": run_vico, "vico-l2l": run_vico_l2l,
              "elp": run_elp, "l2l": run_l2l, "deception": run_deception,
              "voca": run_voca, "render-prep": run_render_prep,
              "render-prep-lmdb": run_render_prep_lmdb}[args.cmd]
    return runner(args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
