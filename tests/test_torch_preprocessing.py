"""The port's offline tools against the JAX package on the CPU:
``data/preprocessing.py``, ``metrics/baselines.py`` with
``eval_utils.calculate_variance``, ``render.data.load_clip_dirs`` and the
nine subcommands of ``cli/preprocess.py``.

The numeric cores take the cases of ``tests/test_preprocessing_baselines.py``
and give the JAX package's values bitwise (the same numpy operations in the
same order; the Frechet distances within 1e-12). Each subcommand's
``--synthetic`` run writes the same file tree as JAX's, every file's bytes
equal (videos compared frame by frame after decoding, and the LMDB entry by
entry, its PNG frames by their pixels); ``render-prep-lmdb`` reads back
through the port's ``VoxLmdbDataset``. The video subcommands need
OpenCV and skip without it, as the JAX package's tests do.
"""

import os

import numpy as np
import pytest

from dyadic_interaction_modeling_tpu.cli import preprocess as JCLI
from dyadic_interaction_modeling_tpu.data import preprocessing as JPP
from dyadic_interaction_modeling_tpu.metrics import baselines as JB
from dyadic_interaction_modeling_tpu.metrics import eval_utils as JE
from dyadic_interaction_modeling_tpu.render import data as JRD
from dyadic_interaction_modeling_tpu_torch.cli import preprocess as TCLI
from dyadic_interaction_modeling_tpu_torch.data import preprocessing as TPP
from dyadic_interaction_modeling_tpu_torch.metrics import baselines as TB
from dyadic_interaction_modeling_tpu_torch.metrics import eval_utils as TE
from dyadic_interaction_modeling_tpu_torch.render import data as TRD
from dyadic_interaction_modeling_tpu_torch.render.image_io import SIGNATURE, decode_rgb
from dyadic_interaction_modeling_tpu_torch.utils.lmdb_lite import LmdbReader


def same(a, b):
    """Equal values of equal type, recursively (arrays bitwise)."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == object:
            for x, y in zip(a.ravel(), b.ravel()):
                same(x, y)
        else:
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert a == b


def both(name, *args, **kw):
    """A function of the port and of the JAX package on the same inputs."""
    port = getattr(TPP, name, None) or getattr(TB, name)
    ref = getattr(JPP, name, None) or getattr(JB, name)
    got, want = port(*args, **kw), ref(*args, **kw)
    same(got, want)
    return got


def test_rate_conversion_and_mel_features_are_jax_bitwise():
    x = np.arange(100, dtype=np.float64)[:, None].repeat(3, 1)
    out = both("downsample_mean", x, 0.6)
    assert out.shape == (60, 3) and np.array_equal(out[:, 0], np.arange(60))
    assert both("downsample_mean", np.arange(50, dtype=np.float64)[:, None], 0.6).shape == (30, 1)
    rng = np.random.RandomState(0)
    both("downsample_mean", rng.randn(137, 5), 0.6)
    assert both("avg_pool_audio", rng.randn(105, 768), 10).shape == (10, 768)

    sr = 16000
    wave = np.sin(2 * np.pi * 440 * np.arange(sr) / sr).astype(np.float32)
    s = both("melspectrogram", wave, sr)
    assert s.shape[0] == 128 and 95 <= s.shape[1] <= 105
    fb = both("mel_filterbank", sr, 512)
    peak = int(np.argmax(s.sum(axis=1)))
    assert 300 < np.linspace(0, sr / 2, fb.shape[1])[np.argmax(fb[peak])] < 650
    both("mel_filterbank", 22050, 2048, 80, 50.0, 8000.0)
    noise = np.random.RandomState(0).randn(16000).astype(np.float32)
    assert both("load_melspec_features", noise, num_frames=30).shape == (128, 120)


def test_dataset_assembly_is_jax_bitwise(tmp_path):
    rng = np.random.RandomState(0)
    audio = rng.randn(500, 768)
    video = {s: {str(i).zfill(6): rng.randn(56) for i in range(60)} for s in ("A", "B")}
    rows = [("utt1", "A", 0.2, 2.0), ("utt2", "B", 2.0, 4.0), ("utt3", "A", 11.0, 13.0)]
    out = both("candor_utterance_windows", rows, audio, video)
    assert set(out) == {"utt1", "utt2"}  # utt3 runs past the video: skipped
    assert out["utt1"]["listener"]["video"].shape == (9, 56)

    clip = both("vico_process_clip", rng.randn(100, 768), rng.randn(70, 56), rng.randn(65, 56))
    assert clip["audio"].shape == (60, 768)

    win = both("l2l_export_windows", rng.randn(200, 56), rng.randn(200, 56),
               rng.randn(16000 * 4).astype(np.float32), "clipX")
    assert len(win["speak_faces"]) == 2 and win["speak_audio"][0].shape == (256, 128)

    for i in range(4):
        d = tmp_path / "emoca" / f"{i:06d}"
        d.mkdir(parents=True)
        for name, n in (("pose", 6), ("exp", 50), ("detail", 128)):
            np.save(d / f"{name}.npy", rng.randn(n).astype(np.float32))
    (tmp_path / "emoca" / "skipped").mkdir()
    assert both("read_emoca_frames", str(tmp_path / "emoca")).shape == (4, 56)
    assert both("read_emoca_frames", str(tmp_path / "emoca"), order="exp_pose_detail",
                with_detail=True).shape == (4, 184)


def test_baselines_and_variance_match_jax():
    rng = np.random.default_rng(0)
    train_l = [rng.standard_normal((64, 56)) for _ in range(6)]
    train_s = [rng.standard_normal((64, 56)) for _ in range(6)]
    train_a = [rng.standard_normal((64, 20)) for _ in range(6)]
    test_s = [rng.standard_normal((64, 56)) for _ in range(4)]
    test_l = [rng.standard_normal((64, 56)) for _ in range(4)] + [rng.standard_normal((60, 56))]
    test_a = [rng.standard_normal((64, 20)) for _ in range(5)]
    test_s = test_s + [rng.standard_normal((64, 56))]
    ids = ["a", "a", "b", "b", "c"]  # c's windows are short: dropped
    pred, gt, x = TB.random_retrieval_baseline(train_l, test_s, test_l, ids,
                                               np.random.default_rng(3))
    same((pred, gt, x), JB.random_retrieval_baseline(train_l, test_s, test_l, ids,
                                                     np.random.default_rng(3)))
    assert len(pred) == 2
    pm = both("nn_motion_baseline", train_s, train_l, test_s, test_l, ids)
    pa = both("nn_audio_baseline", train_a, train_l, test_a, test_l, test_s, ids)
    assert len(pm[0]) == len(pa[0]) == 2
    for g, p in ((gt, pred), (pm[1], pm[0]), (pa[1], pa[0])):
        got, want = TB.score_baseline(g, p), JB.score_baseline(g, p)
        assert set(got) == set(want) == {"fid_exp", "fid_pose"}
        for k in got:
            assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k]))
    for a in (train_l[0], np.concatenate(train_s)):
        assert TE.calculate_variance(a) == JE.calculate_variance(a)


# --- the CLI ----------------------------------------------------------------

def tree(root):
    """{relative path: file} under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def video_frames(path):
    import cv2

    cap, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def same_lmdb(port_env, jax_env):
    """The same keys and values; a PNG value may be encoded otherwise (the
    port writes PNG itself, the JAX package through Pillow) but has the same
    pixels."""
    with LmdbReader(port_env) as a, LmdbReader(jax_env) as b:
        got, want = dict(a.items()), dict(b.items())
    assert list(got) == list(want) and got
    for key, value in got.items():
        if value[:8] == SIGNATURE:
            same(decode_rgb(value), decode_rgb(want[key]))
        else:
            assert value == want[key], key


def same_trees(port_root, jax_root):
    port, ref = tree(port_root), tree(jax_root)
    assert sorted(port) == sorted(ref) and port
    for rel, p in port.items():
        if rel.endswith(".mp4"):  # an encoder may stamp its files
            same(video_frames(p), video_frames(ref[rel]))
            continue
        if rel.endswith("data.mdb"):
            same_lmdb(os.path.dirname(p), os.path.dirname(ref[rel]))
            continue
        with open(p, "rb") as f, open(ref[rel], "rb") as g:
            assert f.read() == g.read(), rel


def run_both(tmp_path, argv):
    a, b = tmp_path / "port", tmp_path / "jax"
    got = TCLI.main([*argv, "--synthetic", "--out", str(a)])
    want = JCLI.main([*argv, "--synthetic", "--out", str(b)])
    return got, want, a, b


@pytest.mark.parametrize("sub,count", [
    ("candor", 2), ("vico", 1), ("vico-l2l", 1), ("elp", 1), ("l2l", 2), ("voca", 3)])
def test_subcommand_writes_the_jax_tree(tmp_path, sub, count):
    got, want, a, b = run_both(tmp_path, [sub])
    assert got == want == count
    same_trees(a, b)


def test_video_subcommands_write_the_jax_tree(tmp_path):
    pytest.importorskip("cv2")
    got, want, a, b = run_both(tmp_path / "deception", ["deception"])
    assert got == want == 1
    same_trees(a, b)
    got, want, a, b = run_both(tmp_path / "prep", ["render-prep", "--resolution", "64"])
    assert (got, want) == (str(a), str(b))
    same_trees(a, b)
    clips, ref = TRD.load_clip_dirs(str(a), resolution=64), JRD.load_clip_dirs(str(b), resolution=64)
    assert [c["name"] for c in clips] == ["clipA", "clipB"]
    for c, r in zip(clips, ref):
        assert c["frames"].shape == (6, 64, 64, 3) and c["coeffs"].shape == (6, 56)
        same(c, r)
    # a resize on reading goes through Pillow, as JAX's reader resizes
    for c, r in zip(TRD.load_clip_dirs(str(a), resolution=32, max_clips=1),
                    JRD.load_clip_dirs(str(b), resolution=32, max_clips=1)):
        same(c, r)


def test_render_prep_lmdb_reads_back_through_the_port(tmp_path):
    pytest.importorskip("cv2")
    got, want, a, b = run_both(tmp_path, ["render-prep-lmdb", "--resolution", "64",
                                          "--img-format", "png"])
    assert (got, want) == (str(a), str(b))
    same_trees(a, b)
    ds = TRD.VoxLmdbDataset(str(a), resolution=64, multiplier=1)
    assert sorted(v["video_name"] for v in ds.video_items) == ["clipA", "clipB"]
    item = ds[0]
    assert item["source_image"].shape == (64, 64, 3)
    assert item["source_semantics"].shape == (73, 27)
