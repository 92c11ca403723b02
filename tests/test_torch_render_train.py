"""PIRender's training side in the port against the JAX package on the CPU:
the datasets' batches, ``VoxLMDirDataset``, the ``use_spect`` refusal, and
the ``render_train`` twin (the three-step ``FaceTrainer`` lockstep with JAX
is in ``tests/test_torch_face_trainer.py``).

* ``batches`` of ``FramePairDataset`` (synthetic clips), ``VoxLmdbDataset``
  (a ``write_vox_lmdb`` root of PNG frames) and ``VoxLMDirDataset`` (frame
  directories and coefficient pickles, at the frames' size and resized)
  equal JAX's item for item, from the same ``random.Random(seed)``;
* ``VoxLMDirDataset``: the cases of ``tests/test_vox_video_lm.py:173-232``
  (the ``decapirender`` 58-d reorder, the radius-1 x27 tile quirk, the
  exclusion-window draw, ``multiplier``, the frame-directory prefix);
* ``FaceTrainer`` refuses a ``use_spect`` generator with a named error,
  where JAX's trainer fails at its first step with ``InvalidRngError``;
* ``cli.render_train`` on its four data branches (``--synthetic``, clip
  directories, the LMDB root, ``--feat-root``), resuming from
  ``latest_checkpoint.txt``, ``--debug`` (the ``test_everything`` harness
  with the VGG19 loss), ``--use-spect``; ``cli.render_inference`` reads the
  ``.pt`` it writes. The branches run ``--perceptual l1`` at 64 x 64, the
  port's smallest size (the JAX tests' 32 x 32 reaches a 1 x 1 map, where
  torch's instance norm raises), as the JAX tests run l1.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.render import data as JD
from dyadic_interaction_modeling_tpu_torch.render import data as TD
from dyadic_interaction_modeling_tpu_torch.render.image_io import write_png

RES = 64
L1 = ["--perceptual", "l1", "--resolution", str(RES), "--device", "cpu",
      "--steps-per-epoch", "2", "--snapshot-iter", "2", "--logging-iter", "1",
      "--pretrain-warp-iteration", "1", "--lmdb-multiplier", "1"]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    torch.set_num_threads(n)


def _same_batches(ours, theirs, n=3):
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for k in want:
            assert isinstance(got[k], np.ndarray)
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        n -= 1
    assert n == 0


def _lmdb_clips(n_frames=9, res=RES):
    rng = np.random.default_rng(1)
    clips = {}
    for name in ("personA#clip1", "personA#clip2", "personB#clip1"):
        emoca = rng.normal(0, 0.3, (n_frames, 56)).astype(np.float32)
        clips[name] = {"frames": rng.uniform(-1, 1, (n_frames, res, res, 3)).astype(np.float32),
                       "coeff_3dmm": TD.emoca_to_coeff3dmm(
                           emoca, rng.normal(0, 1, (n_frames, 3)).astype(np.float32))}
    return clips


def make_lm_tree(root, n_frames=8, res=24, clips=("clipA", "clipB"), coeff_dim=56,
                 prefix=""):
    """The VoxDataset_LM layout (tests/test_vox_video_lm.py:148): PNG frame
    directories and {frame: row} coefficient pickles."""
    rng = np.random.default_rng(3)
    vids, feats = os.path.join(root, "vids"), os.path.join(root, "feats")
    os.makedirs(feats, exist_ok=True)
    raw = {}
    for clip in clips:
        fdir = os.path.join(vids, prefix + clip)
        os.makedirs(fdir)
        for i in range(n_frames):
            write_png(os.path.join(fdir, f"{i:05d}.png"),
                      rng.integers(0, 255, (res, res, 3), dtype=np.uint8))
        rows = rng.normal(0, 0.3, (n_frames, coeff_dim)).astype(np.float32)
        with open(os.path.join(feats, f"{clip}.pkl"), "wb") as f:
            pickle.dump({f"{i:05d}.png": rows[i] for i in range(n_frames)}, f)
        raw[clip] = rows
    return vids, feats, raw


def test_frame_pair_batches_equal_jax():
    ours = TD.synthetic_render_dataset(resolution=16, coeff_dim=58, semantic_radius=3)
    theirs = JD.synthetic_render_dataset(resolution=16, coeff_dim=58, semantic_radius=3)
    _same_batches(ours.batches(2, 3), theirs.batches(2, 3))


def test_lmdb_batches_equal_jax(tmp_path):
    root = str(tmp_path / "vox")
    TD.write_vox_lmdb(root, _lmdb_clips(res=32), resolution=32, img_format="png")
    ours = TD.VoxLmdbDataset(root, resolution=32, multiplier=2, seed=4)
    theirs = JD.VoxLmdbDataset(root, resolution=32, multiplier=2, seed=4)
    _same_batches(ours.batches(2, 3), theirs.batches(2, 3))


@pytest.mark.parametrize("resolution", [24, 32])
def test_lm_dir_batches_equal_jax(tmp_path, resolution):
    """At the frames' size (the port's PNG codec) and resized 24 -> 32
    (Pillow's bilinear in both)."""
    vids, feats, _ = make_lm_tree(str(tmp_path))
    kw = dict(resolution=resolution, semantic_radius=1, minimal_sample_distance=2,
              multiplier=3, seed=5)
    _same_batches(TD.VoxLMDirDataset(vids, feats, **kw).batches(2, 3),
                  JD.VoxLMDirDataset(vids, feats, **kw).batches(2, 3))


def test_lm_dir_layout_and_reorder(tmp_path):
    vids, feats, raw = make_lm_tree(str(tmp_path))
    ds = TD.VoxLMDirDataset(vids, feats, resolution=24, semantic_radius=13, multiplier=2)
    assert len(ds) == 4
    item = ds[0]
    assert item["source_image"].shape == (24, 24, 3)
    # decapirender (face.yaml): [exp(50), zeros(2), pose(6)] = 58
    assert item["source_semantics"].shape == (58, 27)
    np.testing.assert_array_equal(item["source_semantics"][50:52], 0.0)
    col = TD.VoxLMDirDataset(vids, feats, resolution=24, semantic_radius=13, multiplier=1,
                             seed=1)[0]["target_semantics"][:, 13]
    reordered = [np.concatenate([r[:, 6:], np.zeros((len(r), 2)), r[:, :6]], axis=1)
                 for r in raw.values()]
    assert any(np.isclose(r, col).all(axis=1).any() for r in reordered)
    ds56 = TD.VoxLMDirDataset(vids, feats, resolution=24, semantic_radius=13,
                              decapirender=False, multiplier=1)
    assert ds56[0]["source_semantics"].shape == (56, 27)


def test_lm_dir_radius1_tile_quirk_and_exclusion_window(tmp_path):
    vids, feats, _ = make_lm_tree(str(tmp_path / "a"), n_frames=10)
    w = TD.VoxLMDirDataset(vids, feats, resolution=24, semantic_radius=1,
                           multiplier=1)[0]["source_semantics"]
    assert w.shape == (58, 81)
    for k in range(1, 27):
        np.testing.assert_array_equal(w[:, 3 * k: 3 * k + 3], w[:, :3])
    ds = TD.VoxLMDirDataset(vids, feats, resolution=24, semantic_radius=1,
                            minimal_sample_distance=3, multiplier=1, seed=2)
    for _ in range(30):
        i, j = ds._select_frames(10)
        assert not (i - 3 <= j <= i + 3)
    with pytest.raises(ValueError, match="no valid second frame"):
        ds._select_frames(3)
    vids2, feats2, _ = make_lm_tree(str(tmp_path / "p"), prefix="vid_vico_videos_")
    ds2 = TD.VoxLMDirDataset(vids2, feats2, resolution=24, semantic_radius=1, multiplier=1,
                             frame_dir_prefix="vid_vico_videos_")
    assert ds2[0]["source_image"].shape == (24, 24, 3)
    with pytest.raises(ValueError, match="no .pkl"):
        TD.VoxLMDirDataset(vids, str(tmp_path))


def test_use_spect_is_refused_where_jax_cannot_train(tmp_path):
    from flax.errors import InvalidRngError

    from dyadic_interaction_modeling_tpu.render.generator import FaceGenerator as JGen
    from dyadic_interaction_modeling_tpu.render.trainer import FaceTrainer as JTrainer
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.trainer import FaceTrainer

    small = dict(flame_coeff_nc=56, coeff_nc=73, descriptor_nc=32, mapping_layers=2)
    batch = {"source_image": np.zeros((1, RES, RES, 3), np.float32),
             "target_image": np.zeros((1, RES, RES, 3), np.float32),
             "source_semantics": np.zeros((1, 56, 27), np.float32),
             "target_semantics": np.zeros((1, 56, 27), np.float32)}
    jm = JGen(**small, use_spect=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["source_image"],
                            batch["source_semantics"])
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    jt = JTrainer(jm, params, perceptual_network="l1", save_dir=str(tmp_path / "jax"))
    with pytest.raises(InvalidRngError, match="SpectralNorm"):
        jt.optimize_parameters({k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="use_spect.*render/trainer.py:66.*InvalidRngError"):
        FaceTrainer(FaceGenerator(**small, use_spect=True), perceptual_network="l1",
                    save_dir=str(tmp_path / "port"))


def _train(argv):
    from dyadic_interaction_modeling_tpu_torch.cli import render_train

    return render_train.main(argv)


def _scalars(save):
    return [json.loads(line) for line in open(os.path.join(save, "logs", "scalars.jsonl"))]


def test_render_train_synthetic_resumes_and_render_inference_reads_it(tmp_path):
    from dyadic_interaction_modeling_tpu_torch.cli import render_inference

    save = str(tmp_path / "runs")
    trainer = _train(["--synthetic", "--coeff-nc", "56", "--save-path", save] + L1)
    assert trainer.iteration == 2 and trainer.training_stage() == "gen"
    with open(os.path.join(save, "latest_checkpoint.txt")) as f:
        assert f.read().strip() == "step_2.pt"
    ck = torch.load(os.path.join(save, "step_2.pt"), weights_only=True)
    assert sorted(ck) == ["meta", "net_G", "net_G_ema"] and ck["meta"]["iteration"] == 2
    tags = {r["tag"] for r in _scalars(save)}
    assert {"total_loss", "perceptual_warp", "perceptual_final"} <= tags
    assert os.path.exists(os.path.join(save, "logs", "images", "visualization_000000002.png"))
    # resume from the pointer's checkpoint: its epoch (0) runs again, two steps
    again = _train(["--synthetic", "--coeff-nc", "56", "--save-path", save] + L1)
    assert again.iteration == 4 and again.epoch == 0
    now = again.net.state_dict()
    assert any(not torch.equal(v, now[k]) for k, v in ck["net_G"].items())
    out = str(tmp_path / "render")
    got = render_inference.main(["--synthetic", "--checkpoint", os.path.join(save, "step_4.pt"),
                                 "--out", out, "--resolution", str(RES), "--device", "cpu"])
    assert got["fake_image"].shape == (6, RES, RES, 3)
    assert len(os.listdir(os.path.join(out, "fake"))) == 6


def test_render_train_clip_dirs_branch(tmp_path):
    root = tmp_path / "clips"
    rng = np.random.default_rng(6)
    for clip in ("c0", "c1"):
        for i in range(4):
            os.makedirs(root / clip / "frames", exist_ok=True)
            write_png(str(root / clip / "frames" / f"{i:05d}.png"),
                      rng.integers(0, 255, (RES, RES, 3), dtype=np.uint8))
            d = root / clip / "coeffs" / f"{i:06d}"
            os.makedirs(d)
            np.save(d / "pose.npy", rng.normal(0, 0.1, 6).astype(np.float32))
            np.save(d / "exp.npy", rng.normal(0, 0.3, 50).astype(np.float32))
    trainer = _train(["--data-root", str(root), "--save-path", str(tmp_path / "runs")] + L1)
    assert trainer.iteration == 2
    assert trainer.net.mapping_net.pre.in_channels == 56  # coeff_nc from the data


def test_render_train_lmdb_branch(tmp_path):
    root = str(tmp_path / "vox")
    TD.write_vox_lmdb(root, _lmdb_clips(), resolution=RES, img_format="png")
    trainer = _train(["--data-root", root, "--save-path", str(tmp_path / "runs")] + L1)
    assert trainer.iteration == 2 and trainer.net.mapping_net.pre.in_channels == 73


def test_render_train_feat_root_branch(tmp_path):
    vids, feats, _ = make_lm_tree(str(tmp_path), res=32)
    trainer = _train(["--data-root", vids, "--feat-root", feats, "--semantic-radius", "1",
                      "--save-path", str(tmp_path / "runs")] + L1)
    assert trainer.iteration == 2 and trainer.net.mapping_net.pre.in_channels == 58


def test_render_train_debug_harness_with_vgg19(tmp_path):
    """``--debug 1``: a step of the VGG19 loss at random init, the grid, a
    checkpoint and the LPIPS-style metric, all finite."""
    save = str(tmp_path / "runs")
    trainer = _train(["--synthetic", "--debug", "1", "--resolution", str(RES), "--device",
                      "cpu", "--pretrain-warp-iteration", "0", "--batch-size", "1",
                      "--save-path", save])
    assert trainer.iteration == 1
    rec = {r["tag"]: r["value"] for r in _scalars(save)}
    assert {"perceptual_warp", "perceptual_final", "metric/perceptual_distance"} <= set(rec)
    assert all(np.isfinite(v) for v in rec.values())
    assert os.path.exists(os.path.join(save, "step_1.pt"))


def test_render_train_use_spect_stops(tmp_path):
    with pytest.raises(ValueError, match="use_spect"):
        _train(["--synthetic", "--use-spect", "--save-path", str(tmp_path / "runs")] + L1)
