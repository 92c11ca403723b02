"""The port's render data and files against the JAX package on the CPU: the
PNG codec (``render.image_io``) against Pillow both ways, bitwise, Pillow's
adaptively filtered files included; ``utils.lmdb_lite`` (JAX's writer ->
the port's reader, and the port's writer byte for byte JAX's);
``write_vox_lmdb``, ``VoxLmdbDataset`` and ``VoxVideoDataset`` (same id and
cross id) item for item under one seed; ``FramePairDataset``,
``synthetic_render_dataset``, ``emoca_to_coeff3dmm``,
``load_coeff_dir_clip`` and the render config; then the two render CLI
twins against the JAX CLIs: ``render_inference`` at full width (descriptor
256, 3 mapping layers) at 64 x 64 on one reference-layout ``.pt``, frames
within one uint8 level, and ``intuitive_control --synthetic``'s frame
count."""

import os
import struct
import sys
import zlib
from io import BytesIO

import numpy as np
import pytest
import torch
from PIL import Image

from dyadic_interaction_modeling_tpu.render import config as JCfg
from dyadic_interaction_modeling_tpu.render import data as JD
from dyadic_interaction_modeling_tpu.render import generator as JG
from dyadic_interaction_modeling_tpu.render.import_torch import torch_face_generator_to_flax
from dyadic_interaction_modeling_tpu.utils import lmdb_lite as JL
from dyadic_interaction_modeling_tpu_torch.render import config as TCfg
from dyadic_interaction_modeling_tpu_torch.render import data as TD
from dyadic_interaction_modeling_tpu_torch.render import generator as TG
from dyadic_interaction_modeling_tpu_torch.render import image_io
from dyadic_interaction_modeling_tpu_torch.render.image_io import read_png
from dyadic_interaction_modeling_tpu_torch.utils import lmdb_lite as TL

RES = 64


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(rng):
    """Noise, and smooth ramps that make Pillow's adaptive filter choose Sub,
    Up, Average and Paeth rows, in gray, gray + alpha, RGB and RGBA."""
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([(xx * 5 + yy * 3) % 256, (yy * 7) % 256, (xx * yy) % 256,
                       (200 + xx - yy) % 256], -1).astype(np.uint8)
    noise = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    out = []
    for img in (smooth, noise, (smooth // 2 + noise // 2)):
        out += [img[..., 0], img[..., :2], img[..., :3], img]
    return out


def _filters(png: bytes):
    """The filter type of each row of a PNG's image data."""
    pos, idat, ihdr = 8, [], None
    while pos < len(png):
        (n,) = struct.unpack_from(">I", png, pos)
        kind = png[pos + 4:pos + 8]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", png[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat.append(png[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, color, *_ = ihdr
    stride = w * {0: 1, 4: 2, 2: 3, 6: 4}[color] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * stride] for y in range(h)}


def test_png_codec_round_trips_against_pillow_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    seen = set()
    for i, img in enumerate(_images(rng)):
        path = str(tmp_path / f"port_{i}.png")
        image_io.write_png(path, img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        for kw in ({}, {"optimize": True}, {"compress_level": 1}):
            buf = BytesIO()
            Image.fromarray(img).save(buf, format="png", **kw)
            seen |= _filters(buf.getvalue())
            got = image_io.decode_png(buf.getvalue())
            np.testing.assert_array_equal(got.reshape(img.shape), img)
            want = np.asarray(Image.open(BytesIO(buf.getvalue())).convert("RGB"))
            np.testing.assert_array_equal(image_io.decode_rgb(buf.getvalue()), want)
    assert seen == {0, 1, 2, 3, 4}, seen  # every row filter, Paeth included
    # a palette PNG is Pillow's: decode_rgb hands it over, and a resize too
    buf = BytesIO()
    Image.fromarray(_images(rng)[2]).convert("P").save(buf, format="png")
    with pytest.raises(image_io.UnsupportedPNG):
        image_io.decode_png(buf.getvalue())
    pal = Image.open(BytesIO(buf.getvalue()))
    np.testing.assert_array_equal(image_io.decode_rgb(buf.getvalue()),
                                  np.asarray(pal.convert("RGB")))
    np.testing.assert_array_equal(image_io.decode_rgb(buf.getvalue(), (20, 30)),
                                  np.asarray(pal.convert("RGB").resize((20, 30))))


def test_png_without_pillow_and_jpeg_asks_for_it(tmp_path, monkeypatch):
    img = np.random.default_rng(1).integers(0, 256, (9, 7, 3), dtype=np.uint8)
    buf = BytesIO()
    Image.fromarray(img).save(buf, format="jpeg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(image_io.read_rgb(path, (7, 9)), img)
    with pytest.raises(ImportError, match="Pillow"):
        image_io.decode_rgb(buf.getvalue())
    with pytest.raises(ImportError, match="Pillow"):
        image_io.read_rgb(path, (14, 18))


def _lmdb_items():
    rng = np.random.default_rng(0)
    items = {JL.format_for_lmdb("vid#a", i): bytes(
        rng.integers(0, 256, int(rng.integers(1, 80)), dtype=np.uint8)) for i in range(3000)}
    for i in range(6):  # values over 1-4 overflow pages
        items[JL.format_for_lmdb(f"big{i}")] = bytes(
            rng.integers(0, 256, 1500 + 4000 * i, dtype=np.uint8))
    items[b""] = b"empty-key value"
    return items


def test_lmdb_lite_reads_jax_files_and_writes_jax_bytes(tmp_path):
    items = _lmdb_items()
    JL.write_lmdb(str(tmp_path / "jax"), items.items())
    with TL.LmdbReader(str(tmp_path / "jax")) as r:
        assert r.entries == len(items)
        assert all(r.get(k) == v for k, v in items.items())
        assert r.get(b"missing") is None
        assert dict(r.items()) == items and [k for k, _ in r.items()] == sorted(items)
    TL.write_lmdb(str(tmp_path / "port"), items.items())
    with open(tmp_path / "jax" / "data.mdb", "rb") as a, \
            open(tmp_path / "port" / "data.mdb", "rb") as b:
        assert a.read() == b.read()
    for args in (("x", 3), ("a#b", "length"), ("length",), ("v", 1234567)):
        assert TL.format_for_lmdb(*args) == JL.format_for_lmdb(*args)


def _vox_clips(persons=("pA", "pB", "pC"), n_frames=5, res=24):
    rng = np.random.default_rng(7)
    clips = {}
    for p in persons:
        frames = rng.uniform(-1, 1, (n_frames, res, res, 3)).astype(np.float32)
        emoca = rng.normal(0, 0.3, (n_frames, 56)).astype(np.float32)
        crop = rng.normal(1.0, 0.2, (n_frames, 3)).astype(np.float32)
        coeff = TD.emoca_to_coeff3dmm(emoca, crop)
        np.testing.assert_array_equal(coeff, JD.emoca_to_coeff3dmm(emoca, crop))
        clips[f"{p}#clip1"] = {"frames": frames, "coeff_3dmm": coeff}
    return clips


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_vox_lmdb_files_and_datasets_match_jax(tmp_path):
    clips = _vox_clips()
    # JPEG through Pillow on both sides: the same bytes
    JD.write_vox_lmdb(str(tmp_path / "jax"), clips, resolution=24, test_names=["pB#clip1"])
    TD.write_vox_lmdb(str(tmp_path / "port"), clips, resolution=24, test_names=["pB#clip1"])
    for f in ("24/data.mdb", "train_list.txt", "test_list.txt"):
        with open(tmp_path / "jax" / f, "rb") as a, open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f
    for infer in (False, True):
        j = JD.VoxLmdbDataset(str(tmp_path / "jax"), 24, is_inference=infer, multiplier=2,
                              seed=3)
        t = TD.VoxLmdbDataset(str(tmp_path / "port"), 24, is_inference=infer, multiplier=2,
                              seed=3)
        assert len(j) == len(t)
        for i in list(range(len(t))) * 2:
            _assert_items_equal(t[i], j[i])
    # PNG: the port's own codec, read by both packages' readers alike
    TD.write_vox_lmdb(str(tmp_path / "png"), clips, resolution=24,
                      test_names=list(clips), img_format="png")
    for cross in (False, True):
        j = JD.VoxVideoDataset(str(tmp_path / "png"), 24, cross_id=cross, seed=5)
        t = TD.VoxVideoDataset(str(tmp_path / "png"), 24, cross_id=cross, seed=5)
        for _ in range(len(t)):
            got, want = t.load_next_video(), j.load_next_video()
            _assert_items_equal(got, want)
            assert got["target_images"].shape == (5, 24, 24, 3)
            assert got["target_semantics"].shape == (5, 73, 27)
            assert ("_to_" in got["video_name"]) == cross
    frame = ((np.clip(clips["pA#clip1"]["frames"][0], -1, 1) + 1) * 127.5).astype(np.uint8)
    np.testing.assert_array_equal(
        TD.VoxVideoDataset(str(tmp_path / "png"), 24).load_next_video()["source_image"],
        frame.astype(np.float32) / 127.5 - 1.0)
    ratio = TD.VoxVideoDataset.find_crop_norm_ratio(clips["pA#clip1"]["coeff_3dmm"][:1],
                                                   clips["pB#clip1"]["coeff_3dmm"])
    np.testing.assert_array_equal(ratio, JD.VoxVideoDataset.find_crop_norm_ratio(
        clips["pA#clip1"]["coeff_3dmm"][:1], clips["pB#clip1"]["coeff_3dmm"]))


def test_frame_pairs_windows_coeff_dirs_and_config_match_jax(tmp_path):
    coeffs = np.random.default_rng(2).normal(size=(9, 58)).astype(np.float32)
    for f in (0, 4, 8):
        np.testing.assert_array_equal(TD.semantic_window(coeffs, f, 13),
                                      JD.semantic_window(coeffs, f, 13))
    t = TD.synthetic_render_dataset(n_clips=3, frames_per_clip=6, resolution=16, seed=4)
    j = JD.synthetic_render_dataset(n_clips=3, frames_per_clip=6, resolution=16, seed=4)
    pairs_t = TD.FramePairDataset(t.clips, minimal_sample_distance=2, seed=1)
    pairs_j = JD.FramePairDataset(j.clips, minimal_sample_distance=2, seed=1)
    for i in [0, 1, 2] * 3:
        _assert_items_equal(pairs_t[i], pairs_j[i])

    rng = np.random.default_rng(3)
    clip2 = tmp_path / "clip"
    for i in range(3):
        d = clip2 / f"{i:06d}"
        d.mkdir(parents=True)
        for name, n in (("pose", 6), ("exp", 50), ("cam", 3)):
            np.save(d / f"{name}.npy", rng.normal(size=n).astype(np.float32))
    (clip2 / "notes.txt").write_text("not a frame")
    for pose_first in (True, False):
        got = TD.load_coeff_dir_clip(str(clip2), pose_first)
        assert got.shape == (3, 59)
        np.testing.assert_array_equal(got, JD.load_coeff_dir_clip(str(clip2), pose_first))

    assert TCfg.RENDER_DEFAULTS == JCfg.RENDER_DEFAULTS
    yaml_file = tmp_path / "face.yaml"
    yaml_file.write_text("data:\n  semantic_radius: 1\ngen_optimizer:\n  lr: 0.0002\n")
    got, want = TCfg.load_render_config(str(yaml_file)), JCfg.load_render_config(str(yaml_file))
    got.pop("logdir"), want.pop("logdir")
    assert got == want and got.data.semantic_radius == 1
    assert got.gen_optimizer.lr_policy.step_size == 300000


@pytest.fixture(scope="module")
def full_checkpoint(tmp_path_factory):
    """A full-width generator (descriptor 256, 3 mapping layers) for
    ``flame_coeff_nc``-wide coefficients as a reference-layout ``.pt``
    ({"net_G_ema": sd})."""
    paths = {}

    def make(flame_coeff_nc):
        if flame_coeff_nc not in paths:
            torch.manual_seed(flame_coeff_nc)
            model = TG.FaceGenerator(flame_coeff_nc=flame_coeff_nc, coeff_nc=73)
            path = str(tmp_path_factory.mktemp("ckpt") / "pirender.pt")
            torch.save({"net_G_ema": model.state_dict(), "current_epoch": 3}, path)
            paths[flame_coeff_nc] = path
        return paths[flame_coeff_nc]

    return make


def _same_frames(dir_a, dir_b, n):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b)) and len(names) == n, (names, n)
    for name in names:
        a, b = read_png(os.path.join(dir_a, name)), read_png(os.path.join(dir_b, name))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name


def test_render_inference_twin_matches_the_jax_cli(full_checkpoint, tmp_path, monkeypatch):
    """Both CLIs on one reference-layout ``.pt`` at full width, 64 x 64:
    the coefficient-directory mode on the synthetic inputs, and ``--video``
    on a PNG VoxCeleb LMDB root (same id); frames within one uint8 level.
    Without ``--device`` the twin goes to the card, so here it raises."""
    from dyadic_interaction_modeling_tpu.cli import render_inference as jax_cli
    from dyadic_interaction_modeling_tpu_torch.cli import render_inference as cli

    common = ["--synthetic", "--resolution", str(RES)]
    ckpt = full_checkpoint(56)  # the EMOCA pose + exp directory
    want = jax_cli.main(["--torch-checkpoint", ckpt, "--out", str(tmp_path / "jax"), *common])
    got = cli.main(["--checkpoint", ckpt, "--device", "cpu", "--out", str(tmp_path / "port"),
                    *common])
    np.testing.assert_allclose(got["fake_image"], want["fake_image"], atol=1e-4)
    for kind in ("fake", "warp"):
        _same_frames(tmp_path / "jax" / kind, tmp_path / "port" / kind, 6)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            cli.main(["--checkpoint", ckpt, "--out", str(tmp_path / "card"), *common])

    rng = np.random.RandomState(12)
    clips = {}
    for name, t in (("id00001#a#00001", 3),):  # one video: JAX compiles a program for each
        base = rng.uniform(-0.8, 0.8, (1, RES, RES, 3))
        clips[name] = {"frames": np.clip(base + rng.normal(0, 0.05, (t, 1, 1, 3)), -1, 1),
                       "coeff_3dmm": rng.randn(t, 260).astype(np.float32) * 0.2}
    root = str(tmp_path / "vox")
    TD.write_vox_lmdb(root, clips, resolution=RES, test_names=list(clips), img_format="png")
    monkeypatch.setitem(sys.modules, "cv2", None)
    video = ["--video", "--vox-root", root, "--resolution", str(RES), "--batch-size", "2"]
    ckpt = full_checkpoint(73)  # the LMDB's 73-d Deep3DFace windows
    jax_cli.main([*video, "--torch-checkpoint", ckpt, "--out", str(tmp_path / "jax_video")])
    written = cli.main([*video, "--checkpoint", ckpt, "--device", "cpu", "--out",
                        str(tmp_path / "port_video")])
    assert [os.path.basename(p) for p in written] == [n.replace("/", "_") for n in clips]
    for name, clip in clips.items():
        _same_frames(tmp_path / "jax_video" / name, tmp_path / "port_video" / name,
                     len(clip["frames"]))


def test_intuitive_control_twin_gives_the_jax_cli_frame_count(tmp_path, monkeypatch):
    from dyadic_interaction_modeling_tpu.cli import intuitive_control as jax_cli
    from dyadic_interaction_modeling_tpu_torch.cli import intuitive_control as cli

    # the JAX CLI inits its random generator op by op (~36 s here); a seeded
    # port model's weights through JAX's importer take none of that (the
    # frames differ from a JAX init's, their count does not)
    torch.manual_seed(0)
    sd = TG.FaceGenerator(flame_coeff_nc=56, coeff_nc=73, descriptor_nc=32,
                          mapping_layers=2).state_dict()
    monkeypatch.setattr(JG.FaceGenerator, "init", lambda self, *a: {
        "params": torch_face_generator_to_flax(sd, mapping_layers=2)})
    args = ["--synthetic", "--num", "2", "--coeff-nc", "56", "--resolution", str(RES)]
    n = jax_cli.main([*args, "--out", str(tmp_path / "jax")])
    assert cli.main([*args, "--device", "cpu", "--out", str(tmp_path / "port")]) == n == 24
    frames = sorted(f for f in os.listdir(tmp_path / "port") if not f.startswith("_"))
    assert frames == [f"{i:05d}.png" for i in range(n)]
    assert read_png(str(tmp_path / "port" / frames[0])).shape == (RES, RES, 3)


def test_intuitive_control_reads_mat_presets_as_jax(tmp_path):
    """``--controls``: the reference's ``expression.mat`` / ``rotation.mat``
    read as the JAX CLI reads them (a preset the files lack is skipped)."""
    from scipy.io import savemat

    from dyadic_interaction_modeling_tpu.cli import intuitive_control as jax_cli
    from dyadic_interaction_modeling_tpu_torch.cli import intuitive_control as cli

    rng = np.random.default_rng(8)
    savemat(tmp_path / "expression.mat", {k: rng.normal(0, 0.5, (1, 50)) for k in (
        "expression_center", "expression_mouth", "expression_eyes")})
    savemat(tmp_path / "rotation.mat", {k: rng.normal(0, 0.3, (1, 6)) for k in (
        "rotation_center", "rotation_left", "rotation_right")})
    got, want = cli.load_mat_controls(str(tmp_path)), jax_cli._load_mat_controls(str(tmp_path))
    assert sorted(got) == sorted(want) and "expression_eyebrow" not in got
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    n = cli.main(["--synthetic", "--controls", str(tmp_path), "--num", "2", "--coeff-nc", "56",
                  "--resolution", str(RES), "--device", "cpu", "--out", str(tmp_path / "out")])
    assert n == 2 * (len(cli.ROT_ORDER) + len(cli.EXP_ORDER) - 1)  # the eyebrow preset lacks
