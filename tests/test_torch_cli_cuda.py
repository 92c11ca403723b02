"""The CLI twins' ``main()`` on the card at full width, on files in the
reference's layouts: the listener path's four (``train_vq``,
``train_s2s_pretrain`` with the token cache, ``finetune_s2s_pretrain``,
``test_s2s_pretrain``), ``test_biwi`` and ``train_converter``, the seq2seq
pair (``train_s2s`` and its ``--continuous`` branch, ``test_s2s``), the
speech pair (``train_stage2``, ``test_biwi --data-root``), the render twins
(``render_inference`` on coefficients and ``--video``,
``intuitive_control``) and ``train_vq --mesh data=1``. Each twin's kernel
launches are counted and its outputs and run record checked.

Marked ``cuda`` (skipped where no card is present). On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_cuda.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_card import (BIWI_L, BIWI_MOUTH, BIWI_VDIM, L, RENDER_B, RENDER_RADIUS,  # noqa: F401
                        RENDER_RES, SPEECH_SAMPLES, card, counted, launches, plain_attention,
                        render_inputs, render_weights)

pytestmark = pytest.mark.cuda

# the least tags of each training twin's run record (tests/test_postprocess_cli.py
# _assert_observability_artifacts)
RUN_RECORD_TAGS = {
    "train_vq": ["train/rec_loss", "train/quant_loss", "train/perplexity", "val/rec_loss",
                 "val/quant_loss", "val/perplexity"],
    "train_s2s_pretrain": ["val/l_ce_l", "val/loss", "learning_rate"],
    "train_s2s": ["train/loss", "val/loss", "learning_rate"],
    "train_s2s_continuous": ["val/loss", "learning_rate"],
    "finetune_s2s_pretrain": ["val/fid_pose", "val/fid_exp", "learning_rate"],
}


def _assert_run_record(save_dir, twin):
    """``twin`` wrote its run record into ``save_dir``: ``scalars.jsonl``
    with at least its tags, and ``hparams.json``."""
    with open(os.path.join(save_dir, "scalars.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert not set(RUN_RECORD_TAGS[twin]) - tags, sorted(tags)
    assert os.path.isfile(os.path.join(save_dir, "hparams.json"))


def _reference_checkpoint(path, out):
    """The twin's state_dict at ``path`` re-saved as a reference file may
    hold it: ``{'state_dict': ...}``, nn.DataParallel's ``module.`` prefix,
    the VQ-VAEs' LayerNorms spelled gamma/beta and the x-transformers norms
    weight/bias (the spellings ``utils.checkpoint.model_state_dict`` maps)."""
    sd = {}
    for k, v in torch.load(path, map_location="cpu", weights_only=True).items():
        if ".fn.norm." in k:
            k = k.replace(".fn.norm.weight", ".fn.norm.gamma").replace(".fn.norm.bias",
                                                                       ".fn.norm.beta")
        else:
            k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
        sd["module." + k] = v
    torch.save({"state_dict": sd, "epoch": 1}, out)
    return str(out)


def _drive(main, argv):
    """``main(argv)`` with every launch count set to 0 just before and read
    just after: (its return value, what it printed, the launches)."""
    buf = io.StringIO()
    with counted() as got, contextlib.redirect_stdout(buf):
        rc = main(argv)
    print(buf.getvalue())
    return rc, buf.getvalue(), got


def _finite(*xs):
    return all(x == x and abs(x) != float("inf") for x in xs)


RF_TRAIN, RF_TEST, RF_CONVERSATIONS = 16, 25, 20


def test_listener_twins_on_reference_files(card, tmp_path, monkeypatch):
    """On ``../data`` of their working directory (``data.reference_files``):
    ViCo, RF_TEST test clips of L (the generate headline's shape) and
    RF_TRAIN train clips of 300-511 frames (bucket 512, so the listener VQ's
    attention takes K2/K3), with integer ids in ``RLD_data.csv``; CANDOR,
    RF_CONVERSATIONS conversations x 2 utterances of 120-250 frames. In
    order: ``train_vq`` (1 epoch, prefetch 2); ``train_s2s_pretrain`` (bf16
    autocast, both VQs from the first run's checkpoint in the reference
    layout, token cache, prefetch 2, 2 epochs: K4 in epoch 1's steps and
    never in epoch 2's); ``finetune_s2s_pretrain`` (bf16 autocast,
    ``--pretrained`` from the second's, 1 epoch); ``test_s2s_pretrain``
    (``--state-dict`` from the third's, best-of-10 in fp32)."""
    import pickle
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.cli import (
        finetune_s2s_pretrain, test_s2s_pretrain, train_s2s_pretrain, train_vq)
    from dyadic_interaction_modeling_tpu_torch.data.reference_files import (
        write_candor, write_vico)

    root = tmp_path
    train_len = [300 + (37 * i) % 212 for i in range(RF_TRAIN)]
    write_vico(str(root / "data"), [L] * RF_TEST + train_len,
               ["test"] * RF_TEST + ["train"] * RF_TRAIN, seed=31)
    write_candor(str(root / "data"), RF_CONVERSATIONS, 2, 120, 250, seed=32)
    (root / "work").mkdir()
    monkeypatch.chdir(root / "work")
    rc, _, got = _drive(train_vq.main, ["--save-path", str(root / "vq"), "--prefetch", "2",
                                        "epochs", "1"])
    # 12 K2, 12 K3 and 1 K4 a training step at L = 512, 1 K4 a validation clip at L = 256
    assert rc == 0 and got == launches(
        flash_attention_fwd=12 * RF_TRAIN, flash_attention_bwd=12 * RF_TRAIN,
        nearest_code=RF_TRAIN + RF_TEST)
    _assert_run_record(root / "vq", "train_vq")
    vq = _reference_checkpoint(root / "vq" / "best_model.pt", root / "vq.pth.tar")

    per_epoch, real_epoch = [], train_s2s_pretrain.train_epoch

    def counted_epoch(*args, **kwargs):
        before = dict(kernels.LAUNCHES)
        out = real_epoch(*args, **kwargs)
        per_epoch.append({k: kernels.LAUNCHES[k] - before[k] for k in before})
        return out

    with mock.patch.object(train_s2s_pretrain, "train_epoch", counted_epoch):
        rc, _, _ = _drive(train_s2s_pretrain.main, [
            "--dtype", "bfloat16", "--vq-token-cache", "--prefetch", "2",
            "--speaker-vq", vq, "--listener-vq", vq,
            "--save-path", str(root / "pretrain"), "epochs", "2"])
    steps = -(-(2 * RF_CONVERSATIONS - 2) // 32)  # 19 conversations train
    assert rc == 0 and per_epoch == [
        launches(flash_attention_fwd=20 * steps, flash_attention_bwd=20 * steps,
                 nearest_code=k4) for k4 in (2 * steps, 0)]
    _assert_run_record(root / "pretrain", "train_s2s_pretrain")
    pre = _reference_checkpoint(root / "pretrain" / "best_model.pt", root / "pretrain.pth.tar")

    rc, _, got = _drive(finetune_s2s_pretrain.main, [
        "--dtype", "bfloat16", "--pretrained", pre, "--prefetch", "2",
        "--save-path", str(root / "finetune"), "epochs", "1"])
    assert rc == 0 and got["decode_attention"] == 0 and min(
        got[k] for k in ("flash_attention_fwd", "flash_attention_bwd", "nearest_code")) > 0
    _assert_run_record(root / "finetune", "finetune_s2s_pretrain")
    ft = _reference_checkpoint(root / "finetune" / "best_model.pt", root / "finetune.pth.tar")

    pred = str(root / "pred.pkl")
    rc, _, got = _drive(test_s2s_pretrain.main, ["--state-dict", ft, "--out", pred])
    batches = -(-RF_TEST // 4)
    # per batch of 4 clips: K1 for 255 tokens x 4 layers x (self, cross), K4 twice
    assert rc == 0 and got == launches(decode_attention=batches * 2 * 4 * (L - 1),
                                       nearest_code=2 * batches)
    with open(pred, "rb") as f:
        out = pickle.load(f)
    assert len(out["y_pred"]) == RF_TEST and all(
        p.shape == (L - 1, 56) and bool(torch.isfinite(torch.as_tensor(p)).all())
        for p in out["y_pred"])


def test_test_biwi_twin(card, tmp_path):
    """``cli/test_biwi.main --synthetic`` at full width (4 clips of 16 frames,
    70110-d meshes, fp32): a clip K2 4 (the decoder's causal
    self-attention) and K4 2; its gt/pred ``.npy`` files and finite LVE /
    FDD; then the same run under ``plain_attention()``: every
    teacher-forced prediction within 1e-4 of the kernels' relative to its
    largest magnitude."""
    from dyadic_interaction_modeling_tpu_torch.cli import test_biwi

    rc, out, got = _drive(test_biwi.main, ["--synthetic", "--out-dir",
                                           str(tmp_path / "kernels")])
    n = test_biwi.SYNTHETIC_CLIPS
    assert rc == 0 and got == launches(flash_attention_fwd=4 * n, nearest_code=2 * n)
    lve, fdd = (float(x) for x in out.split("LVE ")[1].split()[::2][:2])
    assert _finite(lve, fdd)
    with plain_attention():
        _drive(test_biwi.main, ["--synthetic", "--out-dir", str(tmp_path / "plain")])
    files = sorted(os.listdir(tmp_path / "kernels" / "pred"))
    worst = 0.0
    for f in files:
        a, b = (np.load(tmp_path / d / "pred" / f) for d in ("kernels", "plain"))
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    gts = [np.load(tmp_path / "kernels" / "gt" / f) for f in files]
    assert len(files) == n and all(g.shape == (test_biwi.SYNTHETIC_LEN - 1, 56) for g in gts)
    assert worst <= 1e-4, worst


def test_train_converter_twin(card, tmp_path):
    """``cli/train_converter.main`` at full width: 70110-d meshes, 8 synthetic
    clips of BIWI_L frames, a mouth map, 2 epochs, K4 once a step (the frozen
    speaker VQ's encode); finite epoch losses that fall, the speaker VQ
    bitwise unchanged in the best state_dict."""
    from dyadic_interaction_modeling_tpu_torch.cli import train_converter as tc
    from dyadic_interaction_modeling_tpu_torch.config import vq_listener_defaults
    from dyadic_interaction_modeling_tpu_torch.models.slm import CONVERTER_FROZEN, EmocaConverter

    mouth = tmp_path / "lve.txt"
    mouth.write_text(", ".join(str(i) for i in BIWI_MOUTH))
    rc, out, got = _drive(tc.main, ["--synthetic", "--clip-len", str(BIWI_L),
                                    "--mouth-map", str(mouth), "--epochs", "2",
                                    "--save-path", str(tmp_path / "run")])
    assert rc == 0 and got == launches(nearest_code=16)  # 8 clips x 2 epochs
    losses = [float(line.split("loss ")[1]) for line in out.splitlines() if "loss " in line]
    assert len(losses) == 2 and _finite(*losses) and losses[1] < losses[0], losses
    torch.manual_seed(0)
    init = EmocaConverter(vq_listener_defaults(), BIWI_VDIM).state_dict()
    best = torch.load(tmp_path / "run" / "best_model.pt", map_location="cpu",
                      weights_only=True)
    vq = [k for k in best if k.startswith(CONVERTER_FROZEN)]
    assert vq and all(torch.equal(best[k], init[k]) for k in vq)


S2S_RF_TRAIN, S2S_RF_TEST = 8, 4


def test_s2s_twins_on_vico_files(card, tmp_path, monkeypatch):
    """On ViCo files that ``write_vico`` writes (S2S_RF_TRAIN train and
    S2S_RF_TEST test clips of L): ``cli.train_s2s.main`` (1 epoch), its
    ``--continuous`` branch (1 epoch), and ``cli.test_s2s.main`` from the
    first's checkpoint re-saved in the reference layout, with their run
    records and launches."""
    from dyadic_interaction_modeling_tpu_torch.cli import test_s2s, train_s2s
    from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_vico

    write_vico(str(tmp_path / "data"), [L] * (S2S_RF_TEST + S2S_RF_TRAIN),
               ["test"] * S2S_RF_TEST + ["train"] * S2S_RF_TRAIN, seed=44)
    (tmp_path / "work").mkdir()
    monkeypatch.chdir(tmp_path / "work")
    rc, out, got = _drive(train_s2s.main, ["--save-path", str(tmp_path / "lg"), "epochs", "1"])
    assert rc == 0 and "perplexity" in out
    _assert_run_record(tmp_path / "lg", "train_s2s")
    steps = S2S_RF_TRAIN // 4
    # steps of 12 K2, 12 K3 and 2 K4, then one validation batch through the
    # model and the generator again (12 K2 and 2 K4 each)
    assert got == launches(flash_attention_fwd=12 * (steps + 2), flash_attention_bwd=12 * steps,
                           nearest_code=2 * steps + 2 * 2)
    rc, _, got = _drive(train_s2s.main, ["--continuous", "--save-path", str(tmp_path / "cont"),
                                         "epochs", "1"])
    assert rc == 0 and got["flash_attention_fwd"] > 0 and got["flash_attention_bwd"] > 0
    assert got["decode_attention"] == got["nearest_code"] == 0
    _assert_run_record(tmp_path / "cont", "train_s2s_continuous")
    ckpt = _reference_checkpoint(tmp_path / "lg" / "best_model.pt", tmp_path / "lg.pth.tar")
    rc, out, got = _drive(test_s2s.main, ["--checkpoint", ckpt])
    # one batch of S2S_RF_TEST clips: K1 self and cross in 6 decoder layers x 255
    # codes, K2 in the 6 encoder layers, K4 twice; the battery printed
    assert rc == 0 and "fid_pose" in out
    assert got == launches(decode_attention=(L - 1) * 6 * 2, flash_attention_fwd=6,
                           nearest_code=2)


SPEECH_TRAIN_CLIPS = [("F2", 1), ("M3", 2)]
SPEECH_TEST_CLIPS = [("F1", 37), ("M1", 38)]


def test_speech_twins_on_biwi_files(card, tmp_path):
    """On a ``write_biwi`` tree (23,370 vertices, BIWI_L frames and
    SPEECH_SAMPLES samples a clip): ``train_stage2`` for 2 epochs on the
    training split's 2 clips (K4 2 a step), then ``test_biwi --data-root``
    on the test split's 2 clips with the port's HuBERT extractor on the card
    (K2 4 and K4 2 a clip) and the mouth and upper-face maps, twice:
    bitwise-equal predictions. The extractor on the card against the CPU's
    on the same weights: within 1e-4 of the largest magnitude."""
    from dyadic_interaction_modeling_tpu_torch.cli import test_biwi, train_stage2
    from dyadic_interaction_modeling_tpu_torch.data.datasets import load_wav_16k
    from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_biwi
    from dyadic_interaction_modeling_tpu_torch.models.hubert import make_hubert_extractor

    data = str(tmp_path / "BIWI")
    write_biwi(data, SPEECH_TRAIN_CLIPS + SPEECH_TEST_CLIPS, n_frames=BIWI_L,
               n_vertices=BIWI_VDIM // 3, wav_samples=SPEECH_SAMPLES)
    rc, out, got = _drive(train_stage2.main, ["--data-root", data, "--epochs", "2",
                                              "--save-path", str(tmp_path / "stage2")])
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines()
              if "(motion" in line]
    assert rc == 0 and got == launches(nearest_code=2 * 2 * len(SPEECH_TRAIN_CLIPS))
    assert len(losses) == 2 and _finite(*losses), losses
    regions = []
    for name, idx in (("lve.txt", BIWI_MOUTH), ("fdd.txt", range(BIWI_VDIM // 6,
                                                                 BIWI_VDIM // 3))):
        regions.append(tmp_path / name)
        regions[-1].write_text(", ".join(str(i) for i in idx))
    argv = ["--data-root", data, "--vertice-dim", str(BIWI_VDIM), "--mouth-map",
            str(regions[0]), "--upper-map", str(regions[1])]
    n = len(SPEECH_TEST_CLIPS)
    preds = []
    for run in ("a", "b"):
        rc, out, got = _drive(test_biwi.main, argv + ["--out-dir", str(tmp_path / run)])
        assert rc == 0 and got == launches(flash_attention_fwd=4 * n, nearest_code=2 * n)
        lve, fdd = (float(x) for x in out.split("LVE ")[1].split()[::2][:2])
        assert _finite(lve, fdd)
        files = sorted(os.listdir(tmp_path / run / "pred"))
        preds.append({f: np.load(tmp_path / run / "pred" / f) for f in files})
    assert len(preds[0]) == n and all(p.shape == (BIWI_L - 1, 56) for p in preds[0].values())
    assert preds[0].keys() == preds[1].keys()
    assert all(np.array_equal(preds[0][f], preds[1][f]) for f in preds[0])
    wav = load_wav_16k(os.path.join(data, "wav", "F1_37.wav"))
    on_card = make_hubert_extractor(device="cuda")[0](wav)
    on_cpu = make_hubert_extractor(device="cpu")[0](wav)
    err = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
    assert on_card.shape == (2 * BIWI_L + 1, 768) and err <= 1e-4, err


def _png_off(path, want_uint8):
    """Largest uint8 difference between the PNG at ``path`` and ``want``."""
    from dyadic_interaction_modeling_tpu_torch.render.image_io import read_png

    return int(np.abs(read_png(str(path)).astype(int) - want_uint8.astype(int)).max())


def test_render_twins(card, tmp_path):
    """The render twins at ``--resolution 256`` through ``--checkpoint``,
    each launching no K1-K4: ``render_inference`` on a coefficient directory
    of 16 frames from a source written as a PNG, with seeded weights as a
    reference-layout ``.pt`` (``{"net_G_ema": sd}``); ``render_inference
    --video`` on a ``write_vox_lmdb(..., img_format="png")`` root of two
    persons' clips of 16 frames, with a generator for the LMDB's 73-d
    windows (cv2 hidden, so it writes gt | warp | fake PNG frames, not an
    mp4); and ``intuitive_control --synthetic`` (120 frames of batch 1).
    Frame counts, and frames against the same weights rendered in memory
    (one uint8 level)."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.cli import intuitive_control, render_inference
    from dyadic_interaction_modeling_tpu_torch.render.data import (
        VoxVideoDataset, emoca_to_coeff3dmm, write_vox_lmdb)
    from dyadic_interaction_modeling_tpu_torch.render.generator import (
        FaceGenerator, face_generator_from_state_dict)
    from dyadic_interaction_modeling_tpu_torch.render.image_io import write_png
    from dyadic_interaction_modeling_tpu_torch.render.inference import (
        render_clip, render_windows, to_uint8_frame, to_uint8_video)

    n, sd = 16, render_weights()
    src8, coeffs = render_inputs()
    ckpt = str(tmp_path / "pirender.pt")
    torch.save({"net_G_ema": sd, "current_iteration": 0}, ckpt)
    src_png = str(tmp_path / "source.png")
    write_png(src_png, src8)
    clip_dir = tmp_path / "clip"
    for i, row in enumerate(coeffs[:n]):
        (clip_dir / f"{i:06d}").mkdir(parents=True)
        np.save(clip_dir / f"{i:06d}" / "pose.npy", row[:6])
        np.save(clip_dir / f"{i:06d}" / "exp.npy", row[6:])
    out_dir = tmp_path / "out"
    rendered, _, got = _drive(render_inference.main, [
        "--checkpoint", ckpt, "--source-image", src_png, "--coeff-dir", str(clip_dir),
        "--out", str(out_dir), "--resolution", str(RENDER_RES), "--device", "cuda"])
    assert got == launches()
    counts = [len(os.listdir(out_dir / k)) for k in ("fake", "warp")]
    model = face_generator_from_state_dict(sd).to("cuda").eval()
    src = src8.astype(np.float32) / 127.5 - 1.0
    want = render_clip(model, src, coeffs[:n], RENDER_RADIUS, RENDER_B)
    off = _png_off(out_dir / "fake" / "00005.png", to_uint8_frame(want["fake_image"][5]))
    assert counts == [n, n] and off <= 1 and rendered["fake_image"].shape[0] == n, (counts, off)

    torch.manual_seed(64)
    sd73 = FaceGenerator(flame_coeff_nc=73, coeff_nc=73).state_dict()
    ckpt73 = str(tmp_path / "pirender73.pt")
    torch.save({"net_G_ema": sd73}, ckpt73)
    rng = np.random.default_rng(65)
    clips = {}
    for person in ("id10001", "id10002"):
        drift = rng.normal(0, 0.05, (n, 1, 1, 3))
        frames = np.clip(src[None] + drift, -1, 1)
        emoca = np.concatenate([rng.normal(0, 0.1, (n, 6)), rng.normal(0, 0.3, (n, 50))], 1)
        clips[f"{person}#vid#00001"] = {"frames": frames, "coeff_3dmm": emoca_to_coeff3dmm(
            emoca, rng.normal(1.0, 0.1, (n, 3)))}
    vox = str(tmp_path / "vox")
    write_vox_lmdb(vox, clips, resolution=RENDER_RES, test_names=list(clips), img_format="png")
    with mock.patch.dict(sys.modules, {"cv2": None}):  # the PNG frames, to compare
        written, _, got = _drive(render_inference.main, [
            "--video", "--vox-root", vox, "--checkpoint", ckpt73, "--out",
            str(tmp_path / "video"), "--resolution", str(RENDER_RES), "--device", "cuda"])
    assert got == launches()
    data = VoxVideoDataset(vox, resolution=RENDER_RES).load_next_video()
    model73 = face_generator_from_state_dict(sd73).to("cuda").eval()
    want = render_windows(model73, data["source_image"], data["target_semantics"], RENDER_B)
    off = _png_off(os.path.join(written[0], "00007.png"), np.concatenate(
        [to_uint8_video(data[k][7:8])[0] if k == "target_images"
         else to_uint8_video(want[k][7:8])[0]
         for k in ("target_images", "warp_image", "fake_image")], axis=1))
    assert len(written) == 2 and len(os.listdir(written[0])) == n and off <= 1, off

    ctrl = tmp_path / "control"
    frames, _, got = _drive(intuitive_control.main, [
        "--synthetic", "--checkpoint", ckpt, "--resolution", str(RENDER_RES),
        "--device", "cuda", "--out", str(ctrl)])
    assert got == launches()
    pngs = [f for f in os.listdir(ctrl) if not f.startswith("_")]
    assert frames == 120 and len(pngs) == 120  # 10 steps x 12 presets


def test_train_vq_mesh_of_one_card(card, tmp_path):
    """``cli.train_vq --synthetic --mesh data=1`` on the card (NCCL, a group
    of one) against the same run without ``--mesh``: the best validation
    rec_loss within 1e-5 relative, the same K1-K4 launch counts; the
    device-count error of ``data=2`` on one card."""
    from dyadic_interaction_modeling_tpu_torch.cli import train_vq
    from dyadic_interaction_modeling_tpu_torch.parallel import MeshPlan

    runs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "data=1"])):
        save = tmp_path / name
        _, _, got = _drive(train_vq.main, ["--synthetic", "--device", "cuda", "--save-path",
                                           str(save)] + extra + ["epochs", "2"])
        with open(save / "scalars.jsonl") as f:
            vals = [r["value"] for r in map(json.loads, f) if r["tag"] == "val/rec_loss"]
        runs[name] = (min(vals), got)
    (a, la), (b, lb) = runs["single"], runs["mesh"]
    assert abs(a - b) / abs(a) <= 1e-5, (a, b)
    assert la == lb
    with pytest.raises(ValueError, match="needs 2 devices"):
        MeshPlan.parse("data=2", "cuda")
