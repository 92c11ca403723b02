"""The torch port's speech front-ends against the JAX package on the CPU:
``StreamingAudioFrontend`` (the four cases of
``tests/test_serving_audio.py``, and its emissions against JAX's on the
same tiny trunk), the BIWI reader with the port's HuBERT extractor against
the JAX reader with its own, ``test_biwi --data-root`` end to end on a
``write_biwi`` tree, and the sentiment probe (``threshold_classifier``,
the weighted cross entropy, ``train_probe`` in lockstep, ``classify_clips``).

Features within 1e-4 of their largest magnitude; streaming emissions
bitwise equal however ``push`` slices the stream."""

import os

import jax
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.cli import test_biwi as j_cli_biwi
from dyadic_interaction_modeling_tpu.data import datasets as JD
from dyadic_interaction_modeling_tpu.metrics import sentiment as JS
from dyadic_interaction_modeling_tpu.models import wav2vec2 as JW
from dyadic_interaction_modeling_tpu.serving.audio import StreamingAudioFrontend as JFrontend
from dyadic_interaction_modeling_tpu_torch.cli import test_biwi as cli_biwi
from dyadic_interaction_modeling_tpu_torch.data import datasets as TD
from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_biwi
from dyadic_interaction_modeling_tpu_torch.metrics import sentiment as TS
from dyadic_interaction_modeling_tpu_torch.models import hubert as TH
from dyadic_interaction_modeling_tpu_torch.models import wav2vec2 as TW
from dyadic_interaction_modeling_tpu_torch.serving import StreamingAudioFrontend
from dyadic_interaction_modeling_tpu_torch.utils import weights as W


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref, tol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _trunk_cfg(mod, hidden=24):
    return mod.W2VConfig(conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                         hidden_size=hidden, num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=32, num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4)


@pytest.fixture(scope="module")
def trunk():
    """A seeded tiny port trunk and the JAX package's on the same weights."""
    torch.manual_seed(0)
    tm = TW.Wav2Vec2Model(_trunk_cfg(TW)).eval()
    params = jax.tree_util.tree_map(np.asarray, JW.hf_wav2vec2_to_flax(
        {k: v.numpy() for k, v in tm.state_dict().items()}, _trunk_cfg(JW)))
    return tm, JW.Wav2Vec2Model(_trunk_cfg(JW)), params


def _run(fe, wave, pieces):
    outs, at = [], 0
    for n in pieces:
        got = fe.push(wave[:, at: at + n])
        if got is not None:
            outs.append(np.asarray(got))
        at += n
    assert at == wave.shape[1]
    return np.concatenate(outs, axis=1), fe.frames_emitted


def test_push_granularity_invariance_and_jax(trunk):
    """Emissions bitwise equal for a whole push and for irregular pieces, and
    within 1e-4 of the JAX front-end's on the same weights."""
    tm, jm, params = trunk
    wave = (np.random.RandomState(0).randn(2, 16000) * 0.1).astype(np.float32)
    kw = dict(fps=30, chunk=4, window_frames=8, lookahead=1, batch=2)
    whole, n1 = _run(StreamingAudioFrontend(tm, **kw), wave, [16000])
    pieces, n2 = _run(StreamingAudioFrontend(tm, **kw), wave, [7, 533, 1001, 2459, 4000, 8000])
    assert n1 == n2 > 0
    np.testing.assert_array_equal(whole, pieces)
    ref, n3 = _run(JFrontend(jm, params, **kw), wave, [16000])
    assert n3 == n1
    _close(whole, ref)


def test_covering_window_equals_offline_prefix(trunk):
    """With the window spanning the whole stream, the last chunk's features
    equal the offline extraction of the prefix: trunk over every sample,
    align_corners interpolation to the frame count, the chunk's rows."""
    tm, _, _ = trunk
    fps, chunk, frames = 30, 4, 12
    wave = (np.random.RandomState(1).randn(1, int(round(frames * 16000 / fps))) * 0.1
            ).astype(np.float32)
    fe = StreamingAudioFrontend(tm, fps=fps, chunk=chunk, window_frames=frames, lookahead=0)
    feats = fe.push(wave)
    assert feats.shape == (1, frames, 24)
    with torch.no_grad():
        offline = TW.linear_interpolation(tm(torch.from_numpy(wave), "none"), 1, 1,
                                          output_len=frames)
    torch.testing.assert_close(feats[:, 8:12], offline[:, 8:12], rtol=1e-5, atol=1e-6)


def test_latency_and_bounded_buffer(trunk):
    tm, _, _ = trunk
    fe = StreamingAudioFrontend(tm, fps=30, chunk=4, window_frames=8, lookahead=2)
    rng = np.random.RandomState(2)
    need = int(round(6 * 16000 / 30))  # (chunk + lookahead) / fps seconds
    assert fe.push(rng.randn(1, need - 10).astype(np.float32)) is None
    assert fe.push(rng.randn(1, 10).astype(np.float32)).shape == (1, 4, 24)
    for _ in range(20):
        fe.push(rng.randn(1, 4000).astype(np.float32))
    # the buffer never grows past one window and one chunk of slack
    assert fe._buf.shape[1] <= fe.window_samples + int(round(fe.chunk * 16000 / 30)) + 2
    with pytest.raises(ValueError):
        StreamingAudioFrontend(tm, chunk=8, window_frames=9, lookahead=2)


def test_batched_streams(trunk):
    tm, _, _ = trunk
    fe = StreamingAudioFrontend(tm, fps=25, chunk=2, window_frames=6, lookahead=1, batch=3)
    out = fe.push(np.random.RandomState(3).randn(3, 16000).astype(np.float32))
    assert out is not None and out.shape[0] == 3 and out.shape[2] == 24
    assert fe.frames_emitted == out.shape[1]
    with pytest.raises(ValueError):
        fe.push(np.zeros((2, 10), np.float32))


CLIPS = [("F2", 1), ("F1", 37), ("M1", 38), ("F5", 39), ("M3", 2)]


def test_biwi_reader_with_hubert_extractors_matches_jax(tmp_path, trunk):
    """``read_biwi_emoca_data`` with the port's extractor (a tiny HuBERT
    checkpoint through ``make_hubert_extractor``) against the JAX reader
    with the JAX trunk on the same weights: splits, names, vertices and
    EMOCA exact, the dataset's interpolated audio features within 1e-4."""
    tm, jm, params = trunk
    write_biwi(str(tmp_path), CLIPS, n_frames=9, n_vertices=10, wav_samples=3000)
    torch.save({"Upstream": {f"upstream.model.{k}": v for k, v in tm.state_dict().items()}},
               tmp_path / "hubert.pt")
    extract, _ = TH.make_hubert_extractor(str(tmp_path / "hubert.pt"), _trunk_cfg(TW),
                                          device="cpu")
    fwd = jax.jit(lambda w: jm.apply(params, w, "none"))
    ours = TD.read_biwi_emoca_data(str(tmp_path), extract)
    ref = JD.read_biwi_emoca_data(str(tmp_path), lambda w: np.asarray(fwd(w[None])[0]))
    assert ours[3] == ref[3]
    for part_t, part_j, split in zip(ours[:3], ref[:3], ("train", "val", "test")):
        assert [d["name"] for d in part_t] == [d["name"] for d in part_j]
        ds_t = TD.BiwiEmocaDataset(part_t, split)
        ds_j = JD.BiwiEmocaDataset(part_j, split)
        for i in range(len(ds_t)):
            (a_t, *rest_t), (a_j, *rest_j) = ds_t[i], ds_j[i]
            assert a_t.shape == (9, 24)
            _close(a_t, a_j)
            for x, y in zip(rest_t, rest_j):
                assert x == y if isinstance(x, str) else np.array_equal(x, y)
    assert [len(p) for p in ours[:3]] == [2, 0, 3]


TINY_SLM = ["dim", "32", "enc_depth", "1", "dec_depth", "1", "enc_heads", "2",
            "dec_heads", "2"]


def test_test_biwi_data_root_end_to_end(tmp_path, capsys):
    """``test_biwi --data-root`` on a ``write_biwi`` tree with the port's
    base-width HuBERT (random init): the test split's three clips, gt/pred
    ``.npy`` files, LVE and FDD from comma-separated region files, and the
    same predictions from a second run; an empty split stops; a missing tree
    raises ``FileNotFoundError`` as the JAX CLI does."""
    root = tmp_path / "BIWI"
    write_biwi(str(root), CLIPS, n_frames=8, n_vertices=30, wav_samples=5200)
    (tmp_path / "lve.txt").write_text(", ".join(str(i) for i in range(10)))
    (tmp_path / "fdd.txt").write_text(", ".join(str(i) for i in range(10, 30)))
    argv = ["--data-root", str(root), "--device", "cpu", "--vertice-dim", "90",
            "--mouth-map", str(tmp_path / "lve.txt"), "--upper-map", str(tmp_path / "fdd.txt")]
    assert cli_biwi.main(argv + ["--out-dir", str(tmp_path / "a"), *TINY_SLM]) == 0
    text = capsys.readouterr().out
    assert "random-init HuBERT" in text
    lve, fdd = (float(x) for x in text.split("LVE ")[1].split()[::2][:2])
    assert np.isfinite(lve) and np.isfinite(fdd)
    files = sorted(os.listdir(tmp_path / "a" / "pred"))
    assert files == ["F1_37.npy", "F5_39.npy", "M1_38.npy"]
    assert np.load(tmp_path / "a" / "pred" / files[0]).shape == (7, 56)
    assert cli_biwi.main(argv + ["--out-dir", str(tmp_path / "b"), *TINY_SLM]) == 0
    for f in files:
        np.testing.assert_array_equal(np.load(tmp_path / "b" / "pred" / f),
                                      np.load(tmp_path / "a" / "pred" / f))
    with pytest.raises(SystemExit, match="no clips in split 'val'"):
        cli_biwi.main(["--data-root", str(root), "--device", "cpu", "--split", "val",
                       *TINY_SLM])
    missing = ["--data-root", str(tmp_path / "missing")]
    with pytest.raises(FileNotFoundError, match="templates.pkl"):
        cli_biwi.main(missing + ["--device", "cpu", *TINY_SLM])
    with pytest.raises(FileNotFoundError, match="templates.pkl"):
        j_cli_biwi.main(missing + TINY_SLM)


def test_sentiment_classifier_and_loss_match_jax():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(3) * 0.5, size=(64,)).astype(np.float32)
    probs[:4] = [[0.5, 0.49, 0.01], [0.3, 0.69, 0.01], [0.2, 0.7, 0.1], [0.42, 0.55, 0.03]]
    np.testing.assert_array_equal(TS.threshold_classifier(probs), JS.threshold_classifier(probs))
    np.testing.assert_array_equal(TS.threshold_classifier(probs[:4]), [0, 1, 2, 0])
    logits = rng.standard_normal((32, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, 32)
    for w in (None, TS.DEFAULT_CLASS_WEIGHTS):
        ours = TS.weighted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), w)
        ref = JS.weighted_ce_loss(logits, labels, None if w is None else np.asarray(w))
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    ce = torch.nn.CrossEntropyLoss(weight=torch.from_numpy(TS.DEFAULT_CLASS_WEIGHTS))
    np.testing.assert_allclose(float(ce(torch.from_numpy(logits), torch.from_numpy(labels))),
                               float(ours), rtol=1e-6)
    np.testing.assert_array_equal(TS.DEFAULT_CLASS_WEIGHTS, JS.DEFAULT_CLASS_WEIGHTS)


def test_train_probe_in_lockstep_with_jax():
    """``train_probe`` from JAX's init (its ``PRNGKey(seed)``), the same
    numpy permutation each epoch, Adam 1e-4: the final loss within 1e-5
    relative and the weights within 1e-5; ``classify_clips`` equal."""
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 3, 200)
    frames = (rng.standard_normal((200, 56)) + labels[:, None] * 0.3).astype(np.float32)
    jmodel, jout = JS.train_probe(frames, labels, epochs=3, batch_size=64, seed=2)
    init = JS.SentimentMLP().init(jax.random.PRNGKey(2), np.zeros((1, 56), np.float32))
    model, out = TS.train_probe(frames, labels, epochs=3, batch_size=64, seed=2,
                                init=W.jax_sentiment_to_state_dict(init), device="cpu")
    np.testing.assert_allclose(out["final_loss"], jout["final_loss"], rtol=1e-5)
    final = W.jax_sentiment_to_state_dict(jax.tree_util.tree_map(np.asarray, jout["params"]))
    for k, v in model.state_dict().items():
        _close(v.numpy(), final[k].numpy(), 1e-5)
    clips = [frames[i: i + 20] for i in range(0, 200, 20)]
    np.testing.assert_array_equal(TS.classify_clips(model, clips),
                                  JS.classify_clips(jmodel, jout["params"], clips))
    with torch.no_grad():
        x = torch.from_numpy(frames[:5])
        ref = jmodel.apply(jout["params"], frames[:5], method=JS.SentimentMLP.extract)
        _close(model.extract(x).numpy(), ref, 1e-5)
