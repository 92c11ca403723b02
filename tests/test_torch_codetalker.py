"""The torch port's CodeTalker (stage 2) against the JAX package on the CPU,
at tiny widths (a 2-layer wav2vec2 trunk of 32 channels, feature_dim 32, a
1-layer vertex VQ of 30 vertices): the training forward's losses and its
two quantizations' codes (K4's plain version here), with and without the
BIWI re-trim of a short clip; ``predict``'s codes at every frame and its
motion; three Adam steps in lockstep with the JAX CLI's step under the
frozen mask; ``get_model('stage2')``; the ``train_stage2`` twin on
synthetic clips and on a ``write_biwi`` tree, through ``BiwiDataset``
against the JAX reader.

The JAX params come from ``CodeTalker.init``, ``feat_map`` set non-zero so
the frames do not all share one latent, and reach the port through
``jax_codetalker_to_state_dict`` with ``strict=True``. Losses within 1e-5
relative, codes exact, motion within 1e-4 of its largest magnitude."""

import os

import jax
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.cli.train_stage2 import CODETALKER_FROZEN_SUBSTRINGS
from dyadic_interaction_modeling_tpu.data import datasets as JD
from dyadic_interaction_modeling_tpu.engine.train_state import create_train_state
from dyadic_interaction_modeling_tpu.models import codetalker as JCT
from dyadic_interaction_modeling_tpu.models import wav2vec2 as JW
from dyadic_interaction_modeling_tpu.ops import quantizer as JQ
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import train_stage2 as cli_stage2
from dyadic_interaction_modeling_tpu_torch.data import datasets as TD
from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_biwi
from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
from dyadic_interaction_modeling_tpu_torch.models import codetalker as TCT
from dyadic_interaction_modeling_tpu_torch.models import get_model
from dyadic_interaction_modeling_tpu_torch.models import wav2vec2 as TW
from dyadic_interaction_modeling_tpu_torch.ops import quantizer as TQ
from dyadic_interaction_modeling_tpu_torch.utils import weights as W
from dyadic_interaction_modeling_tpu_torch.utils.checkpoint import load_torch_checkpoint

VDIM, L = 90, 6
SAMPLES = 130  # 25 then 12 conv frames: 2 * L, the BIWI alignment
TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
            zquant_dim=16, n_embed=24, feature_dim=32, vertice_dim=VDIM, in_dim=VDIM, n_head=2,
            num_layers=2, period=5)
TINY_ARGS = [str(x) for kv in TINY.items() for x in kv]


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


def _cfg(mod, **kw):
    cfg = mod.codetalker_defaults()
    cfg.update({**TINY, **kw})
    return cfg


def _w2v(mod):
    return mod.W2VConfig(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
                         hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=64, num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4)


def _batch(seed, b=1, samples=SAMPLES, l=L):
    rng = np.random.default_rng(seed)
    template = (rng.standard_normal((b, VDIM)) * 0.1).astype(np.float32)
    vertice = template[:, None] + (rng.standard_normal((b, l, VDIM)) * 0.05).astype(np.float32)
    one_hot = np.eye(6, dtype=np.float32)[[2, 4][:b]]
    return rng.standard_normal((b, samples)).astype(np.float32), template, vertice, one_hot


@pytest.fixture(scope="module", params=[1, 2], ids=["fq1", "fq2"])
def pair(request):
    """(JAX model, params, port model factory, cfg) at face_quan_num 1 or 2."""
    fq = request.param
    jcfg, tcfg = _cfg(JC, face_quan_num=fq), _cfg(TC, face_quan_num=fq)
    jm = JCT.CodeTalker(jcfg, w2v_cfg=_w2v(JW))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                                 *_batch(0)))["params"]
    rng = np.random.default_rng(1)
    params["feat_map"]["kernel"] = (rng.standard_normal(params["feat_map"]["kernel"].shape)
                                    * 0.3).astype(np.float32)
    sd = W.jax_codetalker_to_state_dict(params, tcfg)

    def torch_model():
        tm = TCT.CodeTalker(tcfg, _w2v(TW))
        tm.load_state_dict(sd, strict=True)
        return tm

    return jm, params, torch_model, tcfg


class _Codes:
    """Records the codes of every quantization, JAX's and the port's."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        j_orig, t_orig = JQ.nearest_code, TQ._nearest_code

        def j_rec(z, e):
            idx = j_orig(z, e)
            jax.debug.callback(lambda x: self.jax.append(np.asarray(x)), idx, ordered=True)
            return idx

        def t_rec(z, e):
            idx = t_orig(z, e)
            self.torch.append(idx.numpy())
            return idx

        monkeypatch.setattr(JQ, "nearest_code", j_rec)
        monkeypatch.setattr(TQ, "_nearest_code", t_rec)


@pytest.mark.parametrize("samples", [SAMPLES, 110], ids=["aligned", "short_audio"])
def test_forward_matches_jax(pair, samples, monkeypatch):
    """Losses within 1e-5 relative and both quantizations' codes exact; the
    short clip (10 audio frames for 6 motion frames) re-trims to 5 frames."""
    jm, params, torch_model, _ = pair
    batch = _batch(2, b=2, samples=samples)
    codes = _Codes(monkeypatch)
    total, (lm, lr) = jax.jit(jm.apply)({"params": params}, *batch)
    jax.effects_barrier()
    out, (tm_, tr_) = torch_model()(*(torch.from_numpy(x) for x in batch))
    for a, b in ((out, total), (tm_, lm), (tr_, lr)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    assert len(codes.jax) == len(codes.torch) == 2
    for a, b in zip(codes.torch, codes.jax):
        np.testing.assert_array_equal(a, b)
    frames = L if samples == SAMPLES else 5
    assert codes.torch[1].size == 2 * frames * jm.cfg.face_quan_num
    assert len(np.unique(codes.torch[1])) > 1  # the frames do not share one code


def test_predict_matches_jax(pair, monkeypatch):
    """Every frame's codes (JAX's fixed buffer restricted to the live prefix
    against the port's growing prefix), the final codes and the motion, for
    a clip of 4 frames (90 samples: 8 conv frames); a blend of two styles."""
    jm, params, torch_model, cfg = pair
    audio, template, _, one_hot = _batch(3, b=2, samples=90)
    codes = _Codes(monkeypatch)
    ref = np.asarray(jax.jit(lambda *a: jm.apply({"params": params}, *a,
                                                 method=JCT.CodeTalker.predict))(
        audio, template, one_hot))
    jax.effects_barrier()
    out = torch_model().eval().predict(*(torch.from_numpy(x) for x in (audio, template, one_hot)))
    fq = cfg.face_quan_num
    assert len(codes.torch) == len(codes.jax) == 4
    for i, (a, b) in enumerate(zip(codes.torch, codes.jax)):
        n = a.size // 2  # the port quantizes the live prefix, JAX the whole buffer
        assert n == (i + 1) * fq
        np.testing.assert_array_equal(a.reshape(2, n), b.reshape(2, -1)[:, :n], err_msg=str(i))
    assert out.shape == ref.shape == (2, 4, VDIM)
    _close(out.numpy(), ref)
    blend = torch_model().eval().predict(
        *(torch.from_numpy(x) for x in (audio, template, one_hot)),
        torch.from_numpy(one_hot[::-1].copy()), 0.3)
    ref_blend = jax.jit(lambda *a: jm.apply({"params": params}, *a, 0.3,
                                            method=JCT.CodeTalker.predict))(
        audio, template, one_hot, one_hot[::-1].copy())
    _close(blend.numpy(), ref_blend)


def test_three_adam_steps_in_lockstep(pair):
    """The JAX CLI's step (value_and_grad, then ``apply_gradients`` of
    ``create_train_state`` with its frozen mask) against ``make_stage2_step``:
    three steps' losses within 1e-5 relative, the frozen parameters
    unchanged on both sides, the trained ones within 1e-4 but for at most
    0.5% of a tensor's elements, whose tiny gradients Adam scales up (those
    within lr / 2)."""
    jm, params, torch_model, _ = pair
    batch = _batch(4)
    state = create_train_state(jm, {"params": params}, 1e-3,
                               frozen_substrings=CODETALKER_FROZEN_SUBSTRINGS)

    @jax.jit
    def jstep(state, *b):
        def loss_fn(p):
            total, aux = jm.apply({"params": p}, *b)
            return total, aux

        (total, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return state.apply_gradients(grads=grads), total

    tm = torch_model()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    step = cli_stage2.make_stage2_step(tm, make_optimizer(tm, 1e-3, 0.0, TCT.CODETALKER_FROZEN))
    tb = tuple(torch.from_numpy(x) for x in batch)
    for _ in range(3):
        state, j_loss = jstep(state, *batch)
        np.testing.assert_allclose(float(step(*tb)["loss"]), float(j_loss), rtol=1e-5)
    final = W.jax_codetalker_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params),
                                           jm.cfg)
    moved = 0
    for k, p in tm.named_parameters():
        ours, theirs = p.detach().clone(), final[k].clone()
        if k.startswith(TCT.CODETALKER_FROZEN):
            assert not p.requires_grad
            assert torch.equal(ours, init[k]) and torch.equal(theirs, init[k]), k
            continue
        # a key bias shifts every score of a row alike: its gradient is zero
        # but for rounding, which Adam scales up to steps of lr either way
        key_bias = (slice(None) if k.endswith("k_proj.bias") else
                    slice(len(p) // 3, 2 * len(p) // 3) if k.endswith("in_proj_bias") else None)
        if key_bias is not None:
            for x in (ours, theirs):
                assert float((x[key_bias] - init[k][key_bias]).abs().max()) <= 3.01e-3, k
                x[key_bias] = init[k][key_bias]
        err = (ours - theirs).abs()
        assert float((err > 1e-4).float().mean()) <= 5e-3 and float(err.max()) <= 5e-4, k
        moved += not torch.equal(ours, init[k])
    assert moved > 20


def test_get_model_builds_stage2():
    cfg = _cfg(TC)
    model = get_model(cfg)
    assert isinstance(model, TCT.CodeTalker)
    assert isinstance(model.autoencoder, TCT.VQAutoEncoder)
    assert model.autoencoder.variant == "BIWI"
    assert not model.feat_map.weight.any()
    cfg.autoencoder = "stage1_vocaset"
    assert get_model(cfg).autoencoder.variant == "vocaset"
    with pytest.raises(ValueError):
        TCT.CodeTalker(_cfg(TC, in_dim=56))


def test_reference_stage2_file_loads_strictly(pair, tmp_path):
    """A reference ``stage2`` checkpoint (``{'state_dict': ...}``, the audio
    encoder's positional conv weight-normed as ``weight_g`` / ``weight_v``)
    loads with ``strict=True`` through ``codetalker_state_dict``."""
    _, _, torch_model, cfg = pair
    want = torch_model().state_dict()
    ref = dict(want)
    pos = "audio_encoder.encoder.pos_conv_embed.conv"
    w = ref.pop(f"{pos}.weight")
    g = w.square().sum(dim=(0, 1), keepdim=True).sqrt()
    ref[f"{pos}.weight_g"], ref[f"{pos}.weight_v"] = g, w * 3.0
    torch.save({"state_dict": ref}, tmp_path / "stage2.pt")
    tm = TCT.CodeTalker(cfg, _w2v(TW))
    tm.load_state_dict(TCT.codetalker_state_dict(load_torch_checkpoint(
        str(tmp_path / "stage2.pt"))), strict=True)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7, msg=k)


def test_train_stage2_synthetic_twin(tmp_path, capsys):
    """Two epochs on the JAX CLI's synthetic clips (short audio: the BIWI
    re-trim) with a one-layer trunk: finite losses, the best state_dict
    loads strictly, the frozen parts unchanged."""
    assert cli_stage2.main(["--synthetic", "--device", "cpu", "--w2v-layers", "1",
                            "--epochs", "2", "--save-path", str(tmp_path / "run"),
                            *TINY_ARGS]) == 0
    losses = [float(line.split("loss ")[1].split()[0])
              for line in capsys.readouterr().out.splitlines() if "(motion" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    best = torch.load(tmp_path / "run" / "best_model.pt", weights_only=True)
    torch.manual_seed(0)
    init = TCT.CodeTalker(_cfg(TC), TW.W2VConfig(num_hidden_layers=1))
    init.load_state_dict(best, strict=True)  # the keys match
    torch.manual_seed(0)
    init = TCT.CodeTalker(_cfg(TC), TW.W2VConfig(num_hidden_layers=1)).state_dict()
    frozen = [k for k in best if k.startswith(TCT.CODETALKER_FROZEN)]
    assert frozen and all(torch.equal(best[k], init[k]) for k in frozen)
    assert not torch.equal(best["audio_feature_map.weight"], init["audio_feature_map.weight"])
    assert cli_stage2.get_parser().parse_args([]).device == "cuda"


CLIPS = [("F2", 1), ("F2", 34), ("F3", 2), ("M3", 38), ("F1", 3), ("F4", 40), ("F5", 39)]


def test_biwi_dataset_matches_jax_reader(tmp_path):
    """``BiwiDataset.read_data`` with the raw audio on a ``write_biwi`` tree:
    the same splits (BIWI_SPLITS: train 1-32, val 33-36, test 37-40) and
    items as the JAX reader's, the waveform normalized."""
    write_biwi(str(tmp_path), CLIPS, n_frames=5, n_vertices=VDIM // 3, wav_samples=700)
    args = (str(tmp_path), "wav", "vertices_npy", "templates.pkl", "BIWI",
            "F2 F3 F4 M3 M4 M5", "F2 F3 F4 M3 M4 M5", "F1 F5 F6 F7 F8 M1 M2 M6")
    for read_audio in (False, True):
        ours = TD.BiwiDataset.read_data(*args, read_audio=read_audio)
        ref = JD.BiwiDataset.read_data(*args, read_audio=read_audio)
        assert ours[3] == ref[3]
        for part_t, part_j, split in zip(ours[:3], ref[:3], ("train", "val", "test")):
            part_j = sorted(part_j, key=lambda d: d["name"])
            assert [d["name"] for d in part_t] == [d["name"] for d in part_j]
            ds_t = TD.BiwiDataset(part_t, ours[3]["train"], split, read_audio)
            ds_j = JD.BiwiDataset(part_j, ref[3]["train"], split, read_audio)
            for i in range(len(ds_t)):
                for a, b in zip(ds_t[i], ds_j[i]):
                    if isinstance(a, str):
                        assert a == b
                    else:
                        np.testing.assert_array_equal(a, b)
    names = [[d["name"] for d in part] for part in ours[:3]]
    assert names == [["F2_01.wav", "F3_02.wav"], ["F2_34.wav"], ["F5_39.wav"]]
    audio = TD.BiwiDataset(ours[0], ours[3]["train"], "train", True)[0][0]
    assert audio.shape == (700,) and abs(float(audio.mean())) < 1e-5


def test_train_stage2_on_biwi_files(tmp_path, capsys):
    """The twin without ``--synthetic`` on a ``write_biwi`` tree: the
    training split's two clips (4000 samples: 12 frames of the base trunk's
    conv stack for 6 motion frames), two epochs; a split without clips
    stops."""
    write_biwi(str(tmp_path / "BIWI"), CLIPS, n_frames=L, n_vertices=VDIM // 3,
               wav_samples=4000)
    assert cli_stage2.main(["--device", "cpu", "--w2v-layers", "1", "--epochs", "2",
                            "--data-root", str(tmp_path / "BIWI"),
                            "--save-path", str(tmp_path / "run"), *TINY_ARGS]) == 0
    losses = [line for line in capsys.readouterr().out.splitlines() if "(motion" in line]
    assert len(losses) == 2
    assert os.path.exists(tmp_path / "run" / "best_model.pt")
    with pytest.raises(SystemExit):
        cli_stage2.main(["--device", "cpu", "--data-root", str(tmp_path / "BIWI"), *TINY_ARGS,
                         "train_subjects", "F7"])
