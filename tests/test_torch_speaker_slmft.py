"""The torch port's BIWI speaker family against the JAX package on the CPU,
at the widths of ``tests/test_slm.py``'s ``_tiny_cfgs`` (vertice_dim 300
for SpeakerSLMFT, 120 for the converter): ``LSTM``, ``MeshHead``,
``EmocaConverter``, ``SpeakerSLMFT.forward`` and ``encode_context``,
``make_speaker_generator`` (greedy and under the JAX draw's Gumbel noise),
three AdamW steps of both models in lockstep with ``create_train_state``,
the weight bridge and reference-layout files, the BIWI reader, LVE/FDD and
the two CLI twins.

The JAX params come from a seeded port model through the JAX package's own
importer (``torch_slm_to_flax`` on an ``eval_shape`` template), so no JAX
init is compiled, and the port's bridge must give that state_dict back
exactly. fp32 within 1e-5 (of the reference's largest magnitude where a
VQ decode amplifies rounding), tokens, codes and reader items exact."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.data import datasets as JD
from dyadic_interaction_modeling_tpu.engine import pt_engine as JE
from dyadic_interaction_modeling_tpu.engine.train_state import create_train_state
from dyadic_interaction_modeling_tpu.metrics.reporting import print_biwi_metrics as j_biwi
from dyadic_interaction_modeling_tpu.models import slm as JS
from dyadic_interaction_modeling_tpu.models.xtrans import TokenDecoder as JTD
from dyadic_interaction_modeling_tpu.models.xtrans import generate_tokens as j_generate
from dyadic_interaction_modeling_tpu.ops.rnn import LSTM as JLSTM
from dyadic_interaction_modeling_tpu.utils.torch_export import flax_slm_to_torch
from dyadic_interaction_modeling_tpu.utils.torch_import import torch_slm_to_flax
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import test_biwi as cli_biwi
from dyadic_interaction_modeling_tpu_torch.cli import train_converter as cli_conv
from dyadic_interaction_modeling_tpu_torch.data import datasets as TD
from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_biwi
from dyadic_interaction_modeling_tpu_torch.engine import pt_engine as TE
from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
from dyadic_interaction_modeling_tpu_torch.metrics.reporting import print_biwi_metrics
from dyadic_interaction_modeling_tpu_torch.models import slm as TS
from dyadic_interaction_modeling_tpu_torch.ops.rnn import LSTM
from dyadic_interaction_modeling_tpu_torch.utils import weights as W
from dyadic_interaction_modeling_tpu_torch.utils.checkpoint import load_reference
from test_torch_slm_train import _jax_equivalent_adamw

TOL = 1e-5
VDIM, CDIM = 300, 120
B, L, N = 2, 10, 3
LR, WD, CLIP = 1e-3, 0.01, 1.0


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(mod):
    slm_cfg = mod.slm_defaults()
    slm_cfg.update(dict(dim=32, dim_audio=16, enc_depth=1, enc_heads=2, dec_depth=1,
                        dec_heads=2, enc_max_seq_len=64, dec_max_seq_len=64, num_tokens=24))
    vq_cfg = mod.vq_listener_defaults()
    vq_cfg.update(dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                       intermediate_size=64, zquant_dim=16, n_embed=24))
    return slm_cfg, vq_cfg


def _close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _batch(seed, b=B, l=L, lens=None):
    rng = np.random.default_rng(seed)
    verts = rng.standard_normal((b, l, VDIM)).astype(np.float32)
    emoca = rng.standard_normal((b, l, 56)).astype(np.float32)
    audio = rng.standard_normal((b, l, 16)).astype(np.float32)
    mask = np.arange(l)[None, :] < np.array(lens or [l] * b)[:, None]
    template = rng.standard_normal((b, VDIM)).astype(np.float32)
    sids = np.array([3, 7][:b], np.int32)
    return verts, emoca, audio, mask, template, sids


def _t(batch):
    return tuple(None if x is None else torch.from_numpy(np.array(x)) for x in batch)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _template(jm, *args):
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def speaker():
    jcfg, jvq = _cfgs(JC)
    tcfg, tvq = _cfgs(TC)
    jm = JS.SpeakerSLMFT(jcfg, jvq, vertice_dim=VDIM)
    template = _template(jm, *_batch(0))
    torch.manual_seed(0)
    port = TS.SpeakerSLMFT(tcfg, tvq, vertice_dim=VDIM)
    with torch.no_grad():  # non-zero patch embeddings, so the tests see them
        for p in (port.patch_embed_dec_l, port.patch_embed_dec_s):
            p.normal_()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = torch_slm_to_flax(sd, jcfg, jvq, variant="speaker_slmft",
                               params_template=template)["params"]
    back = W.jax_speaker_slmft_to_state_dict(params, tcfg, tvq)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k], rtol=1e-6, atol=1e-7, err_msg=k)

    def torch_model():
        tm = TS.SpeakerSLMFT(tcfg, tvq, vertice_dim=VDIM)
        tm.load_state_dict(back, strict=True)
        return tm

    return jm, _tree_np(params), jcfg, jvq, tcfg, tvq, torch_model


@pytest.mark.parametrize("layers,bidir,size", [(2, True, (12, 16)), (1, False, (8, 6)),
                                               (2, True, (56, 384))])
def test_lstm_matches_jax(layers, bidir, size):
    """torch's own names and layout: the JAX tree loads with strict=True."""
    in_dim, hidden = size
    x = np.random.default_rng(1).standard_normal((3, 9, in_dim)).astype(np.float32)
    jm = JLSTM(hidden_size=hidden, num_layers=layers, bidirectional=bidir)
    params = _tree_np(jm.init(jax.random.PRNGKey(0), x))["params"]
    ref = jm.apply({"params": params}, x)
    tm = LSTM(in_dim, hidden, layers, bidir)
    tm.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert out.shape == (3, 9, hidden * (2 if bidir else 1))
    _close(out.numpy(), ref)


def test_mesh_head_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5, 768)).astype(np.float32)
    jm = JS.MeshHead(CDIM)
    params = _tree_np(jm.init(jax.random.PRNGKey(0), x))["params"]
    ref = jm.apply({"params": params}, x)
    sd = {}
    W._dense(sd, "0", params["l1"])
    W._dense(sd, "2", params["l2"])
    tm = TS.MeshHead(CDIM)
    tm.load_state_dict(W._to_torch(sd), strict=True)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), ref)


@pytest.fixture(scope="module")
def converter():
    _, jvq = _cfgs(JC)
    _, tvq = _cfgs(TC)
    jm = JS.EmocaConverter(jvq, vertice_dim=CDIM)
    x = np.zeros((2, 9, 56), np.float32)
    template = _template(jm, np.zeros((2, CDIM), np.float32), x)
    torch.manual_seed(1)
    sd = {k: v.numpy() for k, v in TS.EmocaConverter(tvq, CDIM).state_dict().items()}
    params = _tree_np(torch_slm_to_flax(sd, None, jvq, variant="converter",
                                        params_template=template)["params"])
    back = W.jax_converter_to_state_dict(params, tvq)
    assert set(back) == set(sd)

    def torch_model():
        tm = TS.EmocaConverter(tvq, CDIM)
        tm.load_state_dict(back, strict=True)
        return tm

    return jm, params, jvq, tvq, torch_model


def _conv_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, CDIM)).astype(np.float32),
            rng.standard_normal((2, 9, 56)).astype(np.float32),
            rng.standard_normal((2, 9, CDIM)).astype(np.float32))


def test_emoca_converter_forward_matches_jax(converter):
    jm, params, _, _, torch_model = converter
    tmpl, emoca, _ = _conv_batch(3)
    ref = jm.apply({"params": params}, tmpl, emoca)
    with torch.no_grad():
        out = torch_model()(torch.from_numpy(tmpl), torch.from_numpy(emoca))
    assert out.shape == (2, 9, CDIM)
    _close(out.numpy(), ref)


MOUTH = list(range(0, VDIM // 3, 2))


@pytest.mark.parametrize("with_ids,mouth", [(True, True), (False, False), (True, False)])
def test_speaker_forward_matches_jax(speaker, with_ids, mouth):
    """Loss, the six logs and the decoded EMOCA; the mouth MSE only logged."""
    jm, params, *_, torch_model = speaker
    batch = list(_batch(4, lens=[L, 7]))
    if not with_ids:
        batch[5] = None
    mm = MOUTH if mouth else None
    out = jax.jit(lambda p, b: jm.apply({"params": p}, *b,
                                        mouth_map=None if mm is None else jnp.asarray(mm)))(
        params, tuple(batch))
    with torch.no_grad():
        tout = torch_model()(*_t(batch), mouth_map=mm)
    np.testing.assert_allclose(float(tout.total_loss), float(out.total_loss), rtol=TOL)
    assert set(tout.logs) == set(out.logs) and len(out.logs) == 6
    for k in out.logs:
        np.testing.assert_allclose(float(tout.logs[k]), float(out.logs[k]), rtol=TOL,
                                   atol=1e-7, err_msg=k)
    assert (float(out.logs["l_cont_s"]) > 0) == mouth
    _close(tout.pred.numpy(), out.pred)


def test_encode_context_matches_jax(speaker):
    jm, params, *_, torch_model = speaker
    batch = _batch(5, lens=[L, 6])
    ctx, prompt = jax.jit(lambda p, b: jm.apply({"params": p}, *b,
                                                method=JS.SpeakerSLMFT.encode_context))(
        params, batch)
    tm = torch_model()
    with torch.no_grad():
        tctx, tprompt = tm.encode_context(*_t(batch))
        codes = tm.tokenize_emoca_frames(torch.from_numpy(batch[1]))
    _close(tctx.numpy(), ctx)
    np.testing.assert_array_equal(tprompt.numpy(), np.asarray(prompt))
    ref = jax.jit(lambda p, e: jm.apply({"params": p}, e,
                                        method=JS.SpeakerSLMFT.tokenize_emoca_frames))(
        params, batch[1])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))


def _jax_speaker_tokens(jm, params, jcfg, batch, key, greedy):
    """The JAX make_speaker_generator's computation, its tokens returned."""
    dec = JTD(num_tokens=jcfg.num_tokens, dim=jcfg.dim + jcfg.dim_audio,
              max_seq_len=jcfg.dec_max_seq_len, depth=jcfg.dec_depth,
              heads=jcfg.dec_heads, use_abs_pos_emb=True)

    @jax.jit
    def run(params, batch, key):
        ctx, prompt = jm.apply({"params": params}, *batch,
                               method=JS.SpeakerSLMFT.encode_context)
        return j_generate(dec, {"params": params["decoder_joint"]}, jnp.tile(prompt, (N, 1)),
                          L - 1, ctx, batch[3], key, greedy=greedy, context_groups=N)

    return np.asarray(run(params, batch, key))


@pytest.mark.parametrize("greedy", [True, False])
def test_speaker_generator_matches_jax(speaker, greedy):
    """Greedy tokens exact; sampled tokens exact under the JAX draw's Gumbel
    noise (one split of the key a step, as ``generate_tokens`` draws), and
    the candidates equal to the JAX package's ``make_speaker_generator``."""
    jm, params, jcfg, *_, torch_model = speaker
    batch = _batch(6)
    key = jax.random.PRNGKey(7)
    ref_toks = _jax_speaker_tokens(jm, params, jcfg, batch, key, greedy)
    gumbel = None
    if not greedy:
        noise, rng = [], key
        for _ in range(L - 1):
            rng, sub = jax.random.split(rng)
            noise.append(np.asarray(jax.random.gumbel(sub, (N * B, jcfg.num_tokens))))
        gumbel = torch.from_numpy(np.stack(noise))
    gen = TE.make_speaker_generator(torch_model().eval())
    cands, toks = gen(_t(batch), None, N, greedy=greedy, gumbel=gumbel, return_tokens=True)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    assert cands.shape == (B, N, L - 1, 56)
    if not greedy:
        ref = np.asarray(JE.make_speaker_generator(jm, jcfg, L)(params, batch, key, N))
        _close(cands.numpy(), ref)
        best = TE.select_best_by_l2(cands[0].numpy(), batch[1][0, 1:])
        _close(best, JE.select_best_by_l2(ref[0], batch[1][0, 1:]))


def _no_grad_leaves(tm, batch):
    """The trainable leaves the loss does not reach (grad None)."""
    tm.zero_grad(set_to_none=True)
    tm(*_t(batch), mouth_map=MOUTH).total_loss.backward()
    out = {k for k, p in tm.named_parameters() if p.requires_grad and p.grad is None}
    tm.zero_grad(set_to_none=True)
    return out


def test_speaker_three_adamw_clip_steps_in_lockstep(speaker):
    """The JAX package's step (value_and_grad, clip 1.0, AdamW under
    SPEAKER_SLMFT_FROZEN_SUBSTRINGS) beside ``make_speaker_train_step`` with
    ``SPEAKER_SLMFT_FROZEN``, the decoder's position table mapped to the JAX
    package's parametrization (``_jax_equivalent_adamw``): losses within
    1e-4 (the first step's within 1e-5; Adam turns rounding-level gradient
    entries, as of the bias below, into lr-sized updates that differ, which
    the third step's loss shows at ~3e-5), frozen leaves bitwise unchanged,
    every leaf with a gradient within 1e-4 (median difference), but for the
    speaker VQ decoder's conv bias, held only to Adam's step bound: a
    LeakyReLU and a non-affine instance norm follow it, so on a channel
    whose pre-activations keep one sign over these 9 frames its gradient is
    0 but for rounding. A trainable leaf the loss does not reach (the mesh
    head, ``W``, unused patch embeddings) keeps its value in the port, as
    torch's AdamW (the reference's) skips a parameter without a gradient,
    while optax decays it by (1 - lr * wd) a step: a deliberate difference."""
    jm, params, _, _, tcfg, _, torch_model = speaker

    def loss(p, batch):
        out = jm.apply({"params": p}, *batch, mouth_map=jnp.asarray(MOUTH))
        return out.total_loss

    vg = jax.jit(jax.value_and_grad(loss))
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD, clip_norm=CLIP,
                               frozen_substrings=JS.SPEAKER_SLMFT_FROZEN_SUBSTRINGS)
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    tm = torch_model()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = _jax_equivalent_adamw(tm, tcfg, LR, WD, frozen=TS.SPEAKER_SLMFT_FROZEN)
    step = TE.make_speaker_train_step(tm, opt, CLIP)
    idle = _no_grad_leaves(tm, _batch(10))
    assert {"W", "vertice_map_reverse.2.weight", "patch_embed_s"} <= idle
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _batch(10 + i, lens=[L, 8])
        jl, g = vg(state.params, batch)
        state = apply(state, g)
        logs = step(_t(batch), mouth_map=MOUTH)
        j_losses.append(float(jl))
        t_losses.append(float(logs["l_ce_l"] + logs["l_cont_l"]))
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=TOL)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    final = W.jax_speaker_slmft_to_state_dict(_tree_np(state.params), tcfg, _cfgs(TC)[1])
    moved = 0
    for k, p in tm.named_parameters():
        ours, theirs = p.detach(), final[k]
        if k.startswith(TS.SPEAKER_SLMFT_FROZEN):
            assert not p.requires_grad
            assert torch.equal(ours, init[k]) and torch.equal(theirs, init[k]), k
        elif k in idle:
            assert torch.equal(ours, init[k]), k
            torch.testing.assert_close(theirs, init[k] * (1 - LR * WD) ** 3, rtol=1e-6,
                                       atol=1e-7)
        elif k == "speaker_vq.decoder.expander.0.0.bias":
            assert float((ours - theirs).abs().max()) <= 2 * 3 * LR * 1.01, k
        else:
            moved += int(not torch.equal(ours, init[k]))
            assert float((ours - theirs).abs().median()) < 1e-4, k
    assert moved > 20, moved


def test_converter_three_adamw_steps_in_lockstep(converter):
    """train_converter's loss (MSE + 5 x mouth MSE), AdamW (wd 0.01, no
    clip) under CONVERTER_FROZEN_SUBSTRINGS beside ``make_converter_step``."""
    jm, params, _, tvq, torch_model = converter
    mouth = list(range(0, CDIM // 3, 3))

    def loss(p, tmpl, emoca, verts):
        out = jm.apply({"params": p}, tmpl, emoca)
        o = out.reshape(out.shape[0], out.shape[1], -1, 3)[:, :, jnp.asarray(mouth)]
        v = verts.reshape(out.shape[0], out.shape[1], -1, 3)[:, :, jnp.asarray(mouth)]
        return jnp.mean(jnp.square(out - verts)) + 5.0 * jnp.mean(jnp.square(o - v))

    vg = jax.jit(jax.value_and_grad(loss))
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD,
                               frozen_substrings=JS.CONVERTER_FROZEN_SUBSTRINGS)
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    tm = torch_model()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    step = cli_conv.make_converter_step(tm, make_optimizer(tm, LR, WD, TS.CONVERTER_FROZEN),
                                        0.0, mouth, 5.0)
    for i in range(3):
        batch = _conv_batch(20 + i)
        jl, g = vg(state.params, *batch)
        state = apply(state, g)
        np.testing.assert_allclose(float(step(*_t(batch))), float(jl), rtol=TOL)
    final = W.jax_converter_to_state_dict(_tree_np(state.params), tvq)
    for k, p in tm.named_parameters():
        if k.startswith(TS.CONVERTER_FROZEN):
            assert torch.equal(p.detach(), init[k]) and torch.equal(final[k], init[k]), k
        else:
            assert not torch.equal(p.detach(), init[k]), k
            assert float((p.detach() - final[k]).abs().median()) < 1e-4, k


def _reference_file(sd, extra, path):
    torch.save({"state_dict": {f"module.{k}": torch.as_tensor(np.array(v))
                               for k, v in {**sd, **extra}.items()}}, path)


def test_reference_layout_files_load(speaker, converter, tmp_path):
    """A reference-layout dict from the JAX package's exporter
    (``flax_slm_to_torch``) with what a reference file adds (the encoders,
    norms, the listener VQ's decoder, the second mesh head; for the
    converter also the vertices front-end) loads through ``load_reference``
    with exactly those prefixes dropped, equal to the bridge's state_dict;
    a foreign key still raises."""
    jm, params, jcfg, jvq, tcfg, tvq, torch_model = speaker
    sd = flax_slm_to_torch(params, jcfg, jvq, variant="speaker_slmft")
    slm = TS.SLM(tcfg, tvq).state_dict()
    extra = {k: v for k, v in slm.items()
             if k.startswith(("encoder_", "norm", "listener_vq.decoder."))}
    for k, v in TS.EmocaConverter(tvq, VDIM).state_dict().items():
        if k.startswith("vertice_map_reverse"):
            extra[k.replace("lstm", "lstm_2") if "lstm" in k
                  else k.replace("reverse", "reverse2")] = v
    assert all(k.startswith(TS.SPEAKER_SLMFT_REFERENCE_ONLY) for k in extra)
    _reference_file(sd, extra, tmp_path / "speaker.pt")
    tm = TS.SpeakerSLMFT(tcfg, tvq, vertice_dim=VDIM)
    load_reference(tm, str(tmp_path / "speaker.pt"),
                   drop_prefixes=TS.SPEAKER_SLMFT_REFERENCE_ONLY)
    want = torch_model().state_dict()
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    _reference_file(sd, {**extra, "encoder_x.weight": np.zeros(1)}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="no place"):
        load_reference(tm, str(tmp_path / "bad.pt"),
                       drop_prefixes=TS.SPEAKER_SLMFT_REFERENCE_ONLY)

    cj, cparams, cjvq, ctvq, conv_model = converter
    csd = flax_slm_to_torch(cparams, None, cjvq, variant="converter")
    cextra = {k.replace("lstm", "lstm_2"): v for k, v in csd.items()
              if k.startswith("vertice_map_reverse_lstm.")}
    cextra.update({"vertice_mapping.0.weight": np.zeros((56, CDIM)),
                   "vertice_mapping.0.bias": np.zeros(56),
                   "squasher.0.0.weight": np.zeros((56, 56, 5)),
                   "squasher.0.0.bias": np.zeros(56)})
    _reference_file(csd, cextra, tmp_path / "converter.pt")
    cm = TS.EmocaConverter(ctvq, CDIM)
    load_reference(cm, str(tmp_path / "converter.pt"), drop_prefixes=TS.CONVERTER_REFERENCE_ONLY)
    want = conv_model().state_dict()
    for k, v in cm.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


CLIPS = [("F2", 1), ("F2", 37), ("F1", 37), ("M3", 2), ("F5", 38), ("F3", 12)]


def _extractor(wav):
    """A numpy stand-in for HuBERT: (T, 8) frames of 400 samples."""
    n = len(wav) // 400
    return wav[: n * 400].reshape(n, 400)[:, ::50] * 10.0


@pytest.mark.parametrize("extract", [_extractor, None])
def test_biwi_reader_matches_jax(tmp_path, extract):
    """Splits (val equal to test, sentences 37-40), EMOCA pose + exp in frame
    order, the corrupt clip skipped, and the dataset's items with audio
    interpolated to the vertex frames: equal to the JAX package's."""
    write_biwi(str(tmp_path), CLIPS, n_frames=7, n_vertices=30, corrupt_clip=("M3", 2))
    ref = JD.read_biwi_emoca_data(str(tmp_path), extract)
    out = TD.read_biwi_emoca_data(str(tmp_path), extract)
    assert out[3] == ref[3]
    names = [[d["name"] for d in part] for part in out[:3]]
    assert names == [[d["name"] for d in part] for part in ref[:3]]
    assert names == [["F2_01.wav", "F3_12.wav"], ["F2_37.wav"], ["F1_37.wav", "F5_38.wav"]]
    for part_t, part_j, split in zip(out[:3], ref[:3], ("train", "val", "test")):
        ds_t = TD.BiwiEmocaDataset(part_t, split, read_audio=extract is not None)
        ds_j = JD.BiwiEmocaDataset(part_j, split, read_audio=extract is not None)
        assert len(ds_t) == len(ds_j)
        for i in range(len(ds_t)):
            for a, b in zip(ds_t[i], ds_j[i]):
                if isinstance(a, str):
                    assert a == b
                else:
                    np.testing.assert_array_equal(a, b)
    if extract is not None:
        audio, vertice = TD.BiwiEmocaDataset(out[0])[0][:2]
        assert audio.shape == (7, 8) and vertice.shape == (7, 90)


def test_print_biwi_metrics_matches_jax():
    rng = np.random.default_rng(9)
    nv = 40
    templates = {s: rng.standard_normal(nv * 3) for s in ("F2", "M1")}
    names = ["F2_01.wav", "M1_03.wav", "F2_05.wav"]
    gt = [rng.standard_normal((t, nv * 3)) for t in (9, 6, 11)]
    pred = [rng.standard_normal((t + 1, nv * 3)) for t in (9, 6, 11)]
    mouth, upper = list(range(0, nv, 3)), list(range(nv // 2, nv))
    ours = print_biwi_metrics(gt, pred, names, templates, mouth, upper, nv, verbose=False)
    ref = j_biwi(gt, pred, names, templates, mouth, upper, nv, verbose=False)
    assert ours == ref


TINY_SLM = ["dim", "32", "enc_depth", "1", "dec_depth", "1", "enc_heads", "2",
            "dec_heads", "2"]


def test_test_biwi_twin_on_cpu(tmp_path, capsys):
    """``--synthetic`` at a tiny width: the gt/pred ``.npy`` files of 4
    clips, finite LVE and FDD; the same run from the model's state_dict
    saved in the reference layout with the reference-only parts added gives
    the same predictions; ``--data-root`` on a missing tree raises
    ``FileNotFoundError``, as the JAX CLI does."""
    run = tmp_path / "a"
    assert cli_biwi.main(["--synthetic", "--device", "cpu", "--vertice-dim", str(VDIM),
                          "--out-dir", str(run), *TINY_SLM]) == 0
    text = capsys.readouterr().out
    lve, fdd = (float(x) for x in text.split("LVE ")[1].split()[::2][:2])
    assert np.isfinite(lve) and np.isfinite(fdd)
    files = sorted(os.listdir(run / "pred"))
    assert files == ["F2_01.npy", "F2_03.npy", "F3_02.npy", "F3_04.npy"]
    assert np.load(run / "pred" / files[0]).shape == (15, 56)
    np.testing.assert_array_equal(np.load(run / "gt" / files[0]).shape, (15, 56))
    cfg = TC.merge_cfg_from_list(TC.slm_defaults(), TINY_SLM)
    torch.manual_seed(0)
    sd = TS.SpeakerSLMFT(cfg, TC.vq_cfg_for(cfg, True), vertice_dim=VDIM).state_dict()
    torch.save({"state_dict": {**sd, "vertice_map_reverse2.0.bias": torch.zeros(768)}},
               tmp_path / "ref.pt")
    again = tmp_path / "b"
    assert cli_biwi.main(["--synthetic", "--device", "cpu", "--vertice-dim", str(VDIM),
                          "--out-dir", str(again), "--torch-checkpoint",
                          str(tmp_path / "ref.pt"), *TINY_SLM]) == 0
    for f in files:
        np.testing.assert_array_equal(np.load(again / "pred" / f), np.load(run / "pred" / f))
    # as the JAX CLI: the extractor is built, then the missing tree's templates fail to open
    with pytest.raises(FileNotFoundError, match="templates.pkl"):
        cli_biwi.main(["--data-root", str(tmp_path / "missing"), "--device", "cpu"])
    assert cli_biwi.get_parser().parse_args([]).device == "cuda"


def test_train_converter_twin_on_cpu(tmp_path, capsys):
    """Two epochs at a tiny width with a mouth map: finite falling losses, the
    frozen speaker VQ unchanged in the best state_dict, which loads
    strictly; without ``--synthetic`` it stops as the JAX CLI does."""
    mouth = tmp_path / "lve.txt"
    mouth.write_text(", ".join(str(i) for i in range(0, CDIM // 3, 2)))
    tiny = ["hidden_size", "32", "num_hidden_layers", "1", "num_attention_heads", "2",
            "intermediate_size", "64", "zquant_dim", "16"]
    assert cli_conv.main(["--synthetic", "--device", "cpu", "--vertice-dim", str(CDIM),
                          "--mouth-map", str(mouth), "--epochs", "2", "--lr", "1e-3",
                          "--save-path", str(tmp_path / "run"), *tiny]) == 0
    losses = [float(line.split("loss ")[1]) for line in capsys.readouterr().out.splitlines()
              if "loss" in line]
    assert len(losses) == 2 and np.isfinite(losses).all() and losses[1] < losses[0]
    vq_cfg = TC.merge_cfg_from_list(TC.vq_listener_defaults(), tiny)
    torch.manual_seed(0)
    init = TS.EmocaConverter(vq_cfg, CDIM).state_dict()
    best = torch.load(tmp_path / "run" / "best_model.pt", weights_only=True)
    model = TS.EmocaConverter(vq_cfg, CDIM)
    model.load_state_dict(best, strict=True)
    for k, v in best.items():
        assert torch.equal(v, init[k]) == k.startswith(TS.CONVERTER_FROZEN), k
    with pytest.raises(SystemExit, match="pairing"):
        cli_conv.main(["--device", "cpu"])
