"""The torch port's seq2seq listener path against the JAX package's, at the
JAX tests' tiny width (dim 32, one encoder and one decoder layer, 2 heads,
24 codes; ``tests/test_listener_generator.py:15``): ``ListenerGenerator``
(with and without ids, both speaker-feature layouts, speaker VQ
``face_quan_num`` 1 and 2), ``Seq2SeqTransformer``, ``ContinuousSeq2Seq``,
``SimpleLSTM``, three AdamW steps of both train steps in lockstep,
``evaluate_epoch``, sampling at temperature 0.7 / filter 0.2 under the
JAX package's Gumbel noise, the greedy ``test_s2s`` twin against the JAX
package's loop, ``LmListenerDataset``, ``test_l2l`` and the reference-layout
file of ``flax_listener_generator_to_torch``.

The JAX params come from a seeded port model through the JAX package's own
importer on an ``eval_shape`` template, so no JAX init is compiled, and the
port's bridge must give that state_dict back exactly.
"""

import contextlib
import io
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.data.datasets import LmListenerDataset as JLmListener
from dyadic_interaction_modeling_tpu.engine import s2s_engine as JE
from dyadic_interaction_modeling_tpu.engine.train_state import create_train_state
from dyadic_interaction_modeling_tpu.models import listener_generator as JL
from dyadic_interaction_modeling_tpu.models.xtrans import generate_tokens as j_generate
from dyadic_interaction_modeling_tpu.utils.torch_export import (
    flax_listener_generator_to_torch, save_state_dict)
from dyadic_interaction_modeling_tpu.utils.torch_import import (
    torch_listener_generator_to_flax)
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import test_l2l, test_s2s, train_s2s
from dyadic_interaction_modeling_tpu_torch.data.datasets import LmListenerDataset
from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_lm_listener
from dyadic_interaction_modeling_tpu_torch.engine import s2s_engine as TE
from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
from dyadic_interaction_modeling_tpu_torch.metrics.reporting import print_metrics
from dyadic_interaction_modeling_tpu_torch.models import listener_generator as TL
from dyadic_interaction_modeling_tpu_torch.models.xtrans import generate_tokens
from dyadic_interaction_modeling_tpu_torch.utils.weights import (
    jax_continuous_seq2seq_to_state_dict, jax_listener_generator_to_state_dict,
    jax_simple_lstm_to_state_dict)
from test_torch_slmft import _clustered_motion
from tests.test_torch_observability import assert_run_record, no_tensorboard  # noqa: F401

LG_TINY = dict(dim=32, enc_depth=1, enc_heads=2, enc_max_seq_len=64, dec_num_tokens=24,
               dec_depth=1, dec_heads=2, dec_max_seq_len=64, num_identities=10,
               id_embed_dim=8)
VQ_TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=64, zquant_dim=16, n_embed=24)
B, L = 2, 12
TOL = 1e-5
FROZEN_J = ("speaker_vq/", "listener_vq/quantize", "listener_vq/encoder")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the models are tiny, and the test run's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(fq=1, **lg):
    jcfg, tcfg = JC.listener_generator_defaults(), TC.listener_generator_defaults()
    jvq, tvq = JC.vq_listener_defaults(), TC.vq_listener_defaults()
    for c in (jcfg, tcfg):
        c.update({**LG_TINY, **lg})
    for c in (jvq, tvq):
        c.update(VQ_TINY)
    jsp, tsp = JC.vq_listener_defaults(), TC.vq_listener_defaults()
    for c in (jsp, tsp):
        c.update({**VQ_TINY, "face_quan_num": fq})
    return jcfg, jsp, jvq, tcfg, tsp, tvq


def _batch(seed, lens=(L, 9)):
    rng = np.random.default_rng(seed)
    vs = rng.standard_normal((B, L, 56)).astype(np.float32)
    vl = rng.standard_normal((B, L, 56)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array(lens)[:, None]
    return vs, vl, mask, np.array([1, 2], np.int32), np.array([3, 4], np.int32)


def _t(batch):
    return tuple(torch.from_numpy(np.array(x)) for x in batch)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lg_pair(fq, with_ids=True, seed=0, **lg):
    """(JAX params, port state_dict, cfgs): a seeded port model through the
    JAX package's importer, and the port's bridge of the result."""
    jcfg, jsp, jvq, tcfg, tsp, tvq = _cfgs(fq, **lg)
    jm = JL.ListenerGenerator(jcfg, jsp, jvq)
    args = _batch(0)[:3] + ((np.zeros(B, np.int32),) * 2 if with_ids else ())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    torch.manual_seed(seed)
    sd = {k: v.numpy() for k, v in TL.ListenerGenerator(tcfg, tsp, tvq, with_ids).state_dict()
          .items()}
    params = torch_listener_generator_to_flax(sd, jcfg, jsp, jvq,
                                              params_template=template)["params"]
    back = jax_listener_generator_to_state_dict(params, tcfg, tsp, tvq)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k], rtol=1e-6, atol=1e-7, err_msg=k)
    return params, back, (jcfg, jsp, jvq, tcfg, tsp, tvq)


@pytest.fixture(scope="module")
def lg():
    """The fq = 1 and fq = 2 (speaker VQ) pairs, with ids."""
    return {fq: _lg_pair(fq) for fq in (1, 2)}


def _port(pair, layout="reference", with_ids=True):
    _, sd, (_, _, _, tcfg, tsp, tvq) = pair
    tm = TL.ListenerGenerator(tcfg, tsp, tvq, with_ids, speaker_feature_layout=layout)
    tm.load_state_dict(sd, strict=True)
    return tm


def _jax_model(pair, layout="reference"):
    jcfg, jsp, jvq = pair[2][:3]
    return JL.ListenerGenerator(jcfg, jsp, jvq, speaker_feature_layout=layout)


@pytest.mark.parametrize("fq", [1, 2])
@pytest.mark.parametrize("layout", ["reference", "frames"])
def test_forward_matches_jax(lg, fq, layout):
    """Loss and ``pred_cont_seq`` within 1e-5, with and without ids, and the
    argmax codes exactly; the speaker features of both layouts equal."""
    pair = lg[fq]
    params, jm, tm = pair[0], _jax_model(pair, layout), _port(pair, layout).eval()
    batch = _batch(1)

    @jax.jit
    def run(p, vs, vl, mask, sp, li):
        with_ids = jm.apply({"params": p}, vs, vl, mask, sp, li)
        without = jm.apply({"params": p}, vs, vl, mask)

        def streams_and_logits(m):
            x_sp, z_li = m._encode_streams(vs, vl, mask)
            return x_sp, z_li, m.generator(x_sp, z_li, mask, None)[1]

        return with_ids, without, jm.apply({"params": p}, method=streams_and_logits)

    jw, jn, (jx, jz, jlogits) = run(params, *map(jnp.asarray, batch))
    vs, vl, mask, sp, li = _t(batch)
    with torch.no_grad():
        tw, tn = tm(vs, vl, mask, sp, li), tm(vs, vl, mask)
        tx, tz = tm._encode_streams(vs, vl, mask)
        tlogits = tm.generator(tx, tz, mask, None)[1]
    for got, want in ((tw, jw), (tn, jn)):
        np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.pred_cont_seq.numpy(), np.asarray(want.pred_cont_seq),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tlogits.argmax(-1).numpy(),
                                  np.asarray(jlogits).argmax(-1))
    assert tx.shape == (B, L, 16 * fq) and tw.pred_cont_seq.shape == (B, L - 1, 56)


def test_bridge_and_reference_file(lg, tmp_path):
    """The JAX package's reference-layout file (``flax_listener_generator_to_torch``)
    loads with ``strict=True`` into the port and holds the bridge's tensors;
    without ids the port has no id parts, which ``test_s2s`` drops by name."""
    params, sd, (jcfg, jsp, jvq, tcfg, tsp, tvq) = lg[2]
    path = tmp_path / "seq2seq.pt"
    save_state_dict(flax_listener_generator_to_torch(params, jcfg, jsp, jvq), str(path))
    tm = TL.ListenerGenerator(tcfg, tsp, tvq)
    from dyadic_interaction_modeling_tpu_torch.utils.checkpoint import load_reference

    load_reference(tm, str(path))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bare = TL.ListenerGenerator(tcfg, tsp, tvq, with_ids=False)
    load_reference(bare, str(path), drop_prefixes=TL.LG_REFERENCE_ONLY + TL.LG_ID_PARTS)
    assert not any(k.startswith(TL.LG_ID_PARTS) for k in bare.state_dict())


def test_seq2seq_transformer_with_listener_ids():
    """The listener-id row prepended and sliced off again: (2, 9, 24) logits
    and the loss within 1e-5 of the JAX package's."""
    jcfg, *_, tcfg, _, _ = _cfgs()
    jm = JL.Seq2SeqTransformer(jcfg, dim_in=16)
    rng = np.random.default_rng(2)
    src = rng.standard_normal((2, 10, 16)).astype(np.float32)
    tgt = rng.integers(0, 24, (2, 10)).astype(np.int32)
    mask = np.arange(10)[None, :] < np.array([[10], [7]])
    lid = rng.standard_normal((2, 32)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), src, tgt, mask, lid)["params"]
    sd = jax_listener_generator_to_state_dict({"generator": _tree_np(params)}, tcfg, None,
                                              None)
    tm = TL.Seq2SeqTransformer(tcfg, dim_in=16)
    tm.load_state_dict({k[len("generator."):]: v for k, v in sd.items()}, strict=True)
    run = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))
    for extra in ((lid,), ()):
        jloss, jlogits = run(params, src, tgt, mask, *extra)
        with torch.no_grad():
            tloss, tlogits = tm(*_t((src, tgt, mask) + extra))
        assert tlogits.shape == (2, 9, 24)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)


def _continuous_pair(dim_in, seed=0):
    jcfg, *_, tcfg, _, _ = _cfgs()
    jm = JL.ContinuousSeq2Seq(jcfg, out_dim=56)
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((2, L, dim_in)).astype(np.float32)
    tgt = (np.cumsum(rng.standard_normal((2, L, 56)), axis=1) * 0.1).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([[L], [8]])
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), src, tgt, mask)["params"]
    tm = TL.ContinuousSeq2Seq(tcfg, dim_in=dim_in)
    tm.load_state_dict(jax_continuous_seq2seq_to_state_dict(_tree_np(params), tcfg),
                       strict=True)
    return jm, params, tm, (src, tgt, mask)


@pytest.mark.parametrize("dim_in", [56, 824])
def test_continuous_seq2seq_matches_jax(dim_in):
    """The masked MSE of the next frame at the CLI's 56 input columns and the
    JAX test's 824, with and without a mask."""
    jm, params, tm, (src, tgt, mask) = _continuous_pair(dim_in)
    run = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))
    for args in ((src, tgt, mask), (src, tgt)):
        with torch.no_grad():
            got = float(tm(*_t(args)))
        np.testing.assert_allclose(got, float(run(params, *args)), rtol=TOL, atol=TOL)


def test_simple_lstm_matches_jax():
    jm = JL.SimpleLSTM(in_dim=24, hidden=16, out_dim=56)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, L, 24)).astype(np.float32)
    y = rng.standard_normal((2, L, 56)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), x, y)["params"]
    tm = TL.SimpleLSTM(in_dim=24, hidden=16, out_dim=56)
    tm.load_state_dict(jax_simple_lstm_to_state_dict(_tree_np(params)), strict=True)
    jloss, jout = jax.jit(lambda p: jm.apply({"params": p}, x, y))(params)
    with torch.no_grad():
        tloss, tout = tm(*_t((x, y)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL, atol=TOL)


def _jax_equivalent_adamw(tm, dim, lr, wd, frozen=(), eps=1e-8):
    """``make_optimizer``'s AdamW with the positional tables' hyperparameters
    mapped to the JAX package's parametrization (stored ÷ sqrt(dim) there;
    ROADMAP.md queue 3, ``test_torch_slm_train._jax_equivalent_adamw``)."""
    opt = make_optimizer(tm, lr, wd, frozen)
    pos = [p for k, p in tm.named_parameters() if k.endswith("pos_emb.emb.weight")]
    group = opt.param_groups[0]
    group["params"] = [p for p in group["params"] if all(p is not q for q in pos)]
    root = dim ** 0.5
    opt.add_param_group({"params": pos, "lr": lr * root, "weight_decay": wd / root,
                         "eps": eps / root})
    return opt


LR, WD = 1e-3, 0.01


def _lockstep_params(tm, init, final, frozen, signal):
    moved = 0
    for k, p in tm.named_parameters():
        ours, theirs = p.detach(), final[k]
        if k.startswith(frozen):
            assert not p.requires_grad
            assert torch.equal(ours, init[k]) and torch.equal(theirs, init[k]), k
        elif k in signal:
            moved += int(not torch.equal(ours, init[k]))
            assert float((ours - theirs).abs().median()) < 1e-4, k
        else:  # float-noise gradients (the VQ decoder's InstanceNorm directions)
            assert float((ours - theirs).abs().median()) < 5e-3, k
    return moved


def _signal(tm, loss):
    tm.zero_grad()
    loss.backward()
    keys = {k for k, p in tm.named_parameters()
            if p.grad is not None and "_vq." not in k and float(p.grad.square().mean().sqrt())
            > 1e-4}
    tm.zero_grad()
    return keys


def test_lg_train_step_three_adamw_steps_in_lockstep(lg):
    """``make_lg_train_step(use_ids=True)`` beside the JAX package's step
    (value_and_grad, then ``apply_gradients`` of ``create_train_state`` with
    the ``LG_FROZEN`` substrings), AdamW with no clipping as the CLI: losses
    within 1e-5, the frozen VQ parts bitwise unchanged, the signal-bearing
    leaves' median difference below 1e-4."""
    params, sd, (jcfg, jsp, jvq, tcfg, *_) = lg[1]
    jm = _jax_model(lg[1])
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD, clip_norm=0.0,
                               frozen_substrings=FROZEN_J)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jm.apply({"params": p}, *b).loss))
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    tm = _port(lg[1])
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    signal = _signal(tm, tm(*_t(_batch(10))).loss)
    step = TE.make_lg_train_step(tm, _jax_equivalent_adamw(tm, tcfg.dim, LR, WD, TL.LG_FROZEN),
                                 use_ids=True)
    j_losses, t_losses = [], []
    for i in range(3):
        batch = _batch(10 + i, lens=(L, 7 + i))
        jloss, g = vg(state.params, tuple(map(jnp.asarray, batch)))
        state = apply(state, g)
        j_losses.append(float(jloss))
        t_losses.append(float(step(_t(batch))))
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL)
    final = jax_listener_generator_to_state_dict(_tree_np(state.params), *lg[1][2][3:])
    assert _lockstep_params(tm, init, final, TL.LG_FROZEN, signal) > 15


def test_continuous_train_step_three_adamw_steps_in_lockstep():
    jm, params, tm, batch = _continuous_pair(56, seed=5)
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD)
    vg = jax.jit(jax.value_and_grad(lambda p, *b: jm.apply({"params": p}, *b)))
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    signal = _signal(tm, tm(*_t(batch)))
    step = TE.make_continuous_train_step(tm, _jax_equivalent_adamw(tm, 32, LR, WD))
    j_losses, t_losses = [], []
    for _ in range(3):
        jloss, g = vg(state.params, *batch)
        state = apply(state, g)
        j_losses.append(float(jloss))
        t_losses.append(float(step(*_t(batch))))
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL)
    final = jax_continuous_seq2seq_to_state_dict(_tree_np(state.params), _cfgs()[3])
    assert _lockstep_params(tm, init, final, (), signal) > 15
    assert t_losses[-1] < t_losses[0]


def test_evaluate_epoch_matches_jax(lg):
    """Validation loss and token perplexity within 1e-6 relative, with ids."""
    params, jm, tm = lg[2][0], _jax_model(lg[2]), _port(lg[2]).eval()
    batches = [_batch(20), _batch(21, lens=(5, L))]
    ref = JE.evaluate_epoch(params, jm, [tuple(map(jnp.asarray, b)) for b in batches],
                            use_ids=True)
    got = TE.evaluate_epoch(tm, [_t(b) for b in batches], use_ids=True)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k


def test_generation_matches_jax_greedy_and_sampled(lg):
    """``encode_context`` within 1e-5 and its prompt exactly; then
    ``generate_tokens`` greedy, and at temperature 0.7 and filter_frac 0.2
    fed the JAX package's Gumbel noise: token-exact."""
    params, jm, tm = lg[1][0], _jax_model(lg[1]), _port(lg[1]).eval()
    jcfg = lg[1][2][0]
    vs, vl, mask = _batch(30)[:3]
    enc, prompt = jax.jit(lambda p: jm.apply({"params": p}, vs, vl, mask,
                                             method=JL.ListenerGenerator.encode_context))(params)
    with torch.no_grad():
        tenc, tprompt = tm.encode_context(*_t((vs, vl, mask)))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tprompt.numpy(), np.asarray(prompt))
    from dyadic_interaction_modeling_tpu.models.xtrans import TokenDecoder as JTD

    dec = JTD(num_tokens=24, dim=32, max_seq_len=64, depth=1, heads=2)
    dparams = {"params": params["generator"]["decoder"]}
    key = jax.random.PRNGKey(5)
    for kw in (dict(greedy=True), dict(temperature=0.7, filter_frac=0.2)):
        ref = np.asarray(j_generate(dec, dparams, prompt, L - 1, enc, mask, key, **kw))
        noise, rng = [], key
        for _ in range(L - 1):
            rng, sub = jax.random.split(rng)
            noise.append(np.asarray(jax.random.gumbel(sub, (B, jcfg.dec_num_tokens))))
        got = generate_tokens(tm.generator.decoder.net, tprompt, L - 1, tenc,
                              torch.from_numpy(mask), gumbel=torch.from_numpy(np.stack(noise)),
                              **kw)
        np.testing.assert_array_equal(got.numpy(), ref)


TWIN = ["dim", "32", "enc_depth", "1", "enc_heads", "2", "dec_depth", "1", "dec_heads", "2",
        "dec_num_tokens", "24", "enc_max_seq_len", "256", "dec_max_seq_len", "128"]


def test_greedy_test_s2s_twin_matches_jax_loop(tmp_path, monkeypatch):
    """``cli.test_s2s.main --greedy`` on a reference-layout checkpoint against
    the JAX ``test_s2s`` loop driven through its functions
    (``encode_context``, ``generate_tokens`` greedy,
    ``decode_tokens_to_motion``) on the same batches: equal motion within
    1e-4 and every metric but SID within 1e-4 relative (the port's SID
    k-means is the deliberate difference of ROADMAP.md queue 3)."""
    tcfg = TC.merge_cfg_from_list(TC.listener_generator_defaults(), TWIN)
    tvq = TC.lg_vq_cfg(tcfg, synthetic=True)
    jcfg = JC.listener_generator_defaults()
    jcfg.update(dict(tcfg))
    jvq = JC.vq_listener_defaults()
    jvq.update(dict(tvq))
    torch.manual_seed(3)
    sd = TL.ListenerGenerator(tcfg, tvq, tvq, with_ids=False).state_dict()
    path = tmp_path / "lg.pt"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    got = []
    monkeypatch.setattr(test_s2s, "print_metrics",
                        lambda *a: got.append((a, print_metrics(*a, verbose=False))))
    assert test_s2s.main(["--synthetic", "--device", "cpu", "--greedy", "--batch-size", "8",
                          "--checkpoint", str(path), *TWIN]) == 0
    (y_true, y_pred, xs), ours = got[0]

    jm = JL.ListenerGenerator(jcfg, jvq, jvq)
    batches = list(train_s2s.lg_batches(
        test_s2s.make_loaders(test_s2s.get_parser().parse_args(["--synthetic"]), 8)[1], "cpu"))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *(b.numpy() for b in batches[0][:3]))["params"]
    params = torch_listener_generator_to_flax(
        {k: v.numpy() for k, v in sd.items()}, jcfg, jvq, jvq,
        params_template=jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                               shapes))["params"]
    from dyadic_interaction_modeling_tpu.models.xtrans import TokenDecoder as JTD

    dec = JTD(num_tokens=24, dim=32, max_seq_len=128, depth=1, heads=2)
    @jax.jit
    def jax_loop(params, src, tgt, mask):
        enc, prompt = jm.apply({"params": params}, src, tgt, mask,
                               method=JL.ListenerGenerator.encode_context)
        toks = j_generate(dec, {"params": params["generator"]["decoder"]}, prompt,
                          src.shape[1] - 1, enc, mask, jax.random.PRNGKey(1), greedy=True)
        return jm.apply({"params": params}, toks,
                        method=JL.ListenerGenerator.decode_tokens_to_motion)

    want = []
    for src, tgt, mask, *_ in batches:
        motion = np.asarray(jax_loop(params, src.numpy(), tgt.numpy(), mask.numpy()))
        for j, lj in enumerate(mask.sum(1)):
            want.append(motion[j, : lj - 1])
    assert len(want) == len(y_pred) == 8
    for a, b in zip(y_pred, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    ref = print_metrics(y_true, want, xs, verbose=False)
    for k in ref:
        if not k.startswith("sid"):
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, equal_nan=True, err_msg=k)


def test_lm_listener_dataset_matches_jax(tmp_path):
    """One file that hits every rule: a split whose start equals its end, a
    mismatched listener, a clip under 24 frames, audio-less segments, HuBERT
    features at another rate, and clips cut into chunks (32 frames here)."""
    specs = [dict(length=40, hubert_frames=20), dict(length=30, split=(1.0, 1.0),
                                                     hubert_frames=30),
             dict(length=30, listener_length=29), dict(length=20), dict(length=70),
             dict(length=100, hubert_frames=50), dict(length=32, hubert_frames=32)]
    write_lm_listener(str(tmp_path), specs, mode="val", seed=4)
    ours = LmListenerDataset(str(tmp_path), "val", chunk=32)
    ref = JLmListener(str(tmp_path), "val", chunk=32)
    assert len(ours) == len(ref) == 1 + 2 + 3 + 1
    for i in range(len(ref)):
        (a, b, n), (c, d, m) = ours[i], ref[i]
        assert n == m and a.shape[1] == 56 + 768
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_test_l2l_prints_jax_numbers(tmp_path):
    """The same printed battery as the JAX CLI on one predictions pickle of
    clustered motion (where both SID k-means agree)."""
    from dyadic_interaction_modeling_tpu.cli import test_l2l as j_test_l2l

    rng = np.random.default_rng(8)
    gt = np.split(_clustered_motion(rng, 180, noise=1.0), 3)
    pred = np.split(_clustered_motion(rng, 180, noise=1.0), 3)
    x = [rng.standard_normal((60, 56)) for _ in range(3)]
    path = tmp_path / "pred.pkl"
    with open(path, "wb") as f:
        pickle.dump({"y_true": gt, "y_pred": pred, "x": x}, f)
    outs = []
    for main in (test_l2l.main, j_test_l2l.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--predictions", str(path)])
        outs.append([ln for ln in buf.getvalue().splitlines() if ":" in ln
                     and not ln.startswith("scoring")])
    assert len(outs[0]) > 15 and len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        ka, va = a.split(":", 1)
        kb, vb = b.split(":", 1)
        assert ka == kb
        np.testing.assert_allclose([float(v) for v in va.split()],
                                   [float(v) for v in vb.split()], rtol=1e-9, err_msg=ka)


def test_train_s2s_twin_both_branches_on_cpu(tmp_path, capsys, no_tensorboard):
    """One epoch of each branch on synthetic clips; the token branch's best
    state_dict loads strictly into a ``with_ids`` model; both write the run
    record (the continuous branch: ``val/loss`` and ``learning_rate``)."""
    assert train_s2s.main(["--synthetic", "--device", "cpu", "--use-ids", "--save-path",
                           str(tmp_path / "lg"), *TWIN, "epochs", "1"]) == 0
    assert train_s2s.main(["--synthetic", "--device", "cpu", "--continuous", "--save-path",
                           str(tmp_path / "cont"), *TWIN, "epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "perplexity" in out and "val MSE" in out
    assert_run_record(tmp_path / "lg", "train_s2s")
    assert_run_record(tmp_path / "cont", "train_s2s --continuous")
    cfg = TC.merge_cfg_from_list(TC.listener_generator_defaults(), TWIN)
    vq = TC.lg_vq_cfg(cfg, True)
    TL.ListenerGenerator(cfg, vq, vq).load_state_dict(
        torch.load(tmp_path / "lg" / "best_model.pt", weights_only=True), strict=True)
    assert train_s2s.get_parser().parse_args([]).device == "cuda"
