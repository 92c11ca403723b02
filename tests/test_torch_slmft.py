"""The torch port's SLMFT best-of-N slice against the JAX package's, end to
end at a few layers and narrow widths: weights through
``jax_slm_to_state_dict`` (strict load), ``encode_context``, the best-of-N
generator (greedy and shared-noise sampled), FD selection, the metric
battery, and the CLI twin."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.cli.common import vq_cfg_for as j_vq_cfg_for
from dyadic_interaction_modeling_tpu.engine import pt_engine as JE
from dyadic_interaction_modeling_tpu.metrics.reporting import print_metrics as j_print_metrics
from dyadic_interaction_modeling_tpu.models.slm import SLMFT as JSLMFT
from dyadic_interaction_modeling_tpu.models.xtrans import TokenDecoder as JTD
from dyadic_interaction_modeling_tpu.models.xtrans import generate_tokens as j_generate
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.engine import pt_engine as TE
from dyadic_interaction_modeling_tpu_torch.metrics.reporting import print_metrics
from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_slm_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(dim=32, dim_audio=16, enc_depth=1, dec_depth=2, enc_heads=2,
             dec_heads=2, num_tokens=64, enc_max_seq_len=64, dec_max_seq_len=64)
B0, N, L = 3, 2, 12


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = JC.slm_defaults()
    jcfg.update(SMALL)
    jvq = j_vq_cfg_for(jcfg, True)
    tcfg = TC.slm_defaults()
    tcfg.update(SMALL)
    tvq = TC.vq_cfg_for(tcfg, True)
    assert dict(jvq) == dict(tvq)
    rng = np.random.default_rng(0)
    vs = rng.standard_normal((B0, L, 56)).astype(np.float32)
    vl = rng.standard_normal((B0, L, 56)).astype(np.float32)
    va = rng.standard_normal((B0, L, 16)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([12, 9, 5])[:, None]
    jm = JSLMFT(jcfg, jvq)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), vs, vl, va, mask,
                              jax.random.PRNGKey(2))["params"]
    tm = SLMFT(tcfg, tvq)
    tm.load_state_dict(jax_slm_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), tcfg, tvq), strict=True)
    batch = (vs, vl, va, mask)
    return jm, params, jcfg, tm.eval(), tcfg, batch


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def test_encode_context_matches(slice_pair):
    jm, params, _, tm, _, batch = slice_pair
    ctx, prompt = jax.jit(lambda p, b: jm.apply({"params": p}, *b,
                                                method=JSLMFT.encode_context))(params, batch)
    with torch.no_grad():
        tctx, tprompt = tm.encode_context(*_t(batch))
    np.testing.assert_allclose(tctx.numpy(), np.asarray(ctx), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tprompt.numpy(), np.asarray(prompt))
    z_s, z_l = jax.jit(lambda p, b: jm.apply({"params": p}, *b, method=JSLMFT.forward_vq))(
        params, (batch[0], batch[1], batch[3]))
    tz_s, tz_l = tm.forward_vq(*_t((batch[0], batch[1], batch[3])))
    np.testing.assert_array_equal(tz_s.numpy(), np.asarray(z_s))
    np.testing.assert_array_equal(tz_l.numpy(), np.asarray(z_l))


def _jax_greedy_best_of_n(jm, params, jcfg, batch):
    """The JAX make_slmft_generator's computation, greedy."""
    dec = JTD(num_tokens=jcfg.num_tokens, dim=jcfg.dim + jcfg.dim_audio,
              max_seq_len=jcfg.dec_max_seq_len, depth=jcfg.dec_depth,
              heads=jcfg.dec_heads, use_abs_pos_emb=False)

    @jax.jit
    def run(params, batch):
        ctx, prompt = jm.apply({"params": params}, *batch,
                               method=JSLMFT.encode_context)
        toks = j_generate(dec, {"params": params["decoder_joint"]},
                          jnp.tile(prompt, (N, 1)), L - 1, ctx, batch[3],
                          jax.random.PRNGKey(0), greedy=True, context_groups=N)
        return toks, jm.apply({"params": params}, toks,
                              method=JSLMFT.decode_tokens_to_motion)

    toks, motion = run(params, tuple(jnp.asarray(x) for x in batch))
    return (np.asarray(toks),
            np.asarray(motion).reshape(N, B0, L - 1, -1).transpose(1, 0, 2, 3))


def test_greedy_best_of_n_candidates_match(slice_pair):
    jm, params, jcfg, tm, tcfg, batch = slice_pair
    ref_toks, ref = _jax_greedy_best_of_n(jm, params, jcfg, batch)
    gen = TE.make_slmft_generator(tm)
    cands, toks = gen(_t(batch), None, N, greedy=True, return_tokens=True)
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    assert cands.shape == (B0, N, L - 1, 56)
    np.testing.assert_allclose(cands.numpy(), ref, atol=1e-3, rtol=1e-3)


def test_sampled_generator_matches_jax_generator_under_shared_noise(slice_pair):
    """The JAX package's own make_slmft_generator (no chunking below 32
    rows) against the port's generator fed the same Gumbel noise."""
    jm, params, jcfg, tm, tcfg, batch = slice_pair
    key = jax.random.PRNGKey(5)
    ref = np.asarray(JE.make_slmft_generator(jm, jcfg, L)(
        params, tuple(jnp.asarray(x) for x in batch), key, N))
    noise, rng = [], key
    for _ in range(L - 1):
        rng, sub = jax.random.split(rng)
        noise.append(np.asarray(jax.random.gumbel(sub, (N * B0, jcfg.num_tokens))))
    gen = TE.make_slmft_generator(tm)
    out = gen(_t(batch), None, N, gumbel=torch.from_numpy(np.stack(noise)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3, rtol=1e-3)


def _clustered_motion(rng, n_rows, pose_p=None, exp_p=None, noise=0.1):
    """(n_rows, 56) motion rows in clear clusters: pose (dims 0:6) about 20
    corners of a cube of side 100, expression (dims 6:56) about 100 * e_c for 40
    unit vectors e_c. A row takes cluster r % k, or one drawn from ``*_p``.
    Both k-means implementations find these partitions, so SID must agree."""
    corners = (np.arange(64)[:, None] >> np.arange(6)) & 1
    pose_c = 100.0 * corners[rng.permutation(64)[:20]]
    exp_c = 100.0 * np.eye(50)[:40]
    r = np.arange(n_rows)
    pi = r % 20 if pose_p is None else rng.choice(20, n_rows, p=pose_p)
    ei = r % 40 if exp_p is None else rng.choice(40, n_rows, p=exp_p)
    rows = np.concatenate([pose_c[pi], exp_c[ei]], axis=1)
    return rows + noise * rng.standard_normal(rows.shape)


def test_fd_selection_and_metric_battery_match(slice_pair):
    rng = np.random.default_rng(4)
    cands = rng.standard_normal((5, 40, 56)).astype(np.float32)
    target = rng.standard_normal((40, 56)).astype(np.float32)
    np.testing.assert_array_equal(TE.select_best_by_fd(cands, target),
                                  JE.select_best_by_fd(cands, target))
    np.testing.assert_array_equal(TE.select_best_by_l2(cands, target),
                                  JE.select_best_by_l2(cands, target))
    skew20, skew40 = np.arange(1, 21) ** 2.0, np.arange(1, 41) * 1.0
    # unit noise keeps each clip's covariance well conditioned for the FD
    gt = np.split(_clustered_motion(rng, 180, noise=1.0), 3)
    pred = np.split(_clustered_motion(rng, 180, skew20 / skew20.sum(),
                                      skew40 / skew40.sum(), noise=1.0), 3)
    x = [rng.standard_normal((60, 56)) for _ in range(3)]
    ours, ref = print_metrics(gt, pred, x, verbose=False), j_print_metrics(
        gt, pred, x, verbose=False)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-12), k


@pytest.mark.parametrize("kind", ["pose", "exp"])
def test_sid_matches_jax_on_clear_clusters(kind):
    from dyadic_interaction_modeling_tpu.metrics.eval_utils import calcuate_sid as j_sid
    from dyadic_interaction_modeling_tpu_torch.metrics.eval_utils import calcuate_sid

    rng = np.random.default_rng(7)
    p20, p40 = rng.dirichlet(np.ones(20)), rng.dirichlet(np.ones(40))
    gt = np.split(_clustered_motion(rng, 240), 4)
    pred = [_clustered_motion(rng, 50, p20, p40) for _ in range(4)]
    for a, b in ((gt, pred), (gt, gt)):
        ours, ref = calcuate_sid(a, b, type=kind), j_sid(a, b, type=kind)
        assert 0.5 < ref and ours == pytest.approx(ref, rel=1e-12, abs=1e-12)


def test_evaluate_test_epoch_on_cpu(slice_pair):
    _, _, _, tm, tcfg, batch = slice_pair
    gen = TE.make_slmft_generator(tm)
    y_true, y_pred, xs, ids = TE.evaluate_test_epoch(
        tm, gen, [batch + (["a", "b", "c"],)], torch.Generator().manual_seed(0),
        beam_size=N, device="cpu")
    assert [len(y) for y in y_pred] == [11, 8, 4] and ids == ["a", "b", "c"]
    assert all(np.isfinite(y).all() for y in y_pred)
    np.testing.assert_array_equal(y_true[1], batch[1][1, 1:9])


def test_cli_twin_synthetic_on_cpu(tmp_path):
    out = tmp_path / "pred.pkl"
    # one thread: the model is tiny, and in a parallel test run more threads
    # only wait on each other at every operator's barrier
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "dyadic_interaction_modeling_tpu_torch.cli.test_s2s_pretrain",
         "--synthetic", "--device", "cpu", "--beam-size", "2", "--out", str(out),
         "dim", "32", "enc_depth", "1", "dec_depth", "1", "enc_heads", "2",
         "dec_heads", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fid_pose" in proc.stdout and out.exists()
