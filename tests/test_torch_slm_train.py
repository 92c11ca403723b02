"""The torch port's SLM pretraining slice against the JAX package's, at a few
layers and narrow widths: weights through ``jax_slm_to_state_dict`` (strict
load), ``SLM.forward`` fed JAX's masking noise (total loss and the six logs
within 1e-4), step-0 gradients against ``jax.grad``, the masking and the
cross-entropy, and three AdamW + clip steps in lockstep with
``create_train_state(..., SLM_FROZEN_SUBSTRINGS)``: with the positional
tables' hyperparameters mapped to the JAX package's parametrization, and
with the port's own optimizer, where only those tables differ.

The JAX params come from a seeded port model through the JAX package's own
importer (``torch_slm_to_flax`` on an ``eval_shape`` template), so no JAX
init is compiled; the port's bridge must give that state_dict back exactly.
One jitted ``value_and_grad`` serves the forward, gradient and lockstep
tests.

Global-norm clip: the port scales by ``max_norm / norm`` exactly as optax
does (torch's ``clip_grad_norm_`` would divide by ``norm + 1e-6``, a 1e-6
relative difference), so the lockstep tolerance (losses rtol 2e-3) only
covers the order of sums and the Adam updates of near-zero gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.cli.common import vq_cfg_for as j_vq_cfg_for
from dyadic_interaction_modeling_tpu.engine.train_state import create_train_state
from dyadic_interaction_modeling_tpu.models import slm as JS
from dyadic_interaction_modeling_tpu.utils.torch_import import torch_slm_to_flax
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
from dyadic_interaction_modeling_tpu_torch.models import slm as TS
from dyadic_interaction_modeling_tpu_torch.models import xtrans as TX
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_slm_to_state_dict

SMALL = dict(dim=32, dim_audio=16, enc_depth=1, dec_depth=2, enc_heads=2,
             dec_heads=2, num_tokens=64, enc_max_seq_len=64, dec_max_seq_len=64)
B, L = 3, 16
LENS = (16, 11, 7)
TOL = 1e-4
LOSSES = ("l_ce_s", "l_ce_l", "l_cont_s", "l_cont_l", "nce")


def _batch(seed):
    rng = np.random.default_rng(seed)
    vs = rng.standard_normal((B, L, 56)).astype(np.float32)
    vl = rng.standard_normal((B, L, 56)).astype(np.float32)
    va = rng.standard_normal((B, L, 16)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array(LENS)[:, None]
    return vs, vl, va, mask


def _noise(key):
    """The masking noise SLM.__call__ draws from ``key``: rng splits of
    ``slm.py:263`` then ``:201``."""
    _, r_enc = jax.random.split(key)
    r1, r2 = jax.random.split(r_enc)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(r, (B, L))))
                 for r in (r1, r2))


def _t(batch):
    return tuple(torch.from_numpy(np.array(x)) for x in batch)


def _j(batch):
    return tuple(map(jnp.asarray, batch))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.slm_defaults()
    jcfg.update(SMALL)
    jvq = j_vq_cfg_for(jcfg, True)
    tcfg = TC.slm_defaults()
    tcfg.update(SMALL)
    tvq = TC.vq_cfg_for(tcfg, True)
    jm = JS.SLM(jcfg, jvq)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1), *_batch(0),
                            jax.random.PRNGKey(2))["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in TS.SLM(tcfg, tvq).state_dict().items()}
    params = torch_slm_to_flax(sd, jcfg, jvq, variant="slm",
                               params_template=template)["params"]
    back = jax_slm_to_state_dict(params, tcfg, tvq)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k], rtol=1e-6, atol=1e-7, err_msg=k)

    def torch_model():
        tm = TS.SLM(tcfg, tvq)
        tm.load_state_dict(back, strict=True)
        return tm

    def loss(p, batch, key):
        out = jm.apply({"params": p}, *batch, key)
        return out.total_loss, out.logs

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return jm, params, tcfg, tvq, torch_model, vg


@pytest.fixture(scope="module")
def jax_ref(pair):
    """JAX's total loss, logs and gradients (as port state_dict keys) at one
    batch and key."""
    _, params, tcfg, tvq, _, vg = pair
    key = jax.random.PRNGKey(3)
    (total, logs), g = vg(params, _j(_batch(0)), key)
    grads = jax_slm_to_state_dict(_tree_np(g), tcfg, tvq)
    return key, float(total), {k: float(v) for k, v in logs.items()}, grads


def test_forward_matches_jax(pair, jax_ref):
    torch_model = pair[4]
    key, total, logs, _ = jax_ref
    with torch.no_grad():
        out = torch_model()(*_t(_batch(0)), noise=_noise(key))
    assert set(out.logs) == set(logs) and len(logs) == 6
    np.testing.assert_allclose(float(out.total_loss), total, rtol=TOL, atol=TOL)
    for k in logs:
        np.testing.assert_allclose(float(out.logs[k]), logs[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_masking_matches_jax():
    valid = np.arange(20)[None, :] < np.array([20, 13, 1, 7])[:, None]
    key = jax.random.PRNGKey(9)
    ref = JS.random_masking_unstructured(key, jnp.asarray(valid), 0.15)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, valid.shape)))
    out = TS.random_masking_unstructured(noise, torch.from_numpy(valid), 0.15)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cross_entropy_with_nothing_to_predict_is_zero():
    logits = torch.randn(2, 5, 7)
    targets = torch.full((2, 5), -100)
    assert float(TX.ar_cross_entropy(logits, targets)) == 0.0
    targets[1, 2] = 3
    ref = -torch.log_softmax(logits[1, 2], -1)[3]
    torch.testing.assert_close(TX.ar_cross_entropy(logits, targets), ref)


def _torch_grads(tm, batch, noise):
    tm.zero_grad()
    tm(*_t(batch), noise=noise).total_loss.backward()
    return {k: p.grad.clone() for k, p in tm.named_parameters() if p.grad is not None}


def _signal(grads):
    """Trainable leaves outside the VQs whose step-0 gradient RMS is above
    1e-3. The VQ decoders train through InstanceNorm directions that are
    mathematically dead, so their gradients are float noise."""
    return [k for k, g in grads.items()
            if "_vq." not in k and float(g.square().mean().sqrt()) > 1e-3]


def test_step0_gradients_match_jax(pair, jax_ref):
    """Every self-attention here goes through ``flash_attention`` (its plain
    version on the CPU, the kernels on the card), every cross-attention
    through the matmul route."""
    tcfg, torch_model = pair[2], pair[4]
    key, _, _, ref = jax_ref
    ours = _torch_grads(torch_model(), _batch(0), _noise(key))
    keys = _signal(ours)
    assert len(keys) > 40, len(keys)
    for k in keys:
        want = ref[k].numpy()
        if k.endswith("pos_emb.emb.weight"):  # stored times dim ** 0.5
            want = want / (tcfg.dim + (tcfg.dim_audio if "decoder" in k else 0))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(ours[k].numpy(), want, rtol=0, atol=1e-3 * scale,
                                   err_msg=k)


def _jax_equivalent_adamw(tm, tcfg, lr, wd, eps=1e-8, frozen=TS.SLM_FROZEN):
    """``make_optimizer``'s AdamW, with the positional tables' hyperparameters
    mapped to the JAX package's parametrization. The port stores them as
    the reference does, times sqrt(dim) and read times dim ** -0.5, so Adam
    (invariant to the scale of a gradient, not of a parameter) moves their
    forward values sqrt(dim) times less per step than the JAX package, which
    stores the forward values (ROADMAP.md queue 3). lr * sqrt(dim),
    wd / sqrt(dim) and eps / sqrt(dim) give the JAX package's update.
    ``frozen``: the model's frozen module prefixes (SLM's by default)."""
    opt = make_optimizer(tm, lr, wd, frozen)
    pos = {k: p for k, p in tm.named_parameters() if k.endswith("pos_emb.emb.weight")}
    group = opt.param_groups[0]
    group["params"] = [p for p in group["params"] if all(p is not q for q in pos.values())]
    for k, p in pos.items():
        root = (tcfg.dim + (tcfg.dim_audio if k.startswith("decoder") else 0)) ** 0.5
        opt.add_param_group({"params": [p], "lr": lr * root, "weight_decay": wd / root,
                             "eps": eps / root})
    return opt


LR, WD, CLIP = 1e-3, 0.01, 1.0


def _lockstep(pair, make_opt):
    """Three steps of the JAX package's train step (``make_slm_train_step`` is
    value_and_grad of the loss, then ``apply_gradients``), on the same
    compiled loss as the tests above, beside three of the port's with the
    optimizer ``make_opt(model)``. Returns (torch losses, JAX losses, the
    port's model, its initial state_dict, the JAX package's final params as
    port keys, the signal-bearing leaves)."""
    jm, params, tcfg, tvq, torch_model, vg = pair
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD,
                               clip_norm=CLIP, frozen_substrings=JS.SLM_FROZEN_SUBSTRINGS)
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    tm = torch_model()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    signal = _signal(_torch_grads(tm, _batch(10), _noise(jax.random.PRNGKey(10))))
    tstep = make_slm_train_step(tm, make_opt(tm), CLIP)
    j_losses, t_losses = [], []
    for i in range(3):
        batch, key = _batch(10 + i), jax.random.PRNGKey(10 + i)
        (_, jlogs), g = vg(state.params, _j(batch), key)
        state = apply(state, g)
        tlogs = tstep(_t(batch), noise=_noise(key))
        j_losses.append(sum(float(jlogs[k]) for k in LOSSES))
        t_losses.append(sum(float(tlogs[k]) for k in LOSSES))
    final = jax_slm_to_state_dict(_tree_np(state.params), tcfg, tvq)
    return t_losses, j_losses, tm, init, final, signal


def test_three_adamw_clip_steps_in_lockstep(pair):
    tcfg = pair[2]
    t_losses, j_losses, tm, init, final, signal = _lockstep(
        pair, lambda tm: _jax_equivalent_adamw(tm, tcfg, LR, WD))
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3)
    trainable = {k for k, p in tm.named_parameters() if p.requires_grad}
    compared = 0
    for k, p in tm.named_parameters():
        ours, theirs = p.detach(), final[k]
        if k.startswith(TS.SLM_FROZEN):
            assert k not in trainable
            assert torch.equal(ours, init[k]) and torch.equal(theirs, init[k]), k
        elif "_vq." in k:  # trainable VQ decoders: a bounded drift
            assert float((ours - theirs).abs().median()) < 5e-3, k
        elif k in signal:
            compared += 1
            assert float((ours - theirs).abs().median()) < 1e-4, k
    assert compared > 40, compared


def test_port_optimizer_differs_from_jax_only_in_positional_tables(pair):
    """The port's own ``make_optimizer``, as ``train_s2s_pretrain`` uses it:
    every signal-bearing leaf but the positional tables stays in lockstep,
    and each table's 3-step change is the JAX package's divided by
    sqrt(dim), the parametrization difference of ROADMAP.md queue 3."""
    tcfg = pair[2]
    t_losses, j_losses, tm, init, final, signal = _lockstep(
        pair, lambda tm: make_optimizer(tm, LR, WD, TS.SLM_FROZEN))
    # the first loss is taken before any update; the later ones move apart
    # with the tables
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=TOL)
    compared, tables = 0, 0
    for k, p in tm.named_parameters():
        ours, theirs = p.detach(), final[k]
        if k.endswith("pos_emb.emb.weight"):
            tables += 1
            root = (tcfg.dim + (tcfg.dim_audio if k.startswith("decoder") else 0)) ** 0.5
            d_ours, d_theirs = ours - init[k], theirs - init[k]
            scale = float(d_theirs.abs().max())
            assert float((d_ours - d_theirs).abs().max()) > 0.5 * scale, k
            # elementwise up to the few entries whose Adam direction flips
            # between the two trajectories
            off = (root * d_ours - d_theirs).abs()
            ratio = float((root * d_ours).norm() / d_theirs.norm())
            assert float(off.median()) < 1e-3 * scale and abs(ratio - 1) < 0.01, k
        elif k in signal:
            compared += 1
            assert float((ours - theirs).abs().median()) < 1e-4, k
    assert tables == 4 and compared > 40, (tables, compared)
