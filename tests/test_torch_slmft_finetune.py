"""The torch port's SLMFT listener finetune against the JAX package's, at a
small width (dim 32, 2 + 2 encoder and 2 decoder layers, 4 heads, 32
codes): the input corruption of ``ar_mask_prob_kv_mask`` fed the JAX
package's ``jax.random.normal`` draw, ``SLMFT.forward`` (loss, logs,
logits, teacher-forced motion), three AdamW + clip steps with
``SLMFT_FROZEN`` in lockstep, ``evaluate_finetune_epoch``, the SLM -> SLMFT
``partial_load`` and the ``finetune_s2s_pretrain`` CLI twin.

The JAX params come from a seeded port model through the JAX package's own
importer (``torch_slm_to_flax`` on an ``eval_shape`` template), so no JAX
init is compiled, and the port's bridge must give that state_dict back
exactly. The decoder's causal self-attention with the corruption's key
mask goes through ``flash_attention`` (its plain version on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.cli.common import vq_cfg_for as j_vq_cfg_for
from dyadic_interaction_modeling_tpu.engine import pt_engine as JE
from dyadic_interaction_modeling_tpu.engine.train_state import create_train_state
from dyadic_interaction_modeling_tpu.models import slm as JS
from dyadic_interaction_modeling_tpu.models import xtrans as JX
from dyadic_interaction_modeling_tpu.utils.torch_import import torch_slm_to_flax
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import finetune_s2s_pretrain as cli
from dyadic_interaction_modeling_tpu_torch.engine import pt_engine as TE
from dyadic_interaction_modeling_tpu_torch.models import slm as TS
from dyadic_interaction_modeling_tpu_torch.models import xtrans as TX
from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder
from dyadic_interaction_modeling_tpu_torch.utils.checkpoint import partial_load
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_slm_to_state_dict
from test_torch_slm_train import _jax_equivalent_adamw
from tests.test_torch_observability import assert_run_record, no_tensorboard  # noqa: F401

SMALL = dict(dim=32, dim_audio=16, enc_depth=2, dec_depth=2, enc_heads=4, dec_heads=4,
             num_tokens=32, enc_max_seq_len=64, dec_max_seq_len=64)
B, L = 3, 20
LENS = (20, 14, 9)
TOL = 1e-5
LR, WD, CLIP = 1e-3, 0.01, 1.0


def _cfgs():
    jcfg, tcfg = JC.slm_defaults(), TC.slm_defaults()
    jcfg.update(SMALL)
    tcfg.update(SMALL)
    return jcfg, j_vq_cfg_for(jcfg, True), tcfg, TC.vq_cfg_for(tcfg, True)


def _batch(seed, lens=LENS):
    rng = np.random.default_rng(seed)
    vs = rng.standard_normal((B, L, 56)).astype(np.float32)
    vl = rng.standard_normal((B, L, 56)).astype(np.float32)
    va = rng.standard_normal((B, L, 16)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array(lens)[:, None]
    return vs, vl, va, mask


def _noise(key, b=B, seq=L - 1):
    """The corruption noise SLMFT.__call__ draws from ``key``
    (``ar_mask_prob_kv_mask``, xtrans.py:656)."""
    return torch.from_numpy(np.array(jax.random.normal(key, (b, seq))))


def _t(batch):
    return tuple(torch.from_numpy(np.array(x)) for x in batch)


def _j(batch):
    return tuple(map(jnp.asarray, batch))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg, jvq, tcfg, tvq = _cfgs()
    jm = JS.SLMFT(jcfg, jvq)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1), *_batch(0),
                            jax.random.PRNGKey(2))["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in TS.SLMFT(tcfg, tvq).state_dict().items()}
    params = torch_slm_to_flax(sd, jcfg, jvq, variant="slmft",
                               params_template=template)["params"]
    back = jax_slm_to_state_dict(params, tcfg, tvq)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_allclose(back[k].numpy(), sd[k], rtol=1e-6, atol=1e-7, err_msg=k)

    def torch_model():
        tm = TS.SLMFT(tcfg, tvq)
        tm.load_state_dict(back, strict=True)
        return tm

    def loss(p, batch, key):
        out = jm.apply({"params": p}, *batch, key)
        return out.total_loss, out.logs

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return jm, params, tcfg, torch_model, vg


@pytest.mark.parametrize("b,seq,seed", [(3, 19, 0), (4, 255, 1), (2, 7, 2), (5, 6, 3)])
def test_ar_mask_prob_kv_mask_exact(b, seq, seed):
    """The same positions as the JAX package's under its own noise:
    floor(0.15 seq) a row (none below 7), never position 0."""
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(JX.ar_mask_prob_kv_mask(key, b, seq, 0.15))
    out = TX.ar_mask_prob_kv_mask(b, seq, 0.15, _noise(key, b, seq))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (~out).sum(1).tolist() == [int(seq * 0.15)] * b and bool(out[:, 0].all())
    drawn = TX.ar_mask_prob_kv_mask(b, seq, 0.15, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (b, seq) and (~drawn).sum(1).tolist() == [int(seq * 0.15)] * b


def test_forward_matches_jax(pair):
    """Loss, the six logs, the logits and the teacher-forced motion within
    1e-5 under the same corruption."""
    jm, params, _, torch_model, vg = pair
    key = jax.random.PRNGKey(3)
    batch = _batch(1)
    out = jax.jit(lambda p, b, k: jm.apply({"params": p}, *b, k))(params, _j(batch), key)

    def logits_fn(m, vs, vl, va, mask, rng):
        return m.decode_train(m.forward_encoder(vs, mask), m.forward_vq(vs, vl, mask)[1],
                              va, mask, rng)[1]

    jlogits = jax.jit(lambda p, b, k: jm.apply({"params": p}, *b, k, method=logits_fn))(
        params, _j(batch), key)
    tm = torch_model()
    vs, vl, va, mask = _t(batch)
    with torch.no_grad():
        tout = tm(vs, vl, va, mask, noise=_noise(key))
        z_l = tm.forward_vq(vs, vl, mask)[1]
        tlogits = tm.decode_train(tm.forward_encoder(vs, mask), z_l, va, mask, _noise(key))[1]
    np.testing.assert_allclose(float(tout.total_loss), float(out.total_loss), atol=TOL,
                               rtol=TOL)
    assert set(tout.logs) == set(out.logs) and len(out.logs) == 6
    for k in out.logs:
        np.testing.assert_allclose(float(tout.logs[k]), float(out.logs[k]), atol=TOL,
                                   rtol=TOL, err_msg=k)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tout.pred.numpy(), np.asarray(out.pred), atol=TOL, rtol=TOL)


def test_three_adamw_clip_steps_in_lockstep(pair):
    """The JAX package's step (value_and_grad, then clip 1.0 and AdamW
    under the SLMFT_FROZEN_SUBSTRINGS mask) beside the port's
    ``make_slm_train_step`` with ``SLMFT_FROZEN``, the positional tables'
    hyperparameters mapped to the JAX package's parametrization
    (``_jax_equivalent_adamw``): losses within 1e-5,
    both VQs bitwise unchanged, every other parameter's median difference
    below 1e-4."""
    jm, params, tcfg, torch_model, vg = pair
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD, clip_norm=CLIP,
                               frozen_substrings=JS.SLMFT_FROZEN_SUBSTRINGS)
    apply = jax.jit(lambda s, g: s.apply_gradients(grads=g))
    tm = torch_model()
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = _jax_equivalent_adamw(tm, tcfg, LR, WD, frozen=TS.SLMFT_FROZEN)
    tstep = TE.make_slm_train_step(tm, opt, CLIP)
    j_losses, t_losses = [], []
    for i in range(3):
        batch, key = _batch(10 + i), jax.random.PRNGKey(10 + i)
        (jtotal, _), g = vg(state.params, _j(batch), key)
        state = apply(state, g)
        tlogs = tstep(_t(batch), noise=_noise(key))
        j_losses.append(float(jtotal))
        t_losses.append(float(tlogs["l_ce_l"] + tlogs["l_cont_l"]))
    np.testing.assert_allclose(t_losses, j_losses, rtol=TOL)
    final = jax_slm_to_state_dict(_tree_np(state.params), tcfg, _cfgs()[3])
    moved = 0
    for k, p in tm.named_parameters():
        ours, theirs = p.detach(), final[k]
        if k.startswith(TS.SLMFT_FROZEN):
            assert not p.requires_grad
            assert torch.equal(ours, init[k]) and torch.equal(theirs, init[k]), k
        else:
            moved += int(not torch.equal(ours, init[k]))
            assert float((ours - theirs).abs().median()) < 1e-4, k
    assert moved > 30, moved


def test_evaluate_finetune_epoch_matches_jax(pair):
    """Teacher-forced predictions of two batches under the JAX package's
    per-batch rng splits (its corruption noise fed to the port)."""
    jm, params, _, torch_model, _ = pair
    batches = [_batch(20), _batch(21, lens=(20, 20, 5))]
    rng = jax.random.PRNGKey(7)
    jout = JE.evaluate_finetune_epoch(params, jm, [_j(b) for b in batches], rng)
    noises = []
    for _ in batches:
        rng, sub = jax.random.split(rng)
        noises.append(_noise(sub))
    tout = TE.evaluate_finetune_epoch(torch_model().eval(), [_t(b) for b in batches],
                                      noises=noises)
    for jl, tl in zip(jout, tout):
        assert len(jl) == len(tl) == 2 * B
    for name, jl, tl in zip(("y_true", "y_pred", "x"), jout[:3], tout[:3]):
        for a, b in zip(tl, jl):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=name)


def _slm_state(tcfg, tvq, seed):
    torch.manual_seed(seed)
    return TS.SLM(tcfg, tvq).state_dict()


def test_partial_load_grafts_an_slm_into_slmft():
    """Strict after the named drops: every SLMFT tensor comes from the SLM,
    exactly the SLM-only keys are dropped, and a key SLMFT has no place
    for, or a module held only in part, raises ValueError."""
    _, _, tcfg, tvq = _cfgs()
    slm = _slm_state(tcfg, tvq, seed=1)
    torch.manual_seed(2)
    ft = TS.SLMFT(tcfg, tvq)
    dropped = partial_load(ft, slm, TS.SLM_ONLY)
    own = ft.state_dict()
    assert sorted(dropped) == sorted(k for k in slm if k not in own)
    assert dropped and all(k.startswith(TS.SLM_ONLY) for k in dropped)
    assert all(torch.equal(v, slm[k]) for k, v in own.items())
    with pytest.raises(ValueError, match="no place"):
        partial_load(ft, {**slm, "encoder_x.weight": torch.zeros(1)}, TS.SLM_ONLY)
    with pytest.raises(ValueError, match="no place"):
        partial_load(ft, slm)  # the SLM-only keys are not dropped by themselves
    part = {k: v for k, v in slm.items() if k != "encoder_s.project_in.bias"}
    with pytest.raises(ValueError, match="only in part"):
        partial_load(ft, part, TS.SLM_ONLY)


TINY = ["dim", "32", "enc_depth", "1", "dec_depth", "1", "enc_heads", "2", "dec_heads", "2",
        "epochs", "1"]


def test_finetune_cli_twin_on_cpu(tmp_path, capsys, no_tensorboard):
    """One epoch on synthetic ViCo clips from an SLM state_dict and two VQ
    state_dicts as the other twins save them; the FD battery runs and the
    best state_dict loads strictly into SLMFT; the run record is written."""
    cfg = TC.merge_cfg_from_list(TC.slm_defaults(), TINY)
    vq_cfg = TC.vq_cfg_for(cfg, True)
    paths = {}
    for name, seed in (("speaker", 3), ("listener", 4)):
        torch.manual_seed(seed)
        paths[name] = tmp_path / f"{name}_vq.pt"
        torch.save(VQAutoEncoder(vq_cfg).state_dict(), paths[name])
    paths["slm"] = tmp_path / "slm.pt"
    slm = _slm_state(cfg, vq_cfg, seed=5)
    torch.save(slm, paths["slm"])
    rc = cli.main(["--synthetic", "--device", "cpu", "--save-path", str(tmp_path / "run"),
                   "--pretrained", str(paths["slm"]), "--speaker-vq", str(paths["speaker"]),
                   "--listener-vq", str(paths["listener"]), *TINY])
    assert rc == 0 and "new best FD" in capsys.readouterr().out
    assert_run_record(tmp_path / "run", "finetune_s2s_pretrain")
    best = torch.load(tmp_path / "run" / "best_model.pt", weights_only=True)
    model = TS.SLMFT(cfg, vq_cfg)
    model.load_state_dict(best, strict=True)
    # the VQs were frozen: the pretrained SLM's, which replaced the loaded ones
    for k, v in best.items():
        if k.startswith(TS.SLMFT_FROZEN):
            assert torch.equal(v, slm[k]), k
    assert cli.get_parser().parse_args(["--synthetic"]).device == "cuda"
