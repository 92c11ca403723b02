"""The torch port's VQ-VAE tokenizer training against the JAX package's, at a
small width (hidden 32, 2 + 2 layers, 4 heads of 8, 32 codes): the training
forward at L = 512 at a head width K2/K3 take (hidden 48, 1 + 1 layers, one
head of 48), where the port's attention takes ``flash_attention`` (its plain
version on the CPU) and the JAX package's its dense path, the route by
length, mask and head width (D = 8 takes the matmul route), three
AdamW steps of ``make_vq_train_step`` in lockstep, the losses, the
code-space utilities, the VQ collate and the ``train_vq`` CLI twin.

Weights go through ``jax_vq_to_state_dict`` (strict load); inputs are made
with numpy from a seed and fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.cli.train_vq import _motion_collate
from dyadic_interaction_modeling_tpu.engine import vq_engine as JE
from dyadic_interaction_modeling_tpu.engine.train_state import create_train_state
from dyadic_interaction_modeling_tpu.metrics import loss as JL
from dyadic_interaction_modeling_tpu.models.vq_vae import VQAutoEncoder as JVQ
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import train_vq
from dyadic_interaction_modeling_tpu_torch.data.loader import vq_collate
from dyadic_interaction_modeling_tpu_torch.engine import vq_engine as TE
from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
from dyadic_interaction_modeling_tpu_torch.metrics import loss as TL
from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder
from dyadic_interaction_modeling_tpu_torch.ops import transformer as TT
from dyadic_interaction_modeling_tpu_torch.utils.checkpoint import BestCheckpointKeeper
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_vq_to_state_dict

SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, n_embed=32, zquant_dim=16)
# a head width of the kernels (D = 48, the listener VQ's); one layer a side
# keeps the decoder's outputs small enough for the absolute 1e-5
FLASH_WIDTH = dict(SMALL, hidden_size=48, num_hidden_layers=1, num_attention_heads=1)
L = 512  # the shortest clip that takes K2/K3 in the port
TOL = 1e-5
LR, WD = 1e-3, 0.01


def _cfg(mod, width=SMALL):
    cfg = mod.vq_listener_defaults()
    cfg.update(width)
    return cfg


def _pair(width):
    jm = JVQ(_cfg(JC, width))
    x = np.random.default_rng(0).standard_normal((1, 24, 56)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    sd = jax_vq_to_state_dict(jax.tree_util.tree_map(np.asarray, params), _cfg(TC, width))

    def torch_model():
        tm = VQAutoEncoder(_cfg(TC, width))
        tm.load_state_dict(sd, strict=True)
        return tm

    return jm, params, torch_model


@pytest.fixture(scope="module")
def pair():
    return _pair(SMALL)


def _clips(b, l, seed):
    """Smooth motion-like clips: sums of sinusoids per channel, as the
    synthetic datasets make them."""
    rng = np.random.default_rng(seed)
    t = np.arange(l)[None, :, None] / 30.0
    f = rng.uniform(0.2, 3.0, (b, 1, 56))
    ph = rng.uniform(0, 2 * np.pi, (b, 1, 56))
    return (0.5 * np.sin(2 * np.pi * f * t + ph)
            + 0.1 * rng.standard_normal((b, l, 56))).astype(np.float32)


@pytest.fixture
def flash_calls(monkeypatch):
    """The shapes of the VQ attention's calls of ``flash_attention``."""
    calls = []
    real = TT.flash_attention

    def counted(q, *args, **kwargs):
        calls.append(q.shape)
        return real(q, *args, **kwargs)

    monkeypatch.setattr(TT, "flash_attention", counted)
    return calls


def test_forward_at_flash_length_matches_jax(flash_calls):
    """dec, emb_loss, perplexity within 1e-5 and exact codes; every
    attention layer of the port (1 encoder + 1 decoder) went through
    flash_attention with (B·H, L, 48) rows."""
    jm, params, torch_model = _pair(FLASH_WIDTH)
    x = _clips(2, L, seed=1)
    dec, emb_loss, enc = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, x)
    with torch.no_grad():
        tdec, temb, tenc = torch_model()(torch.from_numpy(x))
    assert flash_calls == [torch.Size([2, L, 48])] * 2
    np.testing.assert_array_equal(tenc.indices.numpy(), np.asarray(enc.indices))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(temb), float(emb_loss), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tenc.perplexity), float(enc.perplexity), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tenc.quant.numpy(), np.asarray(enc.quant), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("l,mask,heads,flash", [
    (511, None, 2, False), (512, None, 2, True), (1024, None, 2, True),
    (512, "key", 2, True),   # a (B, 1, L) length mask is a key mask: K2/K3
    (512, "full", 2, False),  # any other mask keeps the matmul route
    (512, None, 12, False),  # D = 8, a width K2/K3 lack: the matmul route
])
def test_attention_route_by_length_and_mask(flash_calls, l, mask, heads, flash):
    """D = 96 / heads: K2/K3 at 48, the matmul route at 8, on every device."""
    torch.manual_seed(0)
    attn = TT.Attention(96, heads=heads)
    x = torch.randn(2, l, 96)
    m = None
    if mask == "key":
        m = (torch.arange(l)[None, :] < torch.tensor([l, l - 100])[:, None])[:, None, :]
    elif mask == "full":
        m = torch.ones(l, l, dtype=torch.bool).tril()
    with torch.no_grad():
        out = attn(x, m)
        q, k, v = (TT.split_heads(t, heads) for t in attn.to_qkv(x).chunk(3, dim=-1))
        mm = None if m is None else (m[None, None] if m.dim() == 2 else m[:, None])
        ref = attn.to_out(TT.merge_heads(TT.attend(q, k, v, attn.scale, mm)))
    assert len(flash_calls) == int(flash)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_three_train_steps_in_lockstep(pair):
    """The JAX package's jitted step (value_and_grad, then AdamW with weight
    decay 0.01, the CLI's default) beside the port's, from the same weights
    on the same batches of one clip of L = 512 (the reference's batch size):
    metrics within 1e-5 at every step, then every parameter within 1e-5 of
    its largest magnitude."""
    jm, params, torch_model = pair
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD)
    jstep = JE.make_vq_train_step(jm)
    tm = torch_model()
    tstep = TE.make_vq_train_step(tm, make_optimizer(tm, LR, WD))
    for i in range(3):
        x = _clips(1, L, seed=10 + i)
        state, jmet = jstep(state, jnp.asarray(x))
        tmet = tstep(torch.from_numpy(x))
        for k in TE.METRICS:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), atol=TOL, rtol=TOL,
                                       err_msg=f"step {i} {k}")
    final = jax_vq_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params), _cfg(TC))
    for k, p in tm.named_parameters():
        scale = float(final[k].abs().max())
        np.testing.assert_allclose(p.detach().numpy(), final[k].numpy(), rtol=0,
                                   atol=TOL * max(scale, 1.0), err_msg=k)


def test_eval_step_and_validate_match_jax(pair):
    jm, params, torch_model = pair
    batches = [_clips(2, 64, seed=20), _clips(2, 32, seed=21)]
    ref = JE.validate(params, [jnp.asarray(b) for b in batches], JE.make_vq_eval_step(jm))
    out = TE.validate([torch.from_numpy(b) for b in batches],
                      TE.make_vq_eval_step(torch_model()))
    assert set(out) == set(ref) == set(TE.METRICS)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], atol=TOL, rtol=TOL, err_msg=k)


class _Read(float):
    """A metric that counts how often the host reads it."""
    reads = 0

    def __float__(self):
        _Read.reads += 1
        return super().__float__()


def test_train_epoch_reads_the_metrics_once_per_print_window():
    """Every ``print_freq`` steps the log line reads the metrics, and the last
    step's are returned: 2 windows of 2 in 5 steps, then the end."""
    _Read.reads = 0
    out = TE.train_epoch(range(5), lambda batch: {k: _Read(batch) for k in TE.METRICS},
                         print_freq=2)
    assert out == {k: 4.0 for k in TE.METRICS}
    assert _Read.reads == 3 * len(TE.METRICS)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    pred, target = (rng.standard_normal((2, 10, 824)).astype(np.float32) for _ in range(2))
    q = np.float32(0.37)
    for jf, tf in ((JL.calc_vq_loss, TL.calc_vq_loss), (JL.calc_vq_loss_AV, TL.calc_vq_loss_AV)):
        jt, (jr, jq) = jf(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(q), 0.5)
        tt, (tr, tq) = tf(torch.from_numpy(pred), torch.from_numpy(target), torch.tensor(q), 0.5)
        np.testing.assert_allclose([float(tt), float(tr), float(tq)],
                                   [float(jt), float(jr), float(jq)], rtol=1e-6)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7))
    labels[0, :3] = -100
    for ignore in (None, -100):
        lab = np.where(labels < 0, 0, labels) if ignore is None else labels
        ref = JL.calc_logit_loss(jnp.asarray(logits), jnp.asarray(lab), ignore)
        out = TL.calc_logit_loss(torch.from_numpy(logits), torch.from_numpy(lab), ignore)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_code_space_utilities_match_jax(pair):
    jm, params, torch_model = pair
    tm = torch_model().eval()
    x = _clips(2, 24, seed=4)
    run = jax.jit(lambda p, x: (
        jm.apply({"params": p}, x, method=JVQ.get_quant),
        jm.apply({"params": p}, x, method=JVQ.get_distances)))
    (jq, ji), jd = run(params, x)
    idx = np.random.default_rng(5).integers(0, 32, (2, 24)).astype(np.int32)
    jimg = jm.apply({"params": params}, jnp.asarray(idx), (2, 24, 16),
                    method=JVQ.decode_to_img)
    jfeat = jm.apply({"params": params}, jnp.asarray(idx), (2, 24, 16),
                     method=JVQ.entry_to_feature)
    with torch.no_grad():
        tq, ti = tm.get_quant(torch.from_numpy(x))
        td = tm.get_distances(torch.from_numpy(x))
        timg = tm.decode_to_img(torch.from_numpy(idx), (2, 24, 16))
        tfeat = tm.entry_to_feature(torch.from_numpy(idx), (2, 24, 16))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(td.argmin(-1).int().numpy(), np.asarray(ji))
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tfeat.numpy(), np.asarray(jfeat))


def test_vq_collate_matches_jax():
    rng = np.random.default_rng(6)
    items = [(rng.standard_normal((n, 56)).astype(np.float32), i)
             for i, n in enumerate((40, 17, 70))]
    for max_len in (1024, 64):
        out = vq_collate(items, max_len=max_len)
        np.testing.assert_array_equal(out, np.asarray(_motion_collate(items, max_len=max_len)))
    assert out.shape == (3, 64, 56) and np.all(out[1, 17:] == items[1][0][-1])


def test_best_checkpoint_keeper_saves_only_improvements(tmp_path):
    keeper = BestCheckpointKeeper(str(tmp_path / "run"))
    m = torch.nn.Linear(2, 2)
    assert keeper.update(1.0, m)
    with torch.no_grad():
        m.weight.add_(1.0)
    assert not keeper.update(1.5, m)
    saved = torch.load(keeper.path, weights_only=True)
    assert not torch.equal(saved["weight"], m.weight)
    assert keeper.update(0.5, m) and keeper.best == 0.5
    assert torch.equal(torch.load(keeper.path, weights_only=True)["weight"], m.weight)


TINY = ["hidden_size", "32", "num_hidden_layers", "1", "num_attention_heads", "2",
        "intermediate_size", "64", "n_embed", "32", "zquant_dim", "16", "epochs", "1",
        "batch_size", "4", "batch_size_val", "8"]


@pytest.mark.parametrize("config_wd", [False, True])
def test_train_vq_cli_twin_on_cpu(tmp_path, capsys, monkeypatch, config_wd):
    """One epoch on synthetic clips; the best state_dict loads strictly. AdamW
    takes weight decay 0.01 whatever the config says (the reference quirk),
    unless ``adamw_config_weight_decay True``."""
    seen = []
    real = train_vq.make_optimizer
    monkeypatch.setattr(train_vq, "make_optimizer",
                        lambda m, lr, wd: (seen.append((lr, wd)), real(m, lr, wd))[1])
    extra = ["adamw_config_weight_decay", "True"] if config_wd else []
    rc = train_vq.main(["--synthetic", "--device", "cpu", "--save-path",
                        str(tmp_path / "run"), *TINY, *extra])
    assert rc == 0 and "new best rec_loss" in capsys.readouterr().out
    assert seen == [(1e-4, 0.002 if config_wd else 0.01)]
    cfg = train_vq.vq_train_cfg(TINY)
    VQAutoEncoder(cfg).load_state_dict(
        torch.load(tmp_path / "run" / "best_model.pt", weights_only=True), strict=True)
    assert train_vq.get_parser().parse_args(["--synthetic"]).device == "cuda"
