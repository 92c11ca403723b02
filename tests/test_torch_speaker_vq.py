"""The port's audio-visual speaker VQ-VAE against the JAX package's, at a
small width whose heads are the full model's (hidden 192 over 2 heads of 96,
one layer an encoder or decoder, 8 codes a frame): the training forward at
L = 512, where every attention of the port takes ``flash_attention`` (its
plain version on the CPU) at D = 96 and the JAX package's its dense path;
three AdamW steps of ``make_vq_train_step(audio_visual=True)`` in lockstep;
the config and ``get_model``; and what both packages' ``train_vq`` do with
the speaker files of ViCo.

Weights go through ``jax_vq_speaker_to_state_dict`` (strict load); inputs
are made with numpy from a seed and fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.engine import vq_engine as JE
from dyadic_interaction_modeling_tpu.engine.train_state import create_train_state
from dyadic_interaction_modeling_tpu.models.vq_vae import VQSpeakerAutoEncoder as JVQS
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import train_vq
from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_vico
from dyadic_interaction_modeling_tpu_torch.engine import vq_engine as TE
from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
from dyadic_interaction_modeling_tpu_torch.models import VQAutoEncoder, get_model
from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQSpeakerAutoEncoder
from dyadic_interaction_modeling_tpu_torch.ops import transformer as TT
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_vq_speaker_to_state_dict
from tests.test_torch_observability import assert_run_record, no_tensorboard  # noqa: F401

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these models are small, and the test run's
    workers share the host's cores (eight threads each only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(hidden_size=192, num_hidden_layers=1, num_attention_heads=2,
             intermediate_size=64, n_embed=32, zquant_dim=16)
L = 512  # the shortest clip that takes K2/K3 in the port
TOL = 1e-5
LR, WD = 1e-3, 0.01


def _cfg(mod):
    cfg = mod.vq_speaker_defaults()
    cfg.update(SMALL)
    return cfg


@pytest.fixture(scope="module")
def pair():
    jm = JVQS(_cfg(JC))
    x = np.random.default_rng(0).standard_normal((1, 24, 824)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    sd = jax_vq_speaker_to_state_dict(jax.tree_util.tree_map(np.asarray, params), _cfg(TC))

    def torch_model():
        tm = VQSpeakerAutoEncoder(_cfg(TC))
        tm.load_state_dict(sd, strict=True)
        return tm

    return jm, params, torch_model


def _clips(b, l, seed):
    """Motion-like clips (sums of sinusoids) || Gaussian audio features, as
    the synthetic AV stream of ``train_vq`` makes them."""
    rng = np.random.default_rng(seed)
    t = np.arange(l)[None, :, None] / 30.0
    f = rng.uniform(0.2, 3.0, (b, 1, 56))
    ph = rng.uniform(0, 2 * np.pi, (b, 1, 56))
    motion = 0.5 * np.sin(2 * np.pi * f * t + ph)
    audio = 0.1 * rng.standard_normal((b, l, 768))
    return np.concatenate([motion, audio], axis=-1).astype(np.float32)


def test_forward_at_flash_length_matches_jax(pair, monkeypatch):
    """Exact codes; dec (56 motion || 768 audio), emb_loss, perplexity and the
    latents within 1e-5; the encoder's and both decoders' attention went
    through flash_attention with (B·H, L, 96) rows."""
    calls = []
    real = TT.flash_attention
    monkeypatch.setattr(TT, "flash_attention",
                        lambda q, *a, **kw: calls.append(q.shape) or real(q, *a, **kw))
    jm, params, torch_model = pair
    x = _clips(2, L, seed=1)
    dec, emb_loss, enc = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, x)
    with torch.no_grad():
        tdec, temb, tenc = torch_model()(torch.from_numpy(x))
    assert calls == [torch.Size([2 * 2, L, 96])] * 3
    assert tenc.indices.shape == (2, L * 8)
    np.testing.assert_array_equal(tenc.indices.numpy(), np.asarray(enc.indices))
    assert tdec.shape == (2, L, 824)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(temb), float(emb_loss), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tenc.perplexity), float(enc.perplexity), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tenc.quant.numpy(), np.asarray(enc.quant), atol=TOL, rtol=TOL)


def test_three_av_train_steps_in_lockstep(pair):
    """The JAX package's jitted step with the split AV loss (value_and_grad,
    AdamW with weight decay 0.01) beside the port's, from the same weights on
    the same clips: metrics within 1e-5 at every step, then every
    parameter's median difference within 1e-5 of its largest magnitude.
    Not every element: Adam divides by sqrt(v) + 1e-8, so where a gradient
    is a cancelling sum near zero (the Gaussian audio channels' weights, the
    biases under the L1 loss's random signs) a difference of fp32 summation
    order becomes an update difference near the learning rate; how many
    elements do so depends on the summation order, which moves with
    PyTorch's thread count (0.01% of an input weight at eight threads, 18%
    at one). The later steps' metrics show the two optimizers agree."""
    jm, params, torch_model = pair
    state = create_train_state(jm, {"params": params}, LR, weight_decay=WD)
    jstep = JE.make_vq_train_step(jm, audio_visual=True)
    tm = torch_model()
    tstep = TE.make_vq_train_step(tm, make_optimizer(tm, LR, WD), audio_visual=True)
    for i in range(3):
        x = _clips(1, L, seed=10 + i)
        state, jmet = jstep(state, jnp.asarray(x))
        tmet = tstep(torch.from_numpy(x))
        for k in TE.METRICS:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), atol=TOL, rtol=TOL,
                                       err_msg=f"step {i} {k}")
    final = jax_vq_speaker_to_state_dict(jax.tree_util.tree_map(np.asarray, state.params),
                                         _cfg(TC))
    for k, p in tm.named_parameters():
        scale = float(final[k].abs().max())
        diff = float((p.detach() - final[k]).abs().median())
        assert diff <= TOL * max(scale, 1.0), (k, diff, scale)


def test_speaker_config_and_get_model():
    assert dict(TC.vq_speaker_defaults()) == dict(JC.vq_speaker_defaults())
    cfg = TC.vq_speaker_defaults()
    assert cfg.hidden_size // cfg.num_attention_heads == 96
    cfg.update(SMALL)
    assert type(get_model(cfg)) is VQSpeakerAutoEncoder
    cfg.arch = "stage1_BIWI"
    assert type(get_model(cfg)) is VQAutoEncoder
    cfg.arch = "stage1_vocaset"
    model = get_model(cfg)
    assert type(model) is VQAutoEncoder and model.variant == "vocaset"
    stage2 = TC.codetalker_defaults()  # CodeTalker, ported since: built, no longer refused
    stage2.update(SMALL, feature_dim=32, vertice_dim=90, in_dim=90, n_head=2, num_layers=1)
    assert type(get_model(stage2)).__name__ == "CodeTalker"


AV_TINY = ["in_dim", "824", "hidden_size", "32", "num_hidden_layers", "1",
           "num_attention_heads", "2", "intermediate_size", "64", "zquant_dim", "16",
           "n_embed", "32", "epochs", "1"]


def test_train_vq_av_on_the_vico_files_stops_as_jax_cannot_train(tmp_path, monkeypatch,
                                                                  capsys, no_tensorboard):
    """The audio-visual branch of ``train_vq`` on ViCo files: the speaker
    reader gives 56-d clips (the speaker video alone) to an 824-d model. The
    JAX CLI fails in its loss (``metrics/loss.py:33``, shapes (1, 32, 768)
    and (1, 32, 0)); the port stops before training, naming both widths. The
    synthetic AV stream trains in the port."""
    write_vico(str(tmp_path / "data"), [20, 24, 30], ["train", "train", "test"], seed=3)
    (tmp_path / "work").mkdir()
    monkeypatch.chdir(tmp_path / "work")
    import functools

    from dyadic_interaction_modeling_tpu.cli import train_vq as jax_train_vq
    from dyadic_interaction_modeling_tpu.utils import observability

    # its JSON scalars only: the tensorboard mirror imports TensorFlow (~15 s)
    monkeypatch.setattr(observability, "MetricsWriter",
                        functools.partial(observability.MetricsWriter, use_tensorboard=False))

    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_train_vq.main(["--save-path", str(tmp_path / "jax"), *AV_TINY])
    with pytest.raises(SystemExit, match="in_dim = 824 .* give 56-d clips"):
        train_vq.main(["--device", "cpu", "--save-path", str(tmp_path / "port"), *AV_TINY])
    assert train_vq.main(["--synthetic", "--device", "cpu", "--save-path",
                          str(tmp_path / "port"), *AV_TINY]) == 0
    assert "new best rec_loss" in capsys.readouterr().out
