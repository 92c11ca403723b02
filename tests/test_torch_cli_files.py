"""The port's frozen-VQ token cache against ``forward_vq`` of both packages,
and the four CLI twins on files in the reference's layout.

``VQTokenCache`` is ``tests/test_engine.py``'s
``test_vq_token_cache_matches_forward_vq_across_compositions`` in the port:
codes assembled from the cache for any batch equal ``forward_vq``'s (the
JAX package's on the same weights, through its own import of the port's
state_dict), and a step on cached codes equals the step that tokenizes.
Then each CLI twin's ``main()`` runs on the CPU at small SLM widths on ViCo
and CANDOR files written by ``data.reference_files`` under ``../data``, as
the reference lays them out (the SLM twins' VQs at the small widths that
``vq_cfg_for`` gives synthetic runs, where files would take the full-width
VQs: ``chip_smoke.py`` runs those on the card), with reference-layout checkpoints
(``{'state_dict': ...}``, ``module.`` prefix, every norm spelled
weight/bias) for ``--pretrained`` and ``--state-dict``.
"""

import jax
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.models import slm as JS
from dyadic_interaction_modeling_tpu.utils.torch_import import torch_slm_to_flax
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.cli import (
    finetune_s2s_pretrain,
    test_s2s_pretrain,
    train_s2s_pretrain,
    train_vq,
)
from dyadic_interaction_modeling_tpu_torch.data.loader import (
    PaddedBatchLoader,
    slm_batch_from_collated,
)
from dyadic_interaction_modeling_tpu_torch.data.reference_files import write_candor, write_vico
from dyadic_interaction_modeling_tpu_torch.data.synthetic import synthetic_candor_dataset
from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import (
    VQTokenCache,
    make_slm_train_step,
)
from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
from dyadic_interaction_modeling_tpu_torch.models.slm import SLM, SLM_FROZEN, SLMFT
from tests.test_torch_observability import assert_run_record, no_tensorboard  # noqa: F401

@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these models are small, and the test run's
    workers share the host's cores (eight threads each only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SLM_TINY = dict(dim=32, dim_audio=768, enc_depth=1, enc_heads=2, dec_depth=1, dec_heads=2,
                enc_max_seq_len=64, dec_max_seq_len=64, num_tokens=32)
VQ_TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=64, zquant_dim=16, n_embed=32)


def _cfgs(mod):
    slm_cfg, vq_cfg = mod.slm_defaults(), mod.vq_listener_defaults()
    slm_cfg.update(SLM_TINY)
    vq_cfg.update(VQ_TINY)
    return slm_cfg, vq_cfg


def _tensors(collated):
    return tuple(torch.from_numpy(np.asarray(x)) for x in slm_batch_from_collated(collated))


@pytest.fixture(scope="module")
def tiny_slm():
    """The port's SLM from a seed, and the JAX package's forward_vq on the
    same weights (its import of the port's state_dict)."""
    jcfg, jvq = _cfgs(JC)
    tcfg, tvq = _cfgs(TC)
    torch.manual_seed(0)
    model = SLM(tcfg, tvq).eval()
    jm = JS.SLM(jcfg, jvq)
    ds = synthetic_candor_dataset(n_clips=6, min_len=12, max_len=30, seed=3)
    b0 = slm_batch_from_collated(next(iter(PaddedBatchLoader(ds, 3, shuffle=False))))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(1), *b0,
                            jax.random.PRNGKey(2))["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = torch_slm_to_flax(sd, jcfg, jvq, variant="slm",
                               params_template=template)["params"]
    jax_vq = jax.jit(lambda a, b, m: jm.apply({"params": params}, a, b, m,
                                              method="forward_vq"))
    return model, ds, jax_vq


def test_vq_token_cache_matches_forward_vq_across_compositions(tiny_slm):
    """Epoch 1 fills the cache batch by batch; epoch 2 regroups the clips
    (another padded length too) and is assembled from the cache alone: the
    codes equal the port's forward_vq and the JAX package's every time."""
    model, ds, jax_vq = tiny_slm
    cache = VQTokenCache(model)
    calls = []
    real = model.forward_vq
    model.forward_vq = lambda *a: calls.append(1) or real(*a)
    try:
        for shuffle, size, epoch in ((False, 3, 0), (True, 2, 7)):
            loader = PaddedBatchLoader(ds, batch_size=size, shuffle=shuffle)
            loader.set_epoch(epoch)
            for col in loader:
                batch = _tensors(col)
                before = len(calls)
                z = cache(batch, col[5])
                assert len(calls) - before == (1 if epoch == 0 else 0)
                with torch.no_grad():
                    ref = real(batch[0], batch[1], batch[3])
                sv, tgt, _, mask = slm_batch_from_collated(col)
                jref = jax_vq(sv, tgt, mask)
                for got, want, jwant in zip(z, ref, jref):
                    assert got.dtype == torch.int32
                    assert torch.equal(got, want)
                    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))
        # a batch without unique names is computed every time
        col = next(iter(PaddedBatchLoader(ds, 2, shuffle=False)))
        before = len(calls)
        cache(_tensors(col), ["same", "same"])
        assert len(calls) == before + 1
    finally:
        del model.forward_vq


def test_step_on_cached_codes_equals_the_step_that_tokenizes(tiny_slm):
    """From the same weights and noise, a step given the cached codes returns
    the same logs and leaves the same parameters as the step that runs the
    VQ encoders itself."""
    model, ds, _ = tiny_slm
    col = next(iter(PaddedBatchLoader(ds, 3, shuffle=False)))
    batch = _tensors(col)
    tokens = VQTokenCache(model)(batch, col[5])
    noise = tuple(torch.rand(batch[3].shape, generator=torch.Generator().manual_seed(s))
                  for s in (1, 2))
    results = []
    for cached in (False, True):
        m = SLM(model.cfg, model.vq_cfg)
        m.load_state_dict(model.state_dict(), strict=True)
        m.train()
        step = make_slm_train_step(m, make_optimizer(m, 1e-3, 0.01, SLM_FROZEN), 1.0,
                                   with_vq_tokens=cached)
        logs = step(batch + tokens if cached else batch, noise=noise)
        results.append((logs, m.state_dict()))
    (la, sa), (lb, sb) = results
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


SLM_CLI = ["dim", "32", "enc_depth", "1", "dec_depth", "1", "enc_heads", "2",
           "dec_heads", "2"]
VQ_CLI = ["hidden_size", "32", "num_hidden_layers", "1", "num_attention_heads", "2",
          "intermediate_size", "64", "zquant_dim", "16", "n_embed", "32"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``data/`` in the reference's layout beside a working directory
    ``work/``: ViCo 8 train and 3 test clips (12-40 frames), CANDOR 20
    conversations x 2 utterances (6-30 frames)."""
    root = tmp_path_factory.mktemp("files")
    lengths = [12, 20, 28, 40, 16, 24, 33, 18, 30, 14, 22]
    write_vico(str(root / "data"), lengths, ["train"] * 8 + ["test"] * 3, seed=4)
    write_candor(str(root / "data"), n_conversations=20, utterances=2, min_len=6,
                 max_len=30, seed=5)
    (root / "work").mkdir()
    return root


def _reference_file(model, path):
    """``model``'s weights as a reference checkpoint: ``{'state_dict': ...}``,
    ``module.`` keys, x-transformers norms spelled weight/bias."""
    sd = {"module." + k.replace(".gamma", ".weight").replace(".beta", ".bias"): v
          for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, path)


@pytest.mark.parametrize("twin", ["train_vq", "train_s2s_pretrain",
                                  "finetune_s2s_pretrain", "test_s2s_pretrain"])
def test_cli_twin_on_reference_files(files, monkeypatch, capsys, twin, no_tensorboard):
    monkeypatch.chdir(files / "work")
    out = files / twin
    cfg = TC.merge_cfg_from_list(TC.slm_defaults(), SLM_CLI)
    vq_cfg = TC.vq_cfg_for(cfg, synthetic=True)
    for mod in (train_s2s_pretrain, finetune_s2s_pretrain, test_s2s_pretrain):
        monkeypatch.setattr(mod, "vq_cfg_for", lambda c, synthetic=False: vq_cfg)
    if twin == "train_vq":
        assert train_vq.main(["--device", "cpu", "--save-path", str(out), "--prefetch", "2",
                              *VQ_CLI, "epochs", "1", "batch_size", "4"]) == 0
        assert "new best rec_loss" in capsys.readouterr().out
        from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQAutoEncoder

        VQAutoEncoder(train_vq.vq_train_cfg(VQ_CLI)).load_state_dict(
            torch.load(out / "best_model.pt", weights_only=True), strict=True)
        assert_run_record(out, twin)
    elif twin == "train_s2s_pretrain":
        # with the token cache the VQ encoders run in epoch 1's training steps
        # only, and the weights come out as without it
        calls, per_epoch, real = [0], [], SLM.forward_vq

        def counted(self, *a):
            calls[0] += 1
            return real(self, *a)

        def train_epoch(*args, real_epoch=train_s2s_pretrain.train_epoch, **kwargs):
            before = calls[0]
            logs = real_epoch(*args, **kwargs)
            per_epoch.append(calls[0] - before)
            return logs

        monkeypatch.setattr(SLM, "forward_vq", counted)
        monkeypatch.setattr(train_s2s_pretrain, "train_epoch", train_epoch)
        states = []
        for extra in (["--vq-token-cache", "--prefetch", "2"], []):
            per_epoch.clear()
            assert train_s2s_pretrain.main(
                ["--device", "cpu", "--batch-size", "16", "--save-path", str(out), *extra,
                 *SLM_CLI, "epochs", "2"]) == 0
            states.append(torch.load(out / "best_model.pt", weights_only=True))
            # 38 training clips in batches of 16
            assert per_epoch == ([3, 0] if extra else [3, 3])
        assert "val loss" in capsys.readouterr().out
        assert all(torch.equal(states[0][k], states[1][k]) for k in states[1])
        SLM(cfg, vq_cfg).load_state_dict(states[0], strict=True)
        assert_run_record(out, twin)
    elif twin == "finetune_s2s_pretrain":
        torch.manual_seed(3)
        _reference_file(SLM(cfg, vq_cfg), files / "slm.pth.tar")
        assert finetune_s2s_pretrain.main(
            ["--device", "cpu", "--pretrained", str(files / "slm.pth.tar"), "--save-path",
             str(out), "--vq-token-cache", *SLM_CLI, "epochs", "1"]) == 0
        assert "new best FD" in capsys.readouterr().out
        SLMFT(cfg, vq_cfg).load_state_dict(
            torch.load(out / "best_model.pt", weights_only=True), strict=True)
        assert_run_record(out, twin)
    else:
        torch.manual_seed(4)
        _reference_file(SLMFT(cfg, vq_cfg), files / "slmft.pt")
        pred = files / "pred.pkl"
        assert test_s2s_pretrain.main(
            ["--device", "cpu", "--state-dict", str(files / "slmft.pt"), "--beam-size", "2",
             "--out", str(pred), *SLM_CLI]) == 0
        assert "fid_pose" in capsys.readouterr().out
        import pickle

        with open(pred, "rb") as f:
            got = pickle.load(f)
        assert len(got["y_pred"]) == 3 and all(np.isfinite(p).all() for p in got["y_pred"])
        assert all(p.endswith(".pkl") for p in got["ids"])

