"""The port's ``parallel/`` and ``--mesh`` on the CPU, two gloo processes.

Counterpart of the JAX package's ``tests/test_mesh_cli.py``,
``test_multichip_slmft.py`` and ``test_distributed_multiprocess.py``: the
``MeshPlan`` spec grammar and its errors (against JAX's ``MeshPlan.parse``
on the same specs), the batch divisibility error, and one spawned session
of two ranks (``parallel.launch``, one torch thread each) that runs

* a two-process all-reduce, ``is_master`` and ``replicate``;
* ``cli.train_vq --mesh`` under ``data=2``, ``fsdp=2`` and
  ``data=1,model=2``, held here against the single-process run: the
  validation losses of both epochs within 1e-4 relative (``data=2`` and
  ``fsdp=2`` reduce the gradient over the ranks in another order) and
  bitwise for tensor parallel, which steps the whole batch on every rank
  (and, the one four-rank case, ``data=2,model=2`` spawned by the CLI);
* the sharded SLMFT step, two AdamW steps under TP and under FSDP at
  ``min_size`` 256 (the noise given, the single-process step run in the same
  rank), parameters within the JAX test's bound (rtol 5e-4, atol 1e-4);
* ``clip_by_global_norm`` under both, on seeded gradients, against the
  single-process clip within 1e-7;
* ``cli.train_s2s_pretrain --mesh data=2`` (rank 0 writes a
  ``best_model.pt`` that loads strictly) and ``cli.render_train --mesh
  data=2``, held against the single-process run: the logged losses (the
  global batch's) within 1e-5 relative at the first step, and the
  generator within 2 lr a step (Adam turns rounding in near-zero gradients
  into steps of lr), 97% of its elements within 1e-8.

Also: the TP rules shard something of an SLMFT, and the session pool's
``mesh=`` (two CPU "devices") gives the codes of ``mesh=None``.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu_torch.parallel import (
    MeshPlan, fsdp_param_shardings, launch, tp_param_shardings)

VQ = ("hidden_size 32 num_hidden_layers 1 num_attention_heads 2 intermediate_size 64 "
      "zquant_dim 32 epochs 2 batch_size 4").split()
SLM_ARGS = "dim 32 enc_depth 1 dec_depth 1 enc_heads 2 dec_heads 2 epochs 1".split()
RENDER = ["--synthetic", "--perceptual", "l1", "--steps-per-epoch", "2",
          "--pretrain-warp-iteration", "1", "--batch-size", "2", "--snapshot-iter", "2"]
LR = 1e-4  # the renderer's Adam


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    # the run records without the tensorboard mirror (it imports TensorFlow)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    torch.set_num_threads(n)


def _vq(out, mesh=None):
    from dyadic_interaction_modeling_tpu_torch.cli import train_vq

    shutil.rmtree(out, ignore_errors=True)
    train_vq.main(["--synthetic", "--device", "cpu", "--save-path", out]
                  + (["--mesh", mesh] if mesh else []) + VQ)


def _render(out, mesh=None):
    from dyadic_interaction_modeling_tpu_torch.cli import render_train

    shutil.rmtree(out, ignore_errors=True)
    render_train.main(RENDER + ["--device", "cpu", "--save-path", out]
                      + (["--mesh", mesh] if mesh else []))


def _scalars(path, tag):
    return [r["value"] for r in map(json.loads, open(path)) if r["tag"] == tag]


def _tiny_slmft():
    from dyadic_interaction_modeling_tpu_torch.config import slm_defaults, vq_listener_defaults
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT

    slm_cfg = slm_defaults()
    slm_cfg.update(dict(dim=64, dim_audio=32, enc_depth=2, enc_heads=2, dec_depth=2,
                        dec_heads=2, enc_max_seq_len=64, dec_max_seq_len=64, num_tokens=64))
    vq_cfg = vq_listener_defaults()
    vq_cfg.update(dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=128, zquant_dim=32, n_embed=64))
    torch.manual_seed(2)
    return SLMFT(slm_cfg, vq_cfg), slm_cfg


def _slmft_batch(slm_cfg, b=8, l=32):
    g = torch.Generator().manual_seed(0)
    return ((torch.randn(b, l, slm_cfg.dim_in, generator=g),
             torch.randn(b, l, slm_cfg.dim_in, generator=g),
             torch.randn(b, l, slm_cfg.dim_audio, generator=g),
             torch.ones(b, l, dtype=torch.bool)), torch.randn(b, l - 1, generator=g))


def _slmft_steps(model, stepped, batch, noise, plan=None):
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT_FROZEN

    step = make_slm_train_step(stepped, make_optimizer(model, 1e-3, 0.01, SLMFT_FROZEN), 1.0)
    if plan is not None:
        batch, noise = plan.shard_train_batch(batch), plan.shard_train_batch(noise)
    for _ in range(2):
        step(batch, noise=noise)
    return model


def _slmft_session(plan_spec):
    """Two SLMFT steps under ``plan_spec`` against the same two steps in
    this process alone: the largest parameter error past the JAX test's
    bound (0 when within) and the number of sharded tensors."""
    from dyadic_interaction_modeling_tpu_torch.engine.train_state import freeze
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT_FROZEN

    model, cfg = _tiny_slmft()
    batch, noise = _slmft_batch(cfg)
    ref, _ = _tiny_slmft()
    _slmft_steps(ref, ref, batch, noise)
    plan = MeshPlan.parse(plan_spec, "cpu")
    plan.fsdp_min_size = 256
    freeze(model, SLMFT_FROZEN)
    stepped = plan.shard_state(model)
    _slmft_steps(model, stepped, batch, noise, plan)
    got, want = plan.state_dict(model), ref.state_dict()  # the full dict on rank 0
    sharded = sum(type(p).__name__ == "DTensor" and p.placements[0].is_shard()
                  for p in model.parameters())
    if not got:
        return {}
    excess = max(float(((got[k] - want[k]).abs() - (1e-4 + 5e-4 * want[k].abs())).max())
                 for k in want if want[k].is_floating_point())
    return {"excess": max(excess, 0.0), "sharded": int(sharded),
            "keys": sorted(got) == sorted(want)}


def _clip_session(plan_spec):
    """``clip_by_global_norm`` on seeded gradients of the tiny SLMFT under
    ``plan_spec`` (sharded gradients as DTensors of their parameters'
    placements) against the same clip in one process: the largest error of
    any clipped gradient, whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from dyadic_interaction_modeling_tpu_torch.engine.train_state import clip_by_global_norm

    model, _ = _tiny_slmft()
    ref, _ = _tiny_slmft()
    g = torch.Generator().manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=g) for n, p in ref.named_parameters()}
    for n, p in ref.named_parameters():
        p.grad = grads[n].clone()
    clip_by_global_norm(ref.parameters(), 1.0)
    plan = MeshPlan.parse(plan_spec, "cpu")
    plan.fsdp_min_size = 256
    plan.shard_state(model)
    for n, p in model.named_parameters():
        p.grad = (distribute_tensor(grads[n], p.device_mesh, p.placements)
                  if isinstance(p, DTensor) else grads[n].clone())
    clip_by_global_norm(model.parameters(), 1.0)
    want = dict(ref.named_parameters())
    return max(float(((p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad)
                      - want[n].grad).abs().max()) for n, p in model.named_parameters())


def _no_tensorboard():
    """In a spawned rank: the run records without the tensorboard mirror."""
    sys.modules["torch.utils.tensorboard"] = None


def _session(argv):
    """What each of the two ranks runs; rank 0 writes ``results.json``."""
    import torch.distributed as dist

    from dyadic_interaction_modeling_tpu_torch.cli import train_s2s_pretrain
    from dyadic_interaction_modeling_tpu_torch.parallel import is_master, replicate

    _no_tensorboard()
    out = argv[0]
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    res = {"world": dist.get_world_size(), "allreduce": x.item(),
           "master": [bool(v) for v in _gather(is_master())]}
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(dist.get_rank() + 1))
    replicate(MeshPlan.parse("data=2", "cpu").mesh, lin)
    res["replicated"] = _gather(float(lin.weight.sum()))
    for mesh in ("data=2", "fsdp=2", "data=1,model=2"):
        _vq(os.path.join(out, f"vq_{mesh}"), mesh)
    res["slmft"] = {spec: _slmft_session(spec) for spec in ("data=1,model=2", "fsdp=2")}
    res["clip"] = {spec: _clip_session(spec) for spec in ("data=1,model=2", "fsdp=2")}
    train_s2s_pretrain.main(["--synthetic", "--device", "cpu", "--mesh", "data=2",
                             "--batch-size", "8", "--save-path",
                             os.path.join(out, "pretrain")] + SLM_ARGS)
    _render(os.path.join(out, "render"), "data=2")
    if dist.get_rank() == 0:
        with open(os.path.join(out, "results.json"), "w") as f:
            json.dump(res, f)


def _vq_rank(argv):
    """Each rank of the four-rank case: ``cli.train_vq`` joins the group."""
    _no_tensorboard()
    _vq(argv[0], "data=2,model=2")


def _gather(value):
    import torch.distributed as dist

    box = [None] * dist.get_world_size()
    dist.all_gather_object(box, value)
    return box


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """One spawned session of two ranks, and the single-process runs it is
    held against."""
    out = str(tmp_path_factory.mktemp("mesh"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)  # one thread a rank
    tb = sys.modules.get("torch.utils.tensorboard", False)
    sys.modules["torch.utils.tensorboard"] = None
    try:
        assert launch(MeshPlan.parse("data=2", "cpu"), _session, [out]) == 0
        torch.set_num_threads(1)
        _vq(os.path.join(out, "vq_single"))
        _render(os.path.join(out, "render_single"))
    finally:
        if tb is False:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = tb
        torch.set_num_threads(n)
    with open(os.path.join(out, "results.json")) as f:
        return out, json.load(f)


def test_mesh_plan_parse_and_errors_match_jax():
    from dyadic_interaction_modeling_tpu.parallel import MeshPlan as JPlan

    assert MeshPlan.parse(None) is None and MeshPlan.parse("") is None
    p = MeshPlan.parse("data=2", "cpu")
    assert (p.layout, p.data_par, p.model_par, p.world_size) == ("dp", 2, 1, 2)
    p = MeshPlan.parse("data=2,model=2", "cpu")
    assert (p.layout, p.data_par, p.model_par) == ("tp", 2, 2)
    assert "model=2" in p.describe() and p.describe().startswith("tp mesh")
    assert MeshPlan.parse("fsdp=2", "cpu").layout == "fsdp"
    # outside a group the CPU counts one device, as JAX counts a plain CPU host
    assert MeshPlan.parse("fsdp", "cpu").data_par == MeshPlan.parse("auto", "cpu").data_par == 1
    for bad in ("nonsense", "data", "model=2", "data=4,weird=2"):
        with pytest.raises(ValueError, match="bad --mesh spec") as ours:
            MeshPlan.parse(bad, "cpu")
        with pytest.raises(ValueError) as theirs:
            JPlan.parse(bad)
        assert str(ours.value) == str(theirs.value)
    for spec in ("data=4096", "fsdp=4096", "data=64,model=64"):
        with pytest.raises(ValueError, match="needs 4096 devices"):
            MeshPlan.parse(spec, "cpu")
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {n_cards + 1} devices but only {n_cards}"):
        MeshPlan.parse(f"data={n_cards + 1}")


def test_batch_divisibility_error():
    plan = MeshPlan.parse("data=2", "cpu")
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        plan.shard_train_batch((np.zeros((3, 4, 2), np.float32),))


def test_tp_and_fsdp_rules_shard_something():
    model, _ = _tiny_slmft()
    plan = tp_param_shardings(model, 2)
    col = [k for k, v in plan.items() if type(v).__name__ == "ColwiseParallel"]
    row = [k for k, v in plan.items() if type(v).__name__ == "RowwiseParallel"]
    # decoder and encoder q/k/v + ff up, and the logits; attention out + ff down
    assert len(col) >= 4 and len(row) >= 4
    assert any(k.endswith("to_logits") for k in col)
    assert any(k.endswith("ff.3") for k in row)
    assert not tp_param_shardings(model, 2, min_width=10 ** 6)
    paths = fsdp_param_shardings(model, 2, min_size=256)
    assert paths[-1] == "" and len(paths) >= 8


def test_two_process_all_reduce_and_replicate(session):
    _, res = session
    assert res["world"] == 2 and res["allreduce"] == 3.0 and res["master"] == [True, False]
    assert res["replicated"] == [6.0, 6.0]  # rank 0's weight (all ones) on both ranks


@pytest.mark.parametrize("mesh", ["data=2", "fsdp=2", "data=1,model=2"])
def test_train_vq_mesh_matches_single_process(session, mesh):
    out, _ = session
    want = _scalars(os.path.join(out, "vq_single", "scalars.jsonl"), "val/rec_loss")
    got = _scalars(os.path.join(out, f"vq_{mesh}", "scalars.jsonl"), "val/rec_loss")
    assert len(got) == len(want) == 2
    if mesh == "data=1,model=2":
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    sd = torch.load(os.path.join(out, f"vq_{mesh}", "best_model.pt"), weights_only=True)
    ref = torch.load(os.path.join(out, "vq_single", "best_model.pt"), weights_only=True)
    assert sorted(sd) == sorted(ref)
    assert all(type(v) is torch.Tensor for v in sd.values())


def test_train_vq_data_by_model_on_four_ranks(session):
    """The one four-process case: data=2,model=2 (TP inside each data
    rank, FSDP across them), the CLI in each rank of a launched group."""
    out, _ = session
    save = os.path.join(out, "vq_2d")
    torch.set_num_threads(4)  # one thread a rank
    assert launch(MeshPlan.parse("data=2,model=2", "cpu"), _vq_rank, [save]) == 0
    want = _scalars(os.path.join(out, "vq_single", "scalars.jsonl"), "val/rec_loss")
    np.testing.assert_allclose(_scalars(os.path.join(save, "scalars.jsonl"), "val/rec_loss"),
                               want, rtol=1e-4)


@pytest.mark.parametrize("spec", ["data=1,model=2", "fsdp=2"])
def test_sharded_slmft_step_matches_single_process(session, spec):
    _, res = session
    r = res["slmft"][spec]
    assert r["keys"] and r["sharded"] >= 8, r
    assert r["excess"] == 0.0, r


@pytest.mark.parametrize("spec", ["data=1,model=2", "fsdp=2"])
def test_clip_by_global_norm_counts_each_sharded_gradient_once(session, spec):
    """The norm from each rank's shards and one all-reduce: every clipped
    gradient as one process clips it (the seeded gradients' norm is far
    above 1, so every gradient is scaled)."""
    _, res = session
    assert res["clip"][spec] <= 1e-7, res["clip"]


def test_train_s2s_pretrain_mesh_writes_on_rank_0(session):
    from dyadic_interaction_modeling_tpu_torch.config import slm_defaults, vq_cfg_for
    from dyadic_interaction_modeling_tpu_torch.config import merge_cfg_from_list
    from dyadic_interaction_modeling_tpu_torch.models.slm import SLM

    out, _ = session
    cfg = merge_cfg_from_list(slm_defaults(), SLM_ARGS)
    model = SLM(cfg, vq_cfg_for(cfg, True))
    model.load_state_dict(torch.load(os.path.join(out, "pretrain", "best_model.pt"),
                                     weights_only=True), strict=True)
    loss = _scalars(os.path.join(out, "pretrain", "scalars.jsonl"), "val/loss")
    assert len(loss) == 1 and np.isfinite(loss[0])


def test_render_train_mesh_matches_single_process(session):
    out, _ = session
    for tag in ("total_loss", "perceptual_warp"):
        got = _scalars(os.path.join(out, "render", "logs", "scalars.jsonl"), tag)
        want = _scalars(os.path.join(out, "render_single", "logs", "scalars.jsonl"), tag)
        assert len(got) == len(want) == 2
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    ck = torch.load(os.path.join(out, "render", "step_2.pt"), weights_only=True)
    ref = torch.load(os.path.join(out, "render_single", "step_2.pt"), weights_only=True)
    assert ck["meta"] == ref["meta"] == {"epoch": 0, "iteration": 2}
    d = torch.cat([(ck["net_G"][k] - v).abs().flatten() for k, v in ref["net_G"].items()
                   if v.is_floating_point()])
    assert float(d.max()) <= 2 * LR * 2 * 1.01
    # 98.6% here; ranks that stepped on their own slice's gradient would
    # disagree in sign, and so by 2 lr, on far more
    assert float((d <= 1e-8).float().mean()) >= 0.97


def test_pool_mesh_matches_single_pool():
    """The pool over two CPU "devices" gives each slot the codes of the
    one-device pool, greedy and sampled (JAX ``tests/test_pool.py``'s
    sharded case)."""
    from test_torch_pool import _multiplex
    from test_torch_streaming import clip, slmft_pair

    from dyadic_interaction_modeling_tpu_torch.serving import StreamingSessionPool

    _, _, tm = slmft_pair(seed=2)
    vs, _, va = clip(7)
    for greedy in (True, False):
        pools = [StreamingSessionPool(tm, capacity=2, chunk=4, max_frames=16, max_tokens=16,
                                      greedy=greedy, mesh=mesh)
                 for mesh in (None, ["cpu", "cpu"])]
        slots = [_multiplex(p, vs, va) for p in pools]
        assert slots[0] == slots[1]
        for s in slots[0]:
            np.testing.assert_array_equal(pools[0].tokens(s).numpy(), pools[1].tokens(s).numpy())
        extra = [p.round(list(slots[0]), np.stack([vs[0, 12:16], vs[1, 8:12]]),
                         np.stack([va[0, 12:16], va[1, 8:12]]), n=2) for p in pools]
        np.testing.assert_array_equal(extra[0].numpy(), extra[1].numpy())
    with pytest.raises(ValueError, match="divide evenly"):
        StreamingSessionPool(tm, capacity=3, chunk=4, max_frames=16, mesh=["cpu", "cpu"])
