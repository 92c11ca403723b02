"""The port's ``FaceTrainer`` in lockstep with the JAX package's over three
steps across the stage switch, on the CPU: 64 x 64, descriptor 32, two
mapping layers, ``pretrain_warp_iteration`` 2 (two warp steps, then a gen
step with a fresh Adam), the perceptual losses on one seeded VGG19 state_dict
(JAX through ``torch_vgg19_to_flax``), the generator's weights from a seeded
port model (JAX through ``torch_face_generator_to_flax``), one pair a step.

Each step starts from JAX's parameters: before steps 2 and 3 the port's
generator takes JAX's weights (its Adam moments stay its own). Adam turns
rounding in a near-zero gradient into a step of +lr in one framework and
-lr in the other, and an element moved so shifts the next step's losses
by up to 1e-2 relative and its Adam step by far more than rounding; from a
common start each step is held as tightly as the first:

* every step's losses within 1e-5 relative;
* every step's parameters within 2 lr of JAX's (an Adam step is at most
  about lr, whatever the gradient); after a fresh Adam's step (1 and 3)
  99% of the elements within 1e-8 (about 0.4% flip sign here); after
  Adam's second step, a smooth function of both steps' gradients, 95%
  within 1e-6, 1% of lr (97.6% here: the warp's bilinear sampling has a
  gradient that jumps where a sampling point crosses a pixel edge, so the
  two frameworks' gradients differ by more than rounding);
* the EMA within (1 - decay) times those bounds summed over the steps;
* the fresh Adam and LR count at the switch, ``save`` / ``load_latest``,
  ``ema_update`` and the step LR, exactly.

The gen step's update covers its backward: the final loss with its style
term (weight 250) and the editing net, which only that stage trains.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.render import generator as JG
from dyadic_interaction_modeling_tpu.render import trainer as JT
from dyadic_interaction_modeling_tpu.render.import_torch import torch_face_generator_to_flax
from dyadic_interaction_modeling_tpu.render.perceptual import torch_vgg19_to_flax
from dyadic_interaction_modeling_tpu_torch.render import generator as TG
from dyadic_interaction_modeling_tpu_torch.render import trainer as TT
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_face_generator_to_state_dict
from test_torch_perceptual import seeded_state_dict

SMALL = dict(flame_coeff_nc=56, coeff_nc=73, descriptor_nc=32, mapping_layers=2)
RES, LR = 64, 1e-4


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    r = np.random.default_rng(10 + seed)
    return {"source_image": r.uniform(-1, 1, (1, RES, RES, 3)).astype(np.float32),
            "target_image": r.uniform(-1, 1, (1, RES, RES, 3)).astype(np.float32),
            "source_semantics": r.normal(0, 0.3, (1, 56, 27)).astype(np.float32),
            "target_semantics": r.normal(0, 0.3, (1, 56, 27)).astype(np.float32)}


def _max_abs(got, want):
    return {k: (got[k] - want[k]).abs() for k in want}


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    tb = sys.modules.get("torch.utils.tensorboard", False)
    sys.modules["torch.utils.tensorboard"] = None
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = tmp_path_factory.mktemp("trainer")
        torch.manual_seed(0)
        model = TG.FaceGenerator(**SMALL)
        params = torch_face_generator_to_flax(model.state_dict(), mapping_layers=2)
        vgg = seeded_state_dict("vgg19", seed=3)
        jt = JT.FaceTrainer(JG.FaceGenerator(**SMALL), params, pretrain_warp_iteration=2,
                            vgg_params=torch_vgg19_to_flax(vgg), save_dir=str(root / "jax"))
        tt = TT.FaceTrainer(model, pretrain_warp_iteration=2, vgg_state_dict=vgg,
                            save_dir=str(root / "port"))
        steps = []
        for i in range(3):
            b = _batch(i)
            if i:  # from JAX's parameters
                tt.net.load_state_dict(jax_face_generator_to_state_dict(jt.params))
            stage = (jt.training_stage(), tt.training_stage())
            lj = jt.optimize_parameters({k: jnp.asarray(v) for k, v in b.items()})
            lt = tt.optimize_parameters(b)
            steps.append({"jax": lj, "port": lt, "stage": stage,
                          "params": _max_abs(tt.net.state_dict(),
                                             jax_face_generator_to_state_dict(jt.params)),
                          "ema": _max_abs(tt.ema.state_dict(),
                                          jax_face_generator_to_state_dict(jt.ema_params))})
        return jt, tt, steps, root
    finally:
        torch.set_num_threads(n)
        if tb is False:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = tb


def _step_matches_jax(s, within=1e-8, share=0.99):
    for k, v in s["jax"].items():
        assert abs(s["port"][k] - v) <= 1e-5 * abs(v), (k, s["port"][k], v)
    d = torch.cat([v.flatten() for v in s["params"].values()])
    assert float(d.max()) <= 2 * LR * 1.1
    assert float((d <= within).float().mean()) >= share


def test_first_step_matches_jax(lockstep):
    _, _, steps, _ = lockstep
    s = steps[0]
    assert sorted(s["port"]) == sorted(s["jax"]) == ["perceptual_warp", "total_loss"]
    _step_matches_jax(s)
    d = torch.cat([v.flatten() for v in s["params"].values()])
    assert float((d <= 1e-6).float().mean()) >= 0.998


def test_three_steps_across_the_stage_switch_stay_in_lockstep(lockstep):
    _, _, steps, _ = lockstep
    assert [s["stage"] for s in steps] == [("warp", "warp"), ("warp", "warp"), ("gen", "gen")]
    assert sorted(steps[2]["port"]) == ["perceptual_final", "perceptual_warp", "total_loss"]
    for i, s in enumerate(steps):
        # Adam's second step (step 2) is a smooth function of two gradients
        _step_matches_jax(s, *((1e-6, 0.95) if i == 1 else ()))
        # the EMA takes (1 - decay) of each step's parameters
        worst_ema = max(float(v.max()) for v in s["ema"].values())
        assert worst_ema <= (1 - TT.EMA_DECAY) * 2 * LR * 1.1 * (i + 1) + 1e-7, (i, worst_ema)


def test_stage_switch_restarts_adam_and_the_lr_count(lockstep):
    jt, tt, _, _ = lockstep
    # optax keeps the schedule's count in its state; both restarted at the switch
    assert int(jt.opt_state[0].count) == 1
    assert tt.scheduler.last_epoch == 1
    assert {int(st["step"]) for st in tt.optimizer.state.values()} == {1}
    assert tt.optimizer.param_groups[0]["lr"] == LR
    assert tt.optimizer.param_groups[0]["betas"] == (0.5, 0.999)


def test_save_and_load_latest(lockstep):
    _, tt, _, root = lockstep
    path = tt.save()
    assert path.endswith("step_3.pt")
    with open(root / "port" / "latest_checkpoint.txt") as f:
        assert f.read().strip() == "step_3.pt"
    torch.manual_seed(5)
    fresh = TT.FaceTrainer(TG.FaceGenerator(**SMALL), pretrain_warp_iteration=2,
                           perceptual_network="l1", save_dir=str(root / "port"))
    assert fresh.load_latest()
    assert (fresh.iteration, fresh.epoch, fresh.training_stage()) == (3, 0, "gen")
    for mine, theirs in ((fresh.net, tt.net), (fresh.ema, tt.ema)):
        for k, v in theirs.state_dict().items():
            assert torch.equal(mine.state_dict()[k], v), k
    assert not fresh.optimizer.state and fresh.scheduler.last_epoch == 0
    # the generator alone, as render_inference reads it
    ck = torch.load(path, weights_only=True)
    assert TG.face_generator_from_state_dict(ck["net_G_ema"]) is not None


def test_ema_update_and_step_lr_match_jax():
    assert TT.EMA_DECAY == JT.EMA_DECAY
    rng = np.random.default_rng(0)
    e, p = (rng.standard_normal((4, 5)).astype(np.float32) for _ in range(2))
    ema, net = torch.nn.Linear(5, 4, bias=False), torch.nn.Linear(5, 4, bias=False)
    with torch.no_grad():
        ema.weight.copy_(torch.from_numpy(e))
        net.weight.copy_(torch.from_numpy(p))
    TT.ema_update(ema, net)
    want = JT.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)})["w"]
    np.testing.assert_allclose(ema.weight.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    ours, theirs = TT.make_lr_schedule(), JT.make_lr_schedule()
    for count in (0, 299_999, 300_000, 600_001):
        assert ours(count) == pytest.approx(float(theirs(count)), rel=1e-6)
