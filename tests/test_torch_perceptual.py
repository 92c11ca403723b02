"""The port's perceptual trunks, ``PerceptualLoss`` and ``PerceptualDistance``
against the JAX package on the CPU (the cases of ``tests/test_render.py``
that ``render/perceptual.py`` and ``render/metrics.py`` answer).

Each trunk takes one seeded state_dict in torchvision's layout (VGG-Face in
``vgg_face_dag``'s, the robust ResNet-50 in its model-zoo wrapping), with the
classification head the trunk never runs: the port loads it with
``load_trunk_state_dict`` (``strict=True`` after the head is dropped), JAX
through its importer. Inputs: 64 x 64 for VGG / AlexNet / ResNet, 75 for
Inception, 224 for VGG-Face. ``utils.weights.jax_perceptual_to_state_dict``
must carry JAX's params back (its folded BatchNorm as an eval BatchNorm).

Tolerances (fp32): taps 1e-5 of each tap's largest magnitude; losses and
distances 1e-5 relative; input gradients 1e-4 of the largest. The loss
cases cover the scale halvings (64 -> 32 -> 16, then the ``_min_size``
break at 8) and ``resize`` from 256 to 224, both shrinking resizes that
``jax.image.resize`` antialiases. Two things of fp32, not of the port,
shape them:

* the input gradient is held for the l2 criterion: the l1 criterion's
  gradient is sign(a - b), which flips where a feature pair sits within
  rounding of equal, and one such pair moves the gradient of its whole
  receptive field by far more than 1e-4 of its largest; l1 losses are held
  by value;
* JAX's fp32 mean over ~5e5 elements can miss the float64 loss by more
  than 1e-5 (the l2 / instance-norm case): where it does, the port is held
  within 1e-6 of its own float64 value instead.

The resize case taps relu_1_1: at 224 x 224 JAX's fp32 input gradient
through relu_2_1 is further than 1e-4 of its largest off the float64 one,
where the port's fp32 gradient is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dyadic_interaction_modeling_tpu.render import metrics as JM
from dyadic_interaction_modeling_tpu.render import perceptual as JP
from dyadic_interaction_modeling_tpu_torch.render import metrics as TM
from dyadic_interaction_modeling_tpu_torch.render import perceptual as TP
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_perceptual_to_state_dict

SIZES = {"vgg19": 64, "vgg16": 64, "alexnet": 64, "resnet50": 64, "robust_resnet50": 64,
         "inception_v3": 75, "vgg_face_dag": 224}
HEADS = {"vgg19": {"classifier.0.weight": (16, 8)}, "vgg16": {"classifier.6.bias": (10,)},
         "alexnet": {"classifier.1.weight": (16, 8)}, "resnet50": {"fc.weight": (10, 2048)},
         "inception_v3": {"fc.weight": (10, 2048), "AuxLogits.fc.bias": (10,)}}
VGG_LAYERS = ("relu_1_1", "relu_2_1", "relu_3_1", "relu_4_1", "relu_5_1")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _full_layers(net):
    return {"vgg19": list(TP.VGG19_TAPS), "vgg16": list(TP.VGG16_TAPS)}.get(
        net, TP.default_layers(net, VGG_LAYERS))


def seeded_state_dict(net, seed=0):
    """A torchvision-layout state_dict of ``net``: He-scaled conv / fc
    weights, small biases, BatchNorm statistics away from the identity."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in TP.PERCEPTUAL_NETWORKS[net](_full_layers(net)).state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long)
        elif v.ndim > 1:
            sd[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        elif "running_var" in k or (k.endswith("weight") and "bn" in k):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    for k, shape in HEADS.get(net, {}).items():
        sd[k] = torch.randn(shape, generator=g)
    return sd


def _jax_params(net, sd):
    if net == "robust_resnet50":
        return JP.torch_robust_resnet50_to_flax(_robust_wrap(sd))
    return JP.PERCEPTUAL_NETWORKS[net][1](sd)


def _robust_wrap(sd):
    wrapped = {f"module.model.{k}": v for k, v in sd.items()}
    wrapped["module.attacker.normalize.mean"] = torch.zeros(3)
    return {"model": wrapped}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _as_jax(t):
    t = t.detach().numpy()
    return t.transpose(0, 2, 3, 1) if t.ndim == 4 else t


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("net", list(SIZES))
def test_trunk_taps_match_jax(net):
    sd = seeded_state_dict(net, seed=list(SIZES).index(net))
    layers = _full_layers(net)
    src = _robust_wrap(sd) if net == "robust_resnet50" else sd
    trunk = TP.load_trunk_state_dict(TP.PERCEPTUAL_NETWORKS[net](layers), src, net)
    jp = _jax_params(net, sd)
    x = np.random.default_rng(1).uniform(-1, 1, (1, SIZES[net], SIZES[net], 3)).astype(
        np.float32)
    want = jax.jit(JP.PERCEPTUAL_NETWORKS[net][0](layers).apply)(jp, jnp.asarray(x))
    with torch.no_grad():
        got = trunk(nchw(x))
    assert sorted(got) == sorted(want)
    for name in layers:
        assert _rel(_as_jax(got[name]), want[name]) <= 1e-5, name
    # JAX's params come back through the bridge: the same tensors, a folded
    # BatchNorm as an eval one that gives the same taps
    back = jax_perceptual_to_state_dict(net, jp)
    bridged = TP.load_trunk_state_dict(TP.PERCEPTUAL_NETWORKS[net](layers), back, net)
    if "resnet" in net or net == "inception_v3":
        with torch.no_grad():
            again = bridged(nchw(x))
        for name in layers:
            assert _rel(_as_jax(again[name]), want[name]) <= 1e-5, name
    else:
        for k, v in bridged.state_dict().items():
            assert torch.equal(v, sd[k]), k
    # frozen, and eval whatever train() asks
    trunk.train()
    assert not trunk.training and not any(p.requires_grad for p in trunk.parameters())


def test_strict_load_refuses_a_missing_or_unknown_key():
    sd = seeded_state_dict("vgg16")
    trunk = TP.VGG16Features(["relu_2_1"])
    TP.load_trunk_state_dict(trunk, sd)  # the layers past relu_2_1 and the head dropped
    assert trunk.skipped[0] == "features.7." and len(trunk.features) == 7
    with pytest.raises(RuntimeError, match="Missing"):
        TP.load_trunk_state_dict(TP.VGG16Features(["relu_2_1"]),
                                 {k: v for k, v in sd.items() if k != "features.0.bias"})
    with pytest.raises(RuntimeError, match="Unexpected"):
        TP.load_trunk_state_dict(TP.VGG16Features(["relu_2_1"]),
                                 {**sd, "features.1.weight": torch.zeros(1)})
    # the robust checkpoint unwraps to the flat resnet50 keys
    flat = seeded_state_dict("resnet50")
    assert TP.robust_resnet50_state_dict(_robust_wrap(flat)).keys() == flat.keys()


@pytest.fixture(scope="module")
def vgg():
    sd = seeded_state_dict("vgg19", seed=7)
    return sd, JP.torch_vgg19_to_flax(sd)




FINAL = dict(num_scales=4, use_style_loss=True, weight_style_to_perceptual=250.0)
LOSS_CASES = {
    # the final loss's config: 4 scales (32, 16; 8 is under relu_5_1's 16), style 250
    "final": (FINAL, 32),
    "final_l2": (dict(FINAL, criterion="l2"), 32),
    "weights_l2_instance_mask": (dict(layers=("relu_1_1", "relu_2_1"), num_scales=2,
                                      weights=(0.25, 1.5), criterion="l2",
                                      instance_normalized=True), 64),
    # resize from 256 to 224 shrinks, then the halving to 112
    "resize_l2": (dict(layers=("relu_1_1",), num_scales=2, resize=True, criterion="l2",
                       use_style_loss=True, weight_style_to_perceptual=10.0), 256),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_perceptual_loss_and_its_input_gradient_match_jax(vgg, case):
    sd, jparams = vgg
    kw, res = LOSS_CASES[case]
    rng = np.random.default_rng(len(case))
    a, b = (rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(0, 1, (2, res, res, 1)).astype(np.float32) if "mask" in case else None
    jl = JP.PerceptualLoss(vgg_params=jparams, **kw)
    tl = TP.PerceptualLoss(state_dict=sd, **kw)
    grad = kw.get("criterion") == "l2"
    fn = (lambda x, y, m: jl(x, y, m))
    want = jax.jit(jax.value_and_grad(fn) if grad else fn)(
        jnp.asarray(a), jnp.asarray(b), None if mask is None else jnp.asarray(mask))
    want, jgrad = (float(want[0]), want[1]) if grad else (float(want), None)
    tm = None if mask is None else nchw(mask)
    ta = nchw(a).requires_grad_(grad)
    got = tl(ta, nchw(b), tm)
    if grad:
        got.backward()
    got = float(got.detach())
    if abs(got - want) > 1e-5 * abs(want):
        with torch.no_grad():
            exact = float(tl.double()(nchw(a).double(), nchw(b).double(),
                                      None if tm is None else tm.double()))
        # JAX's own fp32 reduction is further than 1e-5 from the exact loss
        assert abs(want - exact) > 1e-5 * abs(exact), (got, want, exact)
        assert abs(got - exact) <= 1e-6 * abs(exact), (got, want, exact)
    if grad:
        assert _rel(_as_jax(ta.grad), jgrad) <= 1e-4
    assert tl.min_size == jl._min_size


def test_l1_network_and_option_errors_match_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    want = JP.PerceptualLoss(network="l1")(jnp.asarray(a), jnp.asarray(b))
    got = TP.PerceptualLoss(network="l1")(nchw(a), nchw(b))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for kw, err in ((dict(layers=("relu_1_1", "relu_2_1"), weights=(1.0,)), "number of weights"),
                    (dict(criterion="huber"), "Criterion"),
                    (dict(network="no_such_trunk"), "unknown perceptual network")):
        with pytest.raises(ValueError, match=err):
            TP.PerceptualLoss(**kw)
        with pytest.raises(ValueError, match=err):
            JP.PerceptualLoss(vgg_params={}, **kw)


@pytest.mark.parametrize("net", list(SIZES))
def test_layer_remapping_and_min_size_match_jax(net):
    for layers in (VGG_LAYERS, ("relu_1_1", "relu_3_1") if net.startswith("vgg1") else None):
        if layers is None:
            continue
        jl = JP.PerceptualLoss(layers=layers, network=net, vgg_params={})
        tl = TP.PerceptualLoss(layers=layers, network=net, trunk=nn.Identity())
        assert tl.layers == jl.layers and tl.min_size == jl._min_size


def test_adaptive_avg_pool_matches_jax():
    rng = np.random.default_rng(5)
    for h, w in ((14, 14), (10, 13), (7, 7), (9, 23)):
        x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
        want = JP.adaptive_avg_pool_2d(jnp.asarray(x), (7, 7))
        got = TP.adaptive_avg_pool_2d(nchw(x), (7, 7))
        np.testing.assert_allclose(_as_jax(got), want, rtol=1e-5, atol=1e-6)


def test_perceptual_distance_with_lpips_weights_matches_jax(vgg):
    sd, jparams = vgg
    chans = (64, 128, 256, 512, 512)
    g = torch.Generator().manual_seed(0)
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
           for i, c in enumerate(chans)}
    weights = TM.lpips_lin_to_weights(lin)
    jweights = JM.lpips_lin_to_weights(lin)
    assert list(weights) == list(JM.LPIPS_LAYERS) == list(TM.LPIPS_LAYERS)
    as_list = {f"lins.{i}.model.1.weight": v for i, v in enumerate(lin.values())}
    for name, w in TM.lpips_lin_to_weights(as_list).items():
        assert torch.equal(w, weights[name])
    with pytest.raises(KeyError):
        TM.lpips_lin_to_weights({**lin, "net.slice1.0.weight": torch.zeros(3)})
    with pytest.raises(KeyError):
        TM.lpips_lin_to_weights({k: v for k, v in lin.items() if "lin4" not in k})
    with pytest.raises(ValueError):
        TM.lpips_lin_to_weights({**lin, "lin0.model.1.weight": torch.rand(1, 64, 3, 3)})

    rng = np.random.default_rng(1)
    a, b = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    for tw, jw in ((weights, jweights), (None, None)):
        jd = JM.PerceptualDistance(vgg_params=jparams, lin_weights=jw)
        want = np.asarray(jax.jit(lambda x, y: jd(x, y))(jnp.asarray(a), jnp.asarray(b)))
        dist = TM.PerceptualDistance(state_dict=sd, lin_weights=tw)
        got = dist(nchw(a), nchw(b)).numpy()
        assert got.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert float(dist(nchw(a), nchw(a)).abs().max()) < 1e-6


def test_random_trunk_losses_of_jax_init_carry_over():
    """JAX's default random-feature loss (``vgg_params=None``, its own init)
    reproduced in the port through the bridge."""
    jl = JP.PerceptualLoss(layers=("relu_1_1", "relu_2_1"), num_scales=2)
    tl = TP.PerceptualLoss(layers=("relu_1_1", "relu_2_1"), num_scales=2,
                           state_dict=jax_perceptual_to_state_dict("vgg19", jl.params))
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want = float(jax.jit(lambda x, y: jl(x, y))(jnp.asarray(a), jnp.asarray(b)))
    got = float(tl(nchw(a), nchw(b)))
    assert abs(got - want) <= 1e-5 * abs(want)
    assert float(tl(nchw(a), nchw(a))) < 1e-5 < got
