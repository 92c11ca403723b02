"""The port's PIRender generator and inference path against the JAX package
on the CPU: ``grid_sample`` and the flow -> deformation -> warp chain (with
the reference's non-identity zero flow), the 64 -> 256 deformation resize,
``LayerNorm2d``, ``ADAIN`` and ``MappingNet``, ``FaceGenerator`` at a small
width (descriptor 32, 2 mapping layers, 64 x 64) in fp32, under spectral
norm and in the mixed bf16 config, the weight bridge against JAX's exporter,
and ``render_clip`` / ``render_windows`` / ``render_coeff_dir`` /
``write_reenactment_video`` (the CLI twins are in
``tests/test_torch_render_data.py``).

The weights come from a seeded port model; JAX takes them through its own
importer (``torch_face_generator_to_flax``), so no JAX init is compiled, and
the port's bridge (``utils.weights.jax_face_generator_to_state_dict``) must
give them back bitwise, as JAX's exporter does. Tolerances (fp32): the
warp chain 1e-5, the resize 1e-6, norms and the mapping net 1e-5, the
generator and the inference helpers 1e-4; written frames within one uint8
level; the mixed bf16 config at the bound its test states."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dyadic_interaction_modeling_tpu.render import flow as JF
from dyadic_interaction_modeling_tpu.render import generator as JG
from dyadic_interaction_modeling_tpu.render import inference as JI
from dyadic_interaction_modeling_tpu.render.import_torch import (
    flax_face_generator_to_torch,
    torch_face_generator_to_flax,
)
from dyadic_interaction_modeling_tpu_torch.render import flow as TF
from dyadic_interaction_modeling_tpu_torch.render import generator as TG
from dyadic_interaction_modeling_tpu_torch.render import inference as TI
from dyadic_interaction_modeling_tpu_torch.render.image_io import read_png
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_face_generator_to_state_dict

SMALL = dict(flame_coeff_nc=56, coeff_nc=73, descriptor_nc=32, mapping_layers=2)
RES, WIN = 64, 27


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _inputs(b=2, res=RES, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (b, res, res, 3)).astype(np.float32),
            rng.randn(b, 56, WIN).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jit_apply(jm):
    """One jitted apply per JAX module, so equal shapes compile once."""
    return jax.jit(lambda p, img, drv: jm.apply({"params": p}, img, drv))


@pytest.fixture(scope="module")
def small():
    """A seeded port model at the small width, the JAX generator and JAX's
    import of the port's weights."""
    torch.manual_seed(0)
    model = TG.FaceGenerator(**SMALL).eval()
    params = torch_face_generator_to_flax(model.state_dict(), mapping_layers=2)
    return JG.FaceGenerator(**SMALL), params, model


def test_grid_sample_and_warp_chain_match_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 8, 10, 3).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 6, 7, 2)).astype(np.float32)
    ours = F.grid_sample(nchw(img), torch.from_numpy(grid), mode="bilinear",
                         padding_mode="zeros", align_corners=False)
    np.testing.assert_allclose(nhwc(ours), JF.grid_sample_bilinear(img, grid), atol=1e-5)

    img = rng.randn(1, 16, 16, 3).astype(np.float32)
    for flow in (rng.randn(1, 16, 16, 2).astype(np.float32) * 2,
                 np.zeros((1, 16, 16, 2), np.float32)):
        deform = TF.convert_flow_to_deformation(nchw(flow))
        np.testing.assert_allclose(deform.numpy(), JF.convert_flow_to_deformation(flow),
                                   atol=1e-6)
        ours = nhwc(TF.warp_image(nchw(img), deform))
        np.testing.assert_allclose(ours, JF.warp_image(img, JF.convert_flow_to_deformation(
            flow)), atol=1e-5)
    # zero flow is not the identity: align-corners grid, align_corners=False sampling
    assert np.abs(ours - img).max() > 0.1


def test_deformation_resize_64_to_256_matches_jax_image_resize():
    rng = np.random.RandomState(1)
    deform = rng.uniform(-1.1, 1.1, (2, 64, 64, 2)).astype(np.float32)
    ours = F.interpolate(torch.from_numpy(deform).permute(0, 3, 1, 2), size=(256, 256),
                         mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    want = jax.image.resize(deform, (2, 256, 256, 2), method="bilinear")
    np.testing.assert_allclose(ours.numpy(), want, atol=1e-6)
    # the warp samples the resized grid: on the same grid it is JAX's
    src = rng.randn(2, 256, 256, 3).astype(np.float32)
    np.testing.assert_allclose(nhwc(TF.warp_image(nchw(src), torch.from_numpy(deform))),
                               JF.grid_sample_bilinear(src, ours.numpy()), atol=1e-5)


def test_layernorm2d_adain_and_mapping_net_match_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 8, 8, 4) * 3 + 1).astype(np.float32)
    z = rng.randn(2, 16).astype(np.float32)
    ln = JG.LayerNorm2d(4)
    p = {"weight": rng.randn(4).astype(np.float32), "bias": rng.randn(4).astype(np.float32)}
    t_ln = TG.LayerNorm2d(4)
    t_ln.load_state_dict({k: torch.from_numpy(v.reshape(-1, 1, 1)) for k, v in p.items()})
    np.testing.assert_allclose(nhwc(t_ln(nchw(x))), ln.apply({"params": p}, x), atol=1e-5)

    ad = JG.ADAIN(4)
    pa = jax.jit(ad.init)(jax.random.PRNGKey(3), x, z)["params"]
    t_ad = TG.ADAIN(4, 16)
    sd = {}
    for nm, key in (("mlp_shared", "mlp_shared.0"), ("mlp_gamma", "mlp_gamma"),
                    ("mlp_beta", "mlp_beta")):
        sd[f"{key}.weight"] = np.asarray(pa[nm]["kernel"]).T
        sd[f"{key}.bias"] = np.asarray(pa[nm]["bias"])
    t_ad.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(nhwc(t_ad(nchw(x), torch.from_numpy(z))),
                               ad.apply({"params": pa}, x, z), atol=1e-5)

    mn = JG.MappingNet(flame_coeff_nc=56, coeff_nc=73, descriptor_nc=64, layer=3)
    coeffs = rng.randn(3, 56, WIN).astype(np.float32)
    pm = jax.jit(mn.init)(jax.random.PRNGKey(4), coeffs)["params"]
    t_mn = TG.MappingNet(56, 73, 64, 3)
    sd = {"pre.weight": np.asarray(pm["pre"]["kernel"]).transpose(2, 1, 0),
          "pre.bias": pm["pre"]["bias"],
          "first.0.weight": np.asarray(pm["first"]["kernel"]).transpose(2, 1, 0),
          "first.0.bias": pm["first"]["bias"]}
    for i in range(3):
        sd[f"encoder{i}.1.weight"] = np.asarray(pm[f"encoder{i}"]["kernel"]).transpose(2, 1, 0)
        sd[f"encoder{i}.1.bias"] = pm[f"encoder{i}"]["bias"]
    t_mn.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, strict=True)
    np.testing.assert_allclose(t_mn(torch.from_numpy(coeffs)).detach().numpy(),
                               mn.apply({"params": pm}, coeffs), atol=1e-5)
    short = coeffs[:, :, :24]
    msg = "MappingNet window length 24 < 25"
    with pytest.raises(AssertionError, match=msg):
        mn.apply({"params": pm}, short)
    with pytest.raises(ValueError, match=msg):
        t_mn(torch.from_numpy(short))


def test_face_generator_matches_jax_and_the_bridge_matches_its_exporter(small):
    jm, params, model = small
    img, drv = _inputs(seed=5)
    want = _jit_apply(jm)(params, img, drv)
    with torch.no_grad():
        got = model(nchw(img), torch.from_numpy(drv))
    for k in ("flow_field", "warp_image", "fake_image"):
        np.testing.assert_allclose(nhwc(got[k]), want[k], atol=1e-4, err_msg=k)
    with torch.no_grad():
        warp_only = model(nchw(img), torch.from_numpy(drv), stage="warp")
    assert set(warp_only) == {"flow_field", "warp_image"}
    assert got["flow_field"].shape == (2, 2, RES // 4, RES // 4)
    ours = jax_face_generator_to_state_dict(params)
    ref = flax_face_generator_to_torch(params, mapping_layers=2)
    assert set(ours) == set(ref) == set(model.state_dict())
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32 and np.array_equal(ours[k].numpy(), v), k
        assert torch.equal(ours[k], model.state_dict()[k]), k


def _spectral_sites(model):
    return {k[:-len(".weight_orig")] for k in model.state_dict() if k.endswith(".weight_orig")}


def test_spectral_norm_triplets_load_strictly_and_render_as_jax_imports_them(small):
    """A state_dict with ``weight_orig`` / ``weight_u`` / ``weight_v`` at the
    twelve sites loads strictly and renders ``W / (u^T W v)``. JAX's importer
    resolves a Conv2d triplet the same way; on a ConvTranspose2d, whose
    spectral norm torch takes over dim 1 (the output channels), it takes
    ``u @ W.reshape(W.shape[0], -1) @ v`` over dim 0 and fails
    (render/import_torch.py:61-70), so those sites reach JAX resolved here."""
    jm, params, small_model = small
    plain = small_model.state_dict()
    torch.manual_seed(6)
    spect = TG.FaceGenerator(**SMALL, use_spect=True)
    sites = _spectral_sites(spect)
    # the twelve kinds of site, 42 convs at this depth
    assert len(sites) == 42 and {s.split(".")[-1] for s in sites} == {
        "conv_0", "conv_1", "conv_s", "conv1", "conv2", "0"}
    sd = dict(spect.state_dict())
    for k, v in plain.items():
        site = k[:-len(".weight")]
        sd[f"{site}.weight_orig" if site in sites and k.endswith(".weight") else k] = v
    spect.load_state_dict(sd, strict=True)
    spect.train()
    with torch.no_grad():  # three power-iteration steps give u and v something to say
        for _ in range(3):
            spect(nchw(_inputs(1)[0]), torch.from_numpy(_inputs(1)[1]))
    spect.eval()
    triplets = {k: v.clone() for k, v in spect.state_dict().items()}
    model = TG.face_generator_from_state_dict(triplets).eval()
    assert _spectral_sites(model) == sites
    img, drv = _inputs(seed=7)
    with torch.no_grad():
        got = model(nchw(img), torch.from_numpy(drv))

    with pytest.raises(ValueError):
        torch_face_generator_to_flax(triplets, mapping_layers=2)
    resolved = dict(triplets)
    for site in sites:
        mod = model.get_submodule(site)
        if isinstance(mod, torch.nn.ConvTranspose2d):
            w = resolved.pop(f"{site}.weight_orig")
            u, v = resolved.pop(f"{site}.weight_u"), resolved.pop(f"{site}.weight_v")
            sigma = u @ w.transpose(0, 1).reshape(w.shape[1], -1) @ v
            resolved[f"{site}.weight"] = w / sigma
    want = _jit_apply(jm)(torch_face_generator_to_flax(resolved, mapping_layers=2), img, drv)
    for k in ("flow_field", "warp_image", "fake_image"):
        np.testing.assert_allclose(nhwc(got[k]), want[k], atol=1e-4, err_msg=k)


def test_mixed_bf16_config_matches_jax_mixed(small):
    """``dtype=bf16, warp_dtype=fp32``: the mapping and editing nets in bf16,
    the warp in fp32, norm statistics in fp32, on both sides. Their bf16
    roundings differ, so the bound is stated: the port's mixed output within
    0.1 of JAX's mixed output (max) and 0.01 (mean) on every output, where
    JAX's own mixed config moves up to 0.13 from fp32 on these random-noise
    sources."""
    jm, params, model = small
    jmix = JG.FaceGenerator(**SMALL, dtype=jnp.bfloat16, warp_dtype=jnp.float32)
    mixed = TG.FaceGenerator(**SMALL, dtype=torch.bfloat16, warp_dtype=torch.float32)
    mixed.load_state_dict(model.state_dict(), strict=True)
    img, drv = _inputs(seed=8)
    want = _jit_apply(jmix)(params, img, drv)
    with torch.no_grad():
        got = mixed.eval()(nchw(img), torch.from_numpy(drv))
    assert got["fake_image"].dtype == torch.bfloat16
    assert got["flow_field"].dtype == got["warp_image"].dtype == torch.float32
    for k in ("flow_field", "warp_image", "fake_image"):
        err = np.abs(nhwc(got[k]) - np.asarray(want[k], np.float32))
        assert err.max() <= 0.1 and err.mean() <= 0.01, (k, err.max(), err.mean())


def _coeff_dir(root, t, seed):
    rng = np.random.RandomState(seed)
    for i in range(t):
        d = os.path.join(root, f"{i:06d}")
        os.makedirs(d)
        np.save(os.path.join(d, "pose.npy"), rng.randn(6).astype(np.float32) * 0.1)
        np.save(os.path.join(d, "exp.npy"), rng.randn(50).astype(np.float32) * 0.3)
    return root


def test_inference_helpers_match_jax(small, tmp_path, monkeypatch):
    jm, params, model = small
    rng = np.random.RandomState(9)
    src = rng.uniform(-1, 1, (RES, RES, 3)).astype(np.float32)
    coeffs = rng.randn(8, 56).astype(np.float32)  # windows clamped at both ends
    want = JI.render_clip(jm, params, src, coeffs, semantic_radius=13, batch_size=4)
    got = TI.render_clip(model, src, coeffs, semantic_radius=13, batch_size=4)
    windows = rng.randn(11, 56, WIN).astype(np.float32)  # 11 = 4 + 4 + 3: a short block
    want_w = JI.render_windows(jm, params, src, windows, batch_size=4)
    got_w = TI.render_windows(model, src, windows, batch_size=4)
    for k in ("fake_image", "warp_image"):
        assert got[k].shape == (8, RES, RES, 3) and got_w[k].shape == (11, RES, RES, 3)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
        np.testing.assert_allclose(got_w[k], want_w[k], atol=1e-4, err_msg=k)

    clip = _coeff_dir(str(tmp_path / "clip"), 5, 10)
    want = JI.render_coeff_dir(jm, params, src, clip, str(tmp_path / "jax"))
    got = TI.render_coeff_dir(model, src, clip, str(tmp_path / "port"))
    for kind in ("fake", "warp"):
        np.testing.assert_allclose(got[f"{kind}_image"], want[f"{kind}_image"], atol=1e-4)
        names = sorted(os.listdir(tmp_path / "jax" / kind))
        assert names == sorted(os.listdir(tmp_path / "port" / kind)) and len(names) == 5
        for n in names:
            a = read_png(str(tmp_path / "port" / kind / n)).astype(int)
            b = read_png(str(tmp_path / "jax" / kind / n)).astype(int)
            assert np.abs(a - b).max() <= 1, (kind, n)

    monkeypatch.setitem(sys.modules, "cv2", None)  # both write the PNG directory
    videos = [rng.uniform(-1.2, 1.2, (3, 8, 6, 3)).astype(np.float32) for _ in range(3)]
    a = JI.write_reenactment_video(str(tmp_path / "jax_video"), *videos)
    b = TI.write_reenactment_video(str(tmp_path / "port_video"), *videos)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == [f"{i:05d}.png" for i in range(3)]
    for n in os.listdir(a):
        frame = read_png(os.path.join(b, n))
        assert frame.shape == (8, 18, 3)
        np.testing.assert_array_equal(frame, read_png(os.path.join(a, n)))
