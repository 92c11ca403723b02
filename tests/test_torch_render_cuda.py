"""PIRender on the card at full width: the FaceGenerator's inference against
the CPU and its mixed-precision config against fp32, and the FaceTrainer's
two stages against the CPU, with TF32 as the control that must fail; then
the ``render_train`` twin and ``render_inference`` on its checkpoint. None
of K1-K4 runs on these paths.

Marked ``cuda`` (skipped where no card is present). On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_render_cuda.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from torch_card import (RENDER_B, RENDER_RADIUS, RENDER_RES, RENDER_T, card,  # noqa: F401
                        counted, launches, render_inputs, render_weights)

pytestmark = pytest.mark.cuda

# the mixed config (mapping and editing nets in bf16, the warp in fp32)
# against fp32 on the card: max abs on each output, and mean abs on the fake
# image (images in [-1, 1], flow in pixels of the H/4 grid)
RENDER_MIXED_BOUND = {"flow_field": 0.02, "warp_image": 0.02, "fake_image": 0.1}
RENDER_MIXED_MEAN_BOUND = 0.01


def test_render_clip_matches_the_cpu_and_mixed_precision(card):
    """``render_clip`` of RENDER_T frames in windows of radius 13, batch 8,
    fp32 with TF32 off, launching no K1-K4; its first batch against the same
    weights on the CPU (flow, warp and fake within 1e-3 of each output's
    largest magnitude); the mixed config (bf16 mapping and editing nets,
    fp32 warp) against the card's fp32 output within RENDER_MIXED_BOUND."""
    from dyadic_interaction_modeling_tpu_torch.render.data import semantic_window
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.inference import render_clip

    sd = render_weights()
    model = FaceGenerator(flame_coeff_nc=56, coeff_nc=73).eval()
    model.load_state_dict(sd, strict=True)
    src8, coeffs = render_inputs()
    src = src8.astype(np.float32) / 127.5 - 1.0
    windows = torch.from_numpy(np.stack([semantic_window(coeffs, i, RENDER_RADIUS)
                                         for i in range(RENDER_B)]))
    img = torch.from_numpy(src).permute(2, 0, 1)[None].expand(RENDER_B, -1, -1, -1)
    with torch.inference_mode():
        cpu = model(img, windows)
    model = model.to("cuda")
    batch = (img.to("cuda"), windows.to("cuda"))
    with counted() as got:
        clip = render_clip(model, src, coeffs, RENDER_RADIUS, batch_size=RENDER_B)
    assert got == launches()
    assert clip["fake_image"].shape == (RENDER_T, RENDER_RES, RENDER_RES, 3)
    assert bool(np.isfinite(clip["fake_image"]).all())
    with torch.inference_mode():
        out = model(*batch)
    for k in ("flow_field", "warp_image", "fake_image"):
        err = float((out[k].cpu() - cpu[k]).abs().max() / cpu[k].abs().max())
        assert err <= 1e-3, (k, err)
    first = np.abs(clip["fake_image"][:RENDER_B] - cpu["fake_image"].permute(0, 2, 3, 1).numpy())
    assert float(first.max()) <= 1e-3
    del model

    outs = {}
    for name, dtype, warp_dtype in (("fp32", torch.float32, None),
                                    ("mixed", torch.bfloat16, torch.float32)):
        m = FaceGenerator(flame_coeff_nc=56, coeff_nc=73, dtype=dtype,
                          warp_dtype=warp_dtype).to("cuda").eval()
        m.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            outs[name] = {k: v.float() for k, v in m(*batch).items()}
    for k, bound in RENDER_MIXED_BOUND.items():
        d = (outs["mixed"][k] - outs["fp32"][k]).abs()
        assert float(d.max()) <= bound, (k, float(d.max()))
        if k == "fake_image":
            assert float(d.mean()) <= RENDER_MIXED_MEAN_BOUND, float(d.mean())


RT_PAIRS, RT_LR, RT_COEFF = 4, 1e-4, 58
# the card against the CPU, fp32 with TF32 off, a step of each stage from the
# same weights. The warp's bilinear sampling has a gradient that jumps where
# a sampling point crosses a pixel edge, so a step's gradients move with the
# flow's last digits: the CPU's own gradients, with every weight changed by
# 1e-6 of itself, move about as far as the card's do (RT_SENSITIVITY_EPS);
# the card is held within RT_GRAD_FACTOR times that, in the largest error
# and in relative L2. A fresh Adam's step is lr times the sign of each
# gradient, so the two sides' updates differ by 2 lr where a near-zero
# gradient's sign differs and by rounding elsewhere: the share of the
# stepped elements whose updates differ by more than RT_PARAM_WITHIN is held
# within RT_GRAD_FACTOR times the CPU's own share after the same change of
# the weights. The control: the gen step on the card with TF32 on must fail
# both holds
RT_LOSS_TOL, RT_SENSITIVITY_EPS, RT_GRAD_FACTOR = 1e-4, 1e-6, 2.0
RT_PARAM_WITHIN = 1e-8


def _rt_batch(pairs, seed):
    """``pairs`` source / target pairs at 256 x 256 (smooth images, as
    ``render_inputs``) with 58-d windows of radius 13, a numpy batch."""
    g = torch.Generator().manual_seed(seed)
    imgs = torch.nn.functional.interpolate(torch.rand(2 * pairs, 3, 16, 16, generator=g) * 2 - 1,
                                           size=(RENDER_RES, RENDER_RES), mode="bilinear",
                                           align_corners=False)
    imgs = imgs.permute(0, 2, 3, 1).contiguous().numpy()
    rng = np.random.default_rng(seed)
    sem = rng.normal(0, 0.3, (2 * pairs, RT_COEFF, 2 * RENDER_RADIUS + 1)).astype(np.float32)
    return {"source_image": imgs[:pairs], "target_image": imgs[pairs:],
            "source_semantics": sem[:pairs], "target_semantics": sem[pairs:]}


def _grad_distance(got, want):
    """(largest error / largest gradient, relative L2 error) between two
    lists of (name, gradient)."""
    largest = max(float(g.abs().max()) for _, g in want)
    worst = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(got, want))
    l2 = float(torch.cat([(a - b).flatten() for (_, a), (_, b) in zip(got, want)]).norm()
               / torch.cat([b.flatten() for _, b in want]).norm())
    return worst / largest, l2


def _rt_grads(trainer):
    return [(n, p.grad.cpu()) for n, p in trainer.net.named_parameters() if p.grad is not None]


def _rt_update(trainer, start, grads):
    """What a step added to each parameter that it had a gradient for."""
    sd = trainer.net.state_dict()
    return {n: sd[n].cpu() - start[n] for n, _ in grads}


def _update_off(got, want):
    """The share of the elements whose updates differ by more than
    RT_PARAM_WITHIN."""
    d = torch.cat([(got[n] - v).abs().flatten() for n, v in want.items()])
    return float((d > RT_PARAM_WITHIN).float().mean())


def _rt_trainer(sd, vgg, device, pretrain, save_dir):
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.trainer import FaceTrainer

    model = FaceGenerator(flame_coeff_nc=RT_COEFF, coeff_nc=73).to(device)
    model.load_state_dict(sd, strict=True)
    return FaceTrainer(model, pretrain_warp_iteration=pretrain, vgg_state_dict=vgg,
                       base_lr=RT_LR, save_dir=str(save_dir))


def _rt_weights():
    """The generator at 58-d coefficients and VGG19 at a seeded random init."""
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator
    from dyadic_interaction_modeling_tpu_torch.render.perceptual import make_trunk
    from dyadic_interaction_modeling_tpu_torch.render.trainer import LAYERS

    torch.manual_seed(71)
    sd = {k: v.clone() for k, v in FaceGenerator(flame_coeff_nc=RT_COEFF,
                                                  coeff_nc=73).state_dict().items()}
    torch.manual_seed(72)
    vgg = {k: v.clone() for k, v in make_trunk("vgg19", LAYERS).state_dict().items()}
    return sd, vgg


def test_render_training_steps_match_the_cpu(card, tmp_path):
    """A warp step, then a gen step, of 1 pair on the CPU and on the card
    from the same weights (the card's generator takes the CPU's before the
    gen step, whose fresh Adam leaves nothing else behind), no K1-K4 on the
    card: losses within RT_LOSS_TOL, gradients and updates held as RT_* says;
    then the control, the gen step with TF32 on, must fail both holds."""
    sd, vgg = _rt_weights()
    cpu = _rt_trainer(sd, vgg, "cpu", 1, tmp_path / "cpu")
    gpu = _rt_trainer(sd, vgg, "cuda", 1, tmp_path / "card")
    for i, stage in enumerate(("warp", "gen")):
        batch = _rt_batch(1, 80 + i)
        start = {k: v.clone() for k, v in cpu.net.state_dict().items()}
        gpu.net.load_state_dict(start)
        lc = cpu.optimize_parameters(batch)
        with counted() as got:
            lg = gpu.optimize_parameters(batch)
        assert got == launches()
        rel = {k: abs(lg[k] - v) / abs(v) for k, v in lc.items()}
        assert sorted(lg) == sorted(lc) and max(rel.values()) <= RT_LOSS_TOL, (stage, rel)
        gc, gg = _rt_grads(cpu), _rt_grads(gpu)
        assert [n for n, _ in gc] == [n for n, _ in gg]
        gerr, l2 = _grad_distance(gg, gc)
        # the CPU's own step after every weight moved by RT_SENSITIVITY_EPS of itself
        g = torch.Generator().manual_seed(5)
        moved = {k: v * (1 + RT_SENSITIVITY_EPS * torch.randn(v.shape, generator=g))
                 if v.is_floating_point() else v for k, v in start.items()}
        own = _rt_trainer(moved, vgg, "cpu", i ^ 1, tmp_path / "s")
        own.optimize_parameters(batch)
        s_grads = _rt_grads(own)
        s_max, s_l2 = _grad_distance(s_grads, gc)
        assert gerr <= RT_GRAD_FACTOR * s_max and l2 <= RT_GRAD_FACTOR * s_l2, (
            stage, gerr, s_max, l2, s_l2)
        uc = _rt_update(cpu, start, gc)
        s_off = _update_off(_rt_update(own, moved, s_grads), uc)
        off = _update_off(_rt_update(gpu, start, gc), uc)
        assert off <= RT_GRAD_FACTOR * s_off, (stage, off, s_off)
        if stage == "gen":  # the control: TF32 on fails both holds
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctl = _rt_trainer(start, vgg, "cuda", 0, tmp_path / "ctl")
                ctl.optimize_parameters(batch)
            finally:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            c_max, c_l2 = _grad_distance(_rt_grads(ctl), gc)
            c_off = _update_off(_rt_update(ctl, start, gc), uc)
            assert c_max > RT_GRAD_FACTOR * s_max or c_l2 > RT_GRAD_FACTOR * s_l2, (c_max, c_l2)
            assert c_off > RT_GRAD_FACTOR * s_off, (c_off, s_off)


@pytest.mark.parametrize("tf32", [False, True])
def test_render_training_stages_at_four_pairs(card, tmp_path, tf32):
    """Each stage's step at RT_PAIRS pairs (8 images after the symmetric
    concat), fp32 with TF32 off and on, launching no K1-K4."""
    sd, vgg = _rt_weights()
    batch_np = _rt_batch(RT_PAIRS, 90)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    for stage, pretrain in (("warp", 10 ** 9), ("gen", 0)):
        trainer = _rt_trainer(sd, vgg, "cuda", pretrain, tmp_path / stage)
        batch = trainer.upload(batch_np)
        with counted() as got:
            losses = trainer.optimize_parameters(batch)
        assert got == launches(), stage
        assert all(v == v and abs(v) != float("inf") for v in losses.values()), losses


def test_render_train_twin(card, tmp_path):
    """``cli.render_train --synthetic --resolution 256 --debug 3`` (3 steps,
    ``step_3.pt``) and ``cli.render_inference`` reading that checkpoint (6
    finite frames), neither launching K1-K4."""
    from dyadic_interaction_modeling_tpu_torch.cli import render_inference, render_train

    with counted() as got:
        trainer = render_train.main([
            "--synthetic", "--resolution", str(RENDER_RES), "--coeff-nc", "56", "--debug", "3",
            "--device", "cuda", "--save-path", str(tmp_path / "twin")])
    assert got == launches()
    assert trainer.iteration == 3 and os.path.exists(tmp_path / "twin" / "step_3.pt")
    with counted() as got:
        out = render_inference.main([
            "--synthetic", "--checkpoint", str(tmp_path / "twin" / "step_3.pt"), "--out",
            str(tmp_path / "frames"), "--resolution", str(RENDER_RES), "--device", "cuda"])
    assert got == launches()
    n = len(os.listdir(tmp_path / "frames" / "fake"))
    assert n == 6 and bool(np.isfinite(out["fake_image"]).all())
