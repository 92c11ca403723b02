"""PIRender's trainer (reference ``Pirender/trainers/face_trainer.py``,
``trainers/base.py``, ``util/trainer.py``), on the card by default.

Counterpart of ``dyadic_interaction_modeling_tpu/render/trainer.py``:

* the symmetric batch: each step renders source -> target and target ->
  source (face_trainer.py:56-62);
* two stages: the warp-only perceptual loss until ``pretrain_warp_iteration``,
  then warp (x2.5) + final (x4, style 250) losses with a fresh optimizer
  (face_trainer.py:91-100);
* Adam (betas 0.5 / 0.999) under the step LR (config/face.yaml:17-26: step
  300k, gamma 0.2), whose count restarts with every fresh optimizer (at the
  stage switch and on ``load_latest``), as optax's count lives in its state;
* the EMA generator, decay 0.5 ** (32 / 10000), after each step
  (face_trainer.py:24-26, util/trainer.py:12-16);
* checkpoints with a ``latest_checkpoint.txt`` pointer and resume
  (trainers/base.py:200-286), snapshot image grids, and the 2-hour
  wall-clock limit (train.py:90-110).

Checkpoints are reference-layout ``.pt`` files, ``{"net_G", "net_G_ema",
"meta"}``, which ``cli.render_inference --checkpoint`` reads; the JAX
package writes orbax directories. The two perceptual losses share one
trunk (JAX's share one set of params). A batch (the datasets' numpy dicts,
images (B, H, W, 3)) is uploaded once and its images permuted to NCHW.

A generator with spectral norm (``use_spect``) is refused: the JAX trainer
keeps only ``params`` (``render/trainer.py:66``), so the spectral norm's
state is dropped and its first step fails (``InvalidRngError:
SpectralNorm_0 needs PRNG for "params"``); the port adds no feature the
JAX package lacks (ROADMAP.md, queue 3).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..utils.logging import get_logger, main_process
from ..utils.observability import run_writer
from .generator import FaceGenerator
from .perceptual import PerceptualLoss, make_trunk

EMA_DECAY = 0.5 ** (32 / (10 * 1000))
LAYERS = ("relu_1_1", "relu_2_1", "relu_3_1", "relu_4_1", "relu_5_1")


@torch.no_grad()
def ema_update(ema: torch.nn.Module, model: torch.nn.Module, decay: float = EMA_DECAY) -> None:
    """util/trainer.accumulate: ema = decay * ema + (1 - decay) * params."""
    e = list(ema.parameters())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, list(model.parameters()), alpha=1.0 - decay)


def make_lr_schedule(base_lr: float = 1e-4, step_size: int = 300_000,
                     gamma: float = 0.2) -> Callable[[int], float]:
    """count -> learning rate, the step policy."""
    return lambda count: base_lr * gamma ** (count // step_size)


class DeviceBatch(dict):
    """A batch on the trainer's device, images NCHW (``FaceTrainer.upload``)."""


class FaceTrainer:
    """Two-stage generator trainer over ``model`` (on its device)."""

    def __init__(self, model: FaceGenerator, *,
                 pretrain_warp_iteration: int = 1,
                 weight_perceptual_warp: float = 2.5,
                 weight_perceptual_final: float = 4.0,
                 base_lr: float = 1e-4,
                 lr_step: int = 300_000,
                 lr_gamma: float = 0.2,
                 vgg_state_dict: Optional[Mapping] = None,
                 perceptual_network: str = "vgg19",
                 save_dir: str = "./runs_pirender",
                 max_seconds: float = 2 * 3600,
                 logger=None):
        if any(name.endswith("weight_orig") for name, _ in model.named_parameters()):
            raise ValueError(
                "FaceTrainer cannot train a use_spect generator: the JAX package's "
                "FaceTrainer keeps only params and drops the spectral norm's state "
                "(render/trainer.py:66), so its first step fails with InvalidRngError "
                "(SpectralNorm_0 needs PRNG for \"params\"); see ROADMAP.md, queue 3")
        self.net = model
        self.model = model  # what a step calls: the net, or DDP around it (shard_with)
        self.device = next(model.parameters()).device
        self.ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.pretrain_warp_iteration = pretrain_warp_iteration
        self.weights = {"warp": weight_perceptual_warp, "final": weight_perceptual_final}
        self.base_lr, self.lr_step, self.lr_gamma = base_lr, lr_step, lr_gamma
        self.iteration = 0
        self.epoch = 0
        self.save_dir = save_dir
        self.max_seconds = max_seconds
        self.logger = logger or get_logger()
        trunk = (make_trunk(perceptual_network, LAYERS, vgg_state_dict).to(self.device)
                 if perceptual_network != "l1" else None)
        self.perc_warp = PerceptualLoss(LAYERS, num_scales=4, network=perceptual_network,
                                        trunk=trunk)
        self.perc_final = PerceptualLoss(LAYERS, num_scales=4, use_style_loss=True,
                                         weight_style_to_perceptual=250.0,
                                         network=perceptual_network, trunk=trunk)
        self.plan = None
        self._init_optimizer()
        hparams = dict(pretrain_warp_iteration=pretrain_warp_iteration,
                       weight_perceptual_warp=weight_perceptual_warp,
                       weight_perceptual_final=weight_perceptual_final,
                       base_lr=base_lr, lr_step=lr_step, lr_gamma=lr_gamma,
                       perceptual_network=perceptual_network)
        # tensorboardX-equivalent run record (util/meters.py:103), rank 0 only
        self.writer = run_writer(os.path.join(save_dir, "logs"), hparams)

    def _init_optimizer(self) -> None:
        """A fresh Adam and a fresh LR count (optax re-``init``)."""
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=self.base_lr,
                                          betas=(0.5, 0.999), eps=1e-8)
        # the step policy's factor: the schedule at base lr 1
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, make_lr_schedule(1.0, self.lr_step, self.lr_gamma))

    def shard_with(self, plan) -> None:
        """Data-parallel training over ``plan`` (``parallel.MeshPlan``):
        DDP around the generator, each rank stepping its slice of the
        batch, the reference's DDP wrap (Pirender/util/trainer.py:71-78).
        Call after ``load_latest``."""
        if plan.layout != "dp":
            raise ValueError("render trainer supports data-parallel --mesh layouts only "
                             "(the 23M-param generator gains nothing from param sharding)")
        self.plan = plan
        self.model = plan.shard_state(self.net)
        self._init_optimizer()

    def training_stage(self) -> str:
        return "gen" if self.iteration >= self.pretrain_warp_iteration else "warp"

    def upload(self, data: Mapping[str, np.ndarray]) -> DeviceBatch:
        """A numpy batch (images (B, H, W, 3)) on the trainer's device, the
        images permuted to NCHW; an uploaded batch passes through."""
        if isinstance(data, DeviceBatch):
            return data
        out = DeviceBatch()
        for k, v in data.items():
            t = torch.as_tensor(v, device=self.device)
            out[k] = t.permute(0, 3, 1, 2).contiguous() if k.endswith("_image") else t
        return out

    def _losses(self, stage: str, input_image, input_semantic, gt_image):
        out = self.model(input_image, input_semantic, stage)
        losses = {"perceptual_warp": self.weights["warp"] * self.perc_warp(
            out["warp_image"], gt_image)}
        if stage != "warp":
            losses["perceptual_final"] = self.weights["final"] * self.perc_final(
                out["fake_image"], gt_image)
        losses["total_loss"] = sum(losses.values())
        return losses

    def optimize_parameters(self, data) -> Dict[str, float]:
        """One step on a batch (numpy, or ``upload``ed) of source / target
        images and their (B, C, T) windows, in both directions."""
        if self.iteration == self.pretrain_warp_iteration:
            self._init_optimizer()  # stage switch: fresh optimizer (face_trainer.py:97-100)
        stage = self.training_stage()
        d = self.upload(data)
        input_image = torch.cat([d["source_image"], d["target_image"]], 0)
        input_semantic = torch.cat([d["target_semantics"], d["source_semantics"]], 0)
        gt_image = torch.cat([d["target_image"], d["source_image"]], 0)
        self.net.train()
        losses = self._losses(stage, input_image, input_semantic, gt_image)
        self.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        self.optimizer.step()
        self.scheduler.step()
        ema_update(self.ema, self.net)
        self.iteration += 1
        names = list(losses)
        values = torch.stack([losses[k].detach() for k in names])
        if self.plan is not None:  # the logged losses are the global batch's
            torch.distributed.all_reduce(values)
            values = values / torch.distributed.get_world_size()
        return dict(zip(names, values.tolist()))

    # --- checkpoints (trainers/base.py:200-286, 672)

    def save(self) -> Optional[str]:
        """``step_{iteration}.pt`` and the ``latest_checkpoint.txt`` pointer
        (rank 0 only); returns the path."""
        if not main_process():
            return None
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"step_{self.iteration}.pt")
        torch.save({"net_G": self.net.state_dict(), "net_G_ema": self.ema.state_dict(),
                    "meta": {"epoch": self.epoch, "iteration": self.iteration}}, path)
        with open(os.path.join(self.save_dir, "latest_checkpoint.txt"), "w") as f:
            f.write(os.path.basename(path))
        return path

    def load_latest(self) -> bool:
        pointer = os.path.join(self.save_dir, "latest_checkpoint.txt")
        if not os.path.exists(pointer):
            return False
        with open(pointer) as f:
            name = f.read().strip()
        payload = torch.load(os.path.join(self.save_dir, name), map_location=self.device,
                             weights_only=True)
        self.net.load_state_dict(payload["net_G"], strict=True)
        self.ema.load_state_dict(payload["net_G_ema"], strict=True)
        meta = payload.get("meta", {})
        self.epoch = int(meta.get("epoch", 0))
        self.iteration = int(meta.get("iteration", 0))
        self._init_optimizer()
        return True

    @torch.no_grad()
    def ema_forward(self, data) -> Dict[str, torch.Tensor]:
        d = self.upload(data)
        return self.ema(d["source_image"], d["target_semantics"])

    def save_image_grid(self, data) -> Optional[str]:
        """A snapshot of [source, warp, fake, target] rows from the EMA
        generator (trainers/base.py:95-145 image grids); rank 0 only."""
        if not main_process():
            return None
        out = self.ema_forward(data)

        def nhwc(t):
            return t.float().permute(0, 2, 3, 1).cpu().numpy()

        d = self.upload(data)
        rows = [nhwc(d["source_image"]), nhwc(out["warp_image"]),
                nhwc(out.get("fake_image", out["warp_image"])), nhwc(d["target_image"])]
        return self.writer.add_image_grid("visualization", rows, self.iteration,
                                          nrow=int(rows[0].shape[0]))

    def test_everything(self, loader, iterations: int = 30) -> Dict[str, float]:
        """The debug harness (trainers/base.py:147-166): ``iterations``
        steps, then the image grid, a checkpoint and the LPIPS-style metric
        in one pass; returns the last losses and the metric."""
        from .metrics import PerceptualDistance

        self.logger.info("Start testing your functions")
        data, losses = None, {}
        it = iter(loader() if callable(loader) else loader)
        for _ in range(iterations):
            try:
                data = next(it)
            except StopIteration:
                it = iter(loader() if callable(loader) else loader)
                data = next(it)
            losses = self.optimize_parameters(data)
        assert data is not None, "empty loader"
        self.save_image_grid(data)
        self.save()
        d = self.upload(data)
        fake = self.ema_forward(d).get("fake_image", d["source_image"])
        metric = PerceptualDistance().to(self.device)(fake, d["target_image"])
        out = dict(losses)
        out["metric/perceptual_distance"] = float(metric.mean())
        self.writer.add_scalars(out, self.iteration)
        self.logger.info("End debugging: " + " ".join(f"{k} {v:.4f}" for k, v in out.items()))
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, loader: Iterable, max_epochs: int = 1, snapshot_iter: int = 625,
              logging_iter: int = 100, speed_benchmark: bool = False) -> None:
        """The epoch loop with the reference's 2-hour limit (train.py:90-110).
        ``loader``: an iterable, or a callable giving a fresh one an epoch.
        ``speed_benchmark`` (trainers/base.py:82-87, 330-358): the averages of
        data-load and step time (the card synchronized before the clock is
        read), logged and written at the logging cadence."""
        t0 = time.time()
        bench = {"data": 0.0, "step": 0.0, "n": 0}
        for epoch in range(self.epoch, max_epochs):
            self.epoch = epoch
            data_iter = iter(loader() if callable(loader) else loader)
            while True:
                td = time.time()
                try:
                    data = next(data_iter)
                except StopIteration:
                    break
                ts = time.time()
                losses = self.optimize_parameters(data)
                if speed_benchmark:
                    self._sync()
                    now = time.time()
                    bench["data"] += ts - td
                    bench["step"] += now - ts
                    bench["n"] += 1
                if self.iteration % logging_iter == 0:
                    msg = " ".join(f"{k} {v:.4f}" for k, v in losses.items())
                    self.logger.info(f"epoch {epoch} iter {self.iteration}: {msg}")
                    self.writer.add_scalars(losses, self.iteration)
                    if speed_benchmark and bench["n"]:
                        avg_d = bench["data"] / bench["n"] * 1e3
                        avg_s = bench["step"] / bench["n"] * 1e3
                        self.logger.info(f"speed: data {avg_d:.1f} ms step {avg_s:.1f} ms "
                                         f"({bench['n']} iters)")
                        self.writer.add_scalars({"time/data_ms": avg_d, "time/step_ms": avg_s},
                                                self.iteration)
                        bench = {"data": 0.0, "step": 0.0, "n": 0}
                if self.iteration % snapshot_iter == 0:
                    self.save()
                    self.save_image_grid(data)
                if time.time() - t0 > self.max_seconds:
                    self.logger.info("wall-clock limit reached; checkpointing")
                    self.save()
                    return
        self.save()
