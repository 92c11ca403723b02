"""Speaker VQ-VAE training: ``engine/vq_engine.make_vq_train_step(...,
audio_visual=True)`` on the configuration's ``VQSpeakerAutoEncoder``,
AdamW over every parameter, fp32 with TF32 off."""

from __future__ import annotations

import torch

from ..harness import traffic, weights
from .training import CHECKED_STEPS, TrainSession, leaf_norms


class Session(TrainSession):
    def __init__(self, ctx):
        super().__init__(ctx)
        from dyadic_interaction_modeling_tpu_torch.config import CfgNode
        from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
        from dyadic_interaction_modeling_tpu_torch.engine.vq_engine import make_vq_train_step
        from dyadic_interaction_modeling_tpu_torch.models.vq_vae import VQSpeakerAutoEncoder

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, tr, cfg = ctx.device, ctx.traffic, ctx.config
        with torch.device(dev):
            self.model = VQSpeakerAutoEncoder(CfgNode(cfg["vq"]))
        g = traffic.generator(ctx.seed, 0, dev)
        params = weights.seeded_params(self.model, g, torch.float32)
        weights.load(self.model, params)
        self.W0 = {k: v.detach().clone() for k, v in params.items()}
        self.opt = make_optimizer(self.model, tr["lr"], tr["weight_decay"])
        self.trainable = [k for k, _ in self.model.named_parameters()]
        self.train_step = make_vq_train_step(self.model, self.opt, audio_visual=True)
        g = traffic.generator(ctx.seed, 1, dev)
        self.batches = [traffic.av_clips(g, tr["clips"], tr["frames"], dev)
                        for _ in range(tr["batches"])]

    def _loss(self, logs):
        return logs["loss"], {k: logs[k] for k in ("rec_loss", "quant_loss")}

    def _step(self, i: int):
        return self.train_step(self.batches[i])

    def reference_readings(self, prec: str = "fp32", half: bool = False) -> dict:
        from ..reference import common, vq_speaker_av as R

        common.fp32_matmuls()
        cfg, tr = self.ctx.config, self.ctx.traffic
        P = common.Prec(prec)

        def loss(W, x, switch=()):
            if half:  # a planted fault: the mean over half of the batch's clips
                x = x[: max(1, x.shape[0] // 2)] if x.shape[0] > 1 else x[:, : x.shape[1] // 2]
            return R.loss(P, W, cfg["vq"], x, switch)

        trainable = R.trainable(self.W0)
        losses, parts, first, final = common.train_steps(
            loss, self.W0, trainable, self.batches[:CHECKED_STEPS], tr["lr"],
            tr["weight_decay"], tr["clip_norm"])
        alts = []  # the reference's own ties, where it stands as the reference
        ties = R.tie_alternatives(P, self.W0, cfg["vq"], self.batches[0]) \
            if prec == "fp32" and not half else []
        for switch in ties:
            l1, p1, g1 = common.first_step(lambda W, x: loss(W, x, switch), self.W0, trainable,
                                           self.batches[0], tr["clip_norm"])
            alts.append({"loss": l1, "parts": p1, "grad": leaf_norms(g1)})
        return {"losses": losses, "parts": parts, "grad": leaf_norms(first),
                "change": leaf_norms({k: final[k] - self.W0[k] for k in final}),
                "first_alternatives": alts}
