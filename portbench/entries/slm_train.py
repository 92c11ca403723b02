"""SLM pretraining: ``engine/pt_engine.make_slm_train_step`` on the SLM of
the configuration, AdamW over the trainable parameters (``SLM_FROZEN``
frozen), global-norm clipping, bf16 autocast over fp32 parameters, the two
frozen VQ encoders tokenizing every step. Each batch carries its own
masking noise, made by the benchmark and handed to both sides."""

from __future__ import annotations

import torch

from ..harness import traffic, weights
from .training import CHECKED_STEPS, TrainSession, leaf_norms

LOSS_LOGS = ("l_ce_s", "l_ce_l", "l_cont_s", "l_cont_l", "nce")


class Session(TrainSession):
    def __init__(self, ctx):
        super().__init__(ctx)
        from dyadic_interaction_modeling_tpu_torch.config import CfgNode
        from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slm_train_step
        from dyadic_interaction_modeling_tpu_torch.engine.train_state import make_optimizer
        from dyadic_interaction_modeling_tpu_torch.models.slm import SLM, SLM_FROZEN

        dev, tr, cfg = ctx.device, ctx.traffic, ctx.config
        with torch.device(dev):
            self.model = SLM(CfgNode(cfg["slm"]), CfgNode(cfg["vq"]))
        g = traffic.generator(ctx.seed, 0, dev)
        params = weights.seeded_params(self.model, g, torch.float32)
        weights.load(self.model, params)
        self.W0 = {k: v.detach().clone() for k, v in params.items()}
        self.opt = make_optimizer(self.model, tr["lr"], tr["weight_decay"], SLM_FROZEN)
        self.trainable = [k for k, p in self.model.named_parameters() if p.requires_grad]
        amp = cfg["precision"]["train_autocast"]
        self.train_step = make_slm_train_step(self.model, self.opt, tr["clip_norm"],
                                              amp and getattr(torch, amp))
        g = traffic.generator(ctx.seed, 1, dev)
        self.batches = []
        for _ in range(tr["batches"]):
            batch = traffic.dyadic_clips(g, tr["clips"], tr["frames"], dev)
            noise = tuple(torch.rand(tr["clips"], tr["frames"], generator=g, device=dev)
                          for _ in range(2))
            self.batches.append((batch, noise))

    def _loss(self, logs):
        return sum(logs[k] for k in LOSS_LOGS), {k: logs[k] for k in LOSS_LOGS}

    def _step(self, i: int):
        (speaker, listener, audio, mask), noise = self.batches[i]
        return self.train_step((speaker, listener, audio, mask), noise=noise)

    def reference_readings(self, prec: str = "fp32", half: bool = False) -> dict:
        from ..reference import common, slm_vico as R

        common.fp32_matmuls()
        cfg, tr = self.ctx.config, self.ctx.traffic
        P = common.Prec(prec)

        def loss(W, item):
            (speaker, listener, audio, mask), noise = item
            batch, noise = (speaker, listener, audio, mask), noise
            if half:  # a planted fault: the mean over half of the batch
                n = speaker.shape[0] // 2
                batch, noise = tuple(x[:n] for x in batch), tuple(x[:n] for x in noise)
            return R.slm_loss(P, W, cfg["slm"], cfg["vq"], batch, noise)

        losses, parts, first, final = common.train_steps(
            loss, self.W0, R.trainable(self.W0), self.batches[:CHECKED_STEPS], tr["lr"],
            tr["weight_decay"], tr["clip_norm"])
        return {"losses": losses, "parts": parts, "grad": leaf_norms(first),
                "change": leaf_norms({k: final[k] - self.W0[k] for k in final})}
