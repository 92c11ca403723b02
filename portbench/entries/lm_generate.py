"""Token generation from a context-free language model:
``engine/pt_engine.make_lm_generator``'s ``generate(prompt, rng, tokens)`` on
the configuration's DeepSeek-V2 decoder (``models/deepseek_v2.py``) in bf16:
one batched prefill of the prompts (MLA in its full form, the expert layers
as grouped GEMMs), then the token loop (``models/xtrans.generate_tokens``,
its decode steps replayed from a CUDA graph: absorbed MLA on K5, the expert
layers as grouped GEMMs with static shapes).

Weights are seeded on the card by the decoder's ``init_weights``, one
parameter after another in the model's order: matrices and the embedding
N(0, 0.006^2) (DeepSeek's ``initializer_range``), RMSNorm scales 1, the
router N(0, 1 / hidden) (the configuration's ``assumed``). Prompts are random ids, ``prompt_sets`` sets
drawn from the seed and cycled over the calls.

The check. Every ``greedy_every``-th call is greedy; the others sample
top-k (k = ``filter_frac`` x vocab) at ``temperature``. Of every call a
sample of rows drawn from the seed keeps its served tokens. After the
window the reference (``reference/dsv2_lite.py``, fp32, TF32 off, each
weight upcast where it is used) takes ``check_calls`` greedy and
``check_calls`` sampled calls (drawn from the seed) and runs its full
forward once over each kept row's prompt and served tokens (teacher-forced):
its logits at the prompt's last position judge the first served token (the
prefill's), the next ones every cached step. Two numbers are compared:

* ``logit_gap`` (greedy rows): the widest gap by which a served token's
  logit lies below the reference's best at its position;
* ``topk_gap`` (sampled rows): the widest gap by which a served token's
  logit lies below the reference's k-th best at its position.

The check also reports (on standard error, and in ``readings``)
``route_ties``: the share of the judged (token, expert layer) pairs whose
reference router margin, its k-th over its (k + 1)-th gate logit, is under
``route_delta``, where bf16 rounding may route the program otherwise. No
position is left out on that account.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import torch

from ..harness import traffic


class Session:
    kind = "generate"
    sync_each = True

    def __init__(self, ctx):
        from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_lm_generator
        from dyadic_interaction_modeling_tpu_torch.models.deepseek_v2 import (
            DeepseekV2Config, DeepseekV2Decoder)

        self.ctx = ctx
        dev, tr, cfg = ctx.device, ctx.traffic, ctx.config
        self.cfg = DeepseekV2Config.from_dict(cfg)
        self.b, self.p, self.n = tr["sequences"], tr["prompt"], tr["tokens"]
        self.frames_per_unit = self.b * self.n
        dtype = getattr(torch, cfg["precision"]["serve_dtype"])
        self.model = DeepseekV2Decoder.empty(self.cfg, dev, dtype,
                                             prefill_tokens=tr["prefill_tokens"]).eval()
        self.model.init_weights(traffic.generator(ctx.seed, 0, dev))
        # the reference reads the program's own tensors: no copy of the weights
        self.W = {k: v.detach() for k, v in self.model.named_parameters()}
        self.generate = make_lm_generator(self.model)
        g = traffic.generator(ctx.seed, 1, dev)
        self.prompts = [torch.randint(0, self.cfg.vocab_size, (self.b, self.p), generator=g,
                                      device=dev) for _ in range(tr["prompt_sets"])]
        self.rng = traffic.generator(ctx.seed, 2, dev)
        self.pick = traffic.generator(ctx.seed, 3, "cpu")  # which rows and calls are judged
        self.rows = torch.randperm(self.b, generator=self.pick)[: tr["check_rows"]].to(dev)
        self.k = max(1, math.ceil(tr["filter_frac"] * self.cfg.vocab_size))
        self.kept: List[dict] = []

    def _call(self, i: int, greedy: bool) -> torch.Tensor:
        tr = self.ctx.traffic
        return self.generate(self.prompts[i % len(self.prompts)], self.rng, self.n,
                             greedy=greedy, temperature=tr["temperature"],
                             filter_frac=tr["filter_frac"])

    def warm(self) -> None:
        """One sampled and one greedy call: every shape of the window, and
        both graphs captured."""
        for greedy in (False, True):
            self._call(0, greedy)

    def step(self, i: int) -> int:
        greedy = i % self.ctx.traffic["greedy_every"] == 0
        tokens = self._call(i, greedy)
        self.kept.append({"set": i % len(self.prompts), "greedy": greedy,
                          "tokens": tokens[self.rows]})
        return self.frames_per_unit

    def release(self) -> None:
        """The generator's graphs and cache go; the weights stay for the
        reference."""
        from dyadic_interaction_modeling_tpu_torch.models import xtrans

        xtrans._GRAPHS.pop(self.model, None)
        self.generate = None

    def _judged(self) -> List[dict]:
        """``check_calls`` greedy and as many sampled calls, drawn from the
        seed among those the window served."""
        n = self.ctx.traffic["check_calls"]
        out = []
        for greedy in (True, False):
            idx = [j for j, k in enumerate(self.kept) if k["greedy"] == greedy]
            order = torch.randperm(len(idx), generator=self.pick)[:n].tolist()
            out += [self.kept[idx[j]] for j in sorted(order)]
        return out

    def _gap(self, lg: torch.Tensor, tokens: torch.Tensor, greedy: bool) -> float:
        """The widest gap of the served ``tokens`` (R, n) below the best
        (greedy) or the k-th best (sampled) of ``lg`` (R, n, vocab)."""
        edge = lg.amax(-1) if greedy else lg.topk(self.k, dim=-1).values[..., -1]
        return float((edge - lg.gather(-1, tokens[..., None])[..., 0]).max())

    def _control_tokens(self, lc: torch.Tensor, greedy: bool) -> torch.Tensor:
        """The tokens a program computing ``lc`` would serve: its argmax, or
        a top-k sample at the traffic's temperature drawn from the seed."""
        if greedy:
            return lc.argmax(-1)
        kth = lc.topk(self.k, dim=-1).values[..., -1:]
        u = torch.rand(lc.shape, generator=self.control_rng, device=lc.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        filt = lc.masked_fill(lc < kth, float("-inf")) / self.ctx.traffic["temperature"]
        return (filt + gumbel).argmax(-1)

    def readings(self, controls=()) -> Dict[str, float]:
        """``logit_gap``, ``topk_gap`` and ``route_ties`` of the program's
        served rows against the fp32 reference; for each precision in
        ``controls`` also the gaps of the reference in that precision put in
        the program's place (``<number>.<prec>``: the gap of the token it
        would serve)."""
        from ..reference import common, dsv2_lite as R

        cfg, tr = self.ctx.config, self.ctx.traffic
        dev = self.prompts[0].device
        self.control_rng = traffic.generator(self.ctx.seed, 4, dev)
        out = {"logit_gap": 0.0, "topk_gap": 0.0}
        for c in controls:
            out.update({f"logit_gap.{c}": 0.0, f"topk_gap.{c}": 0.0})
        ties, pairs = 0, 0
        judged = self._judged()
        for kept in judged:
            greedy, tokens = kept["greedy"], kept["tokens"].long()
            name = "logit_gap" if greedy else "topk_gap"
            seq = torch.cat([self.prompts[kept["set"]][self.rows], tokens[:, :-1]], dim=1)
            lg, margins = R.forward(self.W, cfg, seq, logits_from=self.p - 1)
            out[name] = max(out[name], self._gap(lg, tokens, greedy))
            judged_margins = margins[:, :, self.p - 1:]
            ties += int((judged_margins < tr["route_delta"]).sum())
            pairs += judged_margins.numel()
            for c in controls:
                lc = R.forward(self.W, cfg, seq, common.Prec(c), logits_from=self.p - 1)[0]
                gap = self._gap(lg, self._control_tokens(lc, greedy), greedy)
                out[f"{name}.{c}"] = max(out[f"{name}.{c}"], gap)
                del lc
            del lg, margins
        out["route_ties"] = ties / max(1, pairs)
        if not any(k["greedy"] for k in judged) or all(k["greedy"] for k in judged):
            out = {k: float("inf") for k in out}
        return out

    def check(self) -> Dict[str, float]:
        out = self.readings()
        print(f"portbench: route_ties {out['route_ties']!r} (router margin under "
              f"{self.ctx.traffic['route_delta']})", file=sys.stderr)
        return out
