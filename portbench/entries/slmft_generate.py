"""SLMFT best-of-N generation: ``engine/pt_engine.make_slmft_generator``'s
``generate(batch, rng, N)`` on the configuration's SLMFT in bf16: the
encode (both VQ encoders, K4; encoder_s and encoder_joint), the token loop
(``models/xtrans.generate_tokens``, K1) and the VQ decode of every sampled
code.

The check. Every ``greedy_every``-th call is greedy; the others sample
top-k (``top_k_frac`` of the codes) at temperature 1 in fp32, as the paper's
eval does. Of every call a sample of rows drawn from the seed keeps its
served codes and motion. After the window the reference takes
``check_calls`` greedy and ``check_calls`` sampled calls (drawn from the
seed) and, for each kept row, runs its decoder once over the prompt and the
served codes (teacher-forced, fp32) and decodes the served codes to motion.
Three numbers are compared:

* ``logit_gap`` (greedy rows): the widest gap by which a served code's
  logit lies below the reference's best at its position. A greedy code is
  its position's argmax, so the gap is 0 up to rounding;
* ``topk_gap`` (sampled rows): the widest gap by which a served code's
  logit lies below the reference's k-th best at its position. A sampled
  code lies in the program's top k, so the gap is 0 up to rounding at the
  edge of the set;
* ``motion_err`` (all kept rows): the largest difference of the served
  motion from the reference's decode of the same codes, over the
  reference's largest magnitude.

The prompt is the first code of the listener VQ's tokenization, which a
bf16 encode may take from a near tie: each row is judged under the
reference's ``prompt_candidates`` nearest codes of the clip's first frame,
and keeps the one under which its widest gap is smallest.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..harness import traffic, weights


class Session:
    kind = "generate"
    sync_each = True

    def __init__(self, ctx):
        from dyadic_interaction_modeling_tpu_torch.config import CfgNode
        from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_slmft_generator
        from dyadic_interaction_modeling_tpu_torch.models.slm import SLMFT

        self.ctx = ctx
        dev, tr, cfg = ctx.device, ctx.traffic, ctx.config
        self.b0, self.n, self.l = tr["clips"], tr["samples"], tr["frames"]
        self.frames_per_unit = self.b0 * self.n * (self.l - 1)
        with torch.device(dev):
            model = SLMFT(CfgNode(cfg["slm"]), CfgNode(cfg["vq"]))
        dtype = getattr(torch, cfg["precision"]["serve_dtype"])
        self.model = model.to(dtype).eval()
        g = traffic.generator(ctx.seed, 0, dev)
        self.W = weights.seeded_params(self.model, g, dtype)
        weights.load(self.model, self.W)
        self.generate = make_slmft_generator(self.model)
        g = traffic.generator(ctx.seed, 1, dev)
        self.batches = [traffic.dyadic_clips(g, self.b0, self.l, dev)
                        for _ in range(tr["batches"])]
        self.rng = traffic.generator(ctx.seed, 2, dev)
        self.pick = traffic.generator(ctx.seed, 3, "cpu")  # which rows and calls are judged
        rows = torch.randperm(self.b0 * self.n, generator=self.pick)[: tr["check_rows"]]
        self.rows = rows.to(dev)
        self.kept: List[dict] = []

    def _call(self, i: int, greedy: bool):
        speaker, listener, audio, mask = self.batches[i % len(self.batches)]
        return self.generate((speaker, listener, audio, mask), self.rng, self.n,
                             greedy=greedy, return_tokens=True)

    def warm(self) -> None:
        """One sampled and one greedy call: every shape of the window."""
        for greedy in (False, True):
            self._call(0, greedy)

    def step(self, i: int) -> int:
        greedy = i % self.ctx.traffic["greedy_every"] == 0
        cands, tokens = self._call(i, greedy)
        b = self.rows % self.b0
        s = self.rows // self.b0
        self.kept.append({"batch": i % len(self.batches), "greedy": greedy,
                          "tokens": tokens[self.rows], "motion": cands[b, s]})
        return self.frames_per_unit

    def release(self) -> None:
        self.model = self.generate = None

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

    def _gap(self, lg: torch.Tensor, tokens: torch.Tensor, greedy: bool) -> torch.Tensor:
        """(R,) the widest gap of each row's served codes below the best
        (greedy) or the k-th best (sampled) of ``lg`` (R, n, vocab)."""
        k = max(1, math.ceil(self.ctx.traffic["top_k_frac"] * lg.shape[-1]))
        edge = lg.amax(-1) if greedy else lg.topk(k, dim=-1).values[..., -1]
        return (edge - lg.gather(-1, tokens[..., None])[..., 0]).amax(-1)

    def _control_codes(self, lc: torch.Tensor, greedy: bool) -> torch.Tensor:
        """The codes a program computing ``lc`` would serve at each position:
        its argmax, or a top-k sample at temperature 1 drawn from the seed."""
        if greedy:
            return lc.argmax(-1)
        k = max(1, math.ceil(self.ctx.traffic["top_k_frac"] * lc.shape[-1]))
        kth = lc.topk(k, dim=-1).values[..., -1:]
        u = torch.rand(lc.shape, generator=self.control_rng, device=lc.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return (lc.masked_fill(lc < kth, float("-inf")) + gumbel).argmax(-1)

    def readings(self, controls=()) -> Dict[str, float]:
        """The three numbers of the program's served rows against the fp32
        reference; for each precision in ``controls`` also those of the
        reference in that precision put in the program's place
        (``<number>.<prec>``: the gap of the code it would serve)."""
        from ..reference import common, slm_vico as R

        common.fp32_matmuls()
        cfg, tr = self.ctx.config, self.ctx.traffic
        slm, vq = cfg["slm"], cfg["vq"]
        W = {k: v.float() for k, v in self.W.items()}
        P = common.Prec("fp32")
        self.control_rng = traffic.generator(self.ctx.seed, 4, self.batches[0][0].device)
        names = ("logit_gap", "topk_gap", "motion_err")
        out = {k: 0.0 for k in names}
        for c in controls:
            out.update({f"{k}.{c}": 0.0 for k in names})
        judged = self._judged()
        for kept in judged:
            greedy = kept["greedy"]
            gap_name = "logit_gap" if greedy else "topk_gap"
            speaker, listener, audio, mask = self.batches[kept["batch"]]
            clips = self.rows % self.b0
            sp, li, au, mk = speaker[clips], listener[clips], audio[clips], mask[clips]
            tokens = kept["tokens"].long()
            ctx = R.context(P, W, slm, sp, au, mk)
            cands = R.prompt_candidates(W, vq, li, mk, tr["prompt_candidates"])
            best_gap, best_lg, best_prompt = None, None, None
            for j in range(cands.shape[1]):
                lg = R.logits(P, W, slm, cands[:, j], tokens, ctx, mk, None)
                gap = self._gap(lg, tokens, greedy)
                if best_gap is None:
                    best_gap, best_lg, best_prompt = gap, lg, cands[:, j].clone()
                else:
                    better = gap < best_gap
                    best_gap = torch.where(better, gap, best_gap)
                    best_lg = torch.where(better[:, None, None], lg, best_lg)
                    best_prompt = torch.where(better, cands[:, j], best_prompt)
            ref_motion = R.motion(P, W, vq, tokens, self.rows)
            scale = float(ref_motion.abs().max())
            out[gap_name] = max(out[gap_name], float(best_gap.max()))
            err = float((kept["motion"].float() - ref_motion).abs().max()) / scale
            out["motion_err"] = max(out["motion_err"], err)
            for c in controls:
                Pc = common.Prec(c)
                lc = R.logits(Pc, W, slm, best_prompt, tokens, R.context(Pc, W, slm, sp, au, mk),
                              mk, None)
                gap = self._gap(best_lg, self._control_codes(lc, greedy), greedy).max()
                out[f"{gap_name}.{c}"] = max(out[f"{gap_name}.{c}"], float(gap))
                mc = R.motion(Pc, W, vq, tokens, self.rows)
                out[f"motion_err.{c}"] = max(out[f"motion_err.{c}"],
                                             float((mc - ref_motion).abs().max()) / scale)
        if not any(k["greedy"] for k in judged) or all(k["greedy"] for k in judged):
            out = {k: float("inf") for k in out}
        return out

    def check(self) -> Dict[str, float]:
        return self.readings()
