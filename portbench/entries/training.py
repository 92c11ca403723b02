"""What the training entries share: the check of a training step against
its reference.

Set-up builds one training step (model, AdamW state) from the benchmark's
weights and drives it through its first three steps on three different
batches; the window continues with that same object. The reference then
takes the same weights and batches through three steps of its own. The
numbers (``compare``) are gaps between norms (not the norm of a
difference), leaf by leaf against the reference's norm of that leaf or of
the median leaf, whichever is larger, and loss gaps relative to the
reference's loss:

* ``loss1_gap`` (the first step's loss), ``<part>1_gap`` (each logged part
  of it) and ``loss_gap`` (the worst of the three steps);
* ``grad_gap`` / ``grad_gap_med``: the first step's gradient as the
  optimizer got it, read from AdamW's first moment after one step
  (exp_avg / (1 - beta1)), at the worst / the median leaf;
* ``change_gap`` / ``change_gap_med``: the weights' change after the three
  steps, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (Adam moves the others by round-off
  alone).

``limits/<cell>.json`` names those a cell compares, with the readings each
limit was set from.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

CHECKED_STEPS = 3
BETA1 = 0.9
TINY_GRAD = 1e-3


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Every tensor's L2 norm, in float64, read back in one copy."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[k].double().norm() for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> List[float]:
    """Each leaf's gap of norms against the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def _first(prog: dict, ref: dict) -> Dict[str, float]:
    """The first step's numbers: the loss, each logged part of it, and the
    first gradient at the worst and at the median leaf."""
    first, ref_first = prog["losses"][0], ref["losses"][0]
    out = {"loss1_gap": abs(first - ref_first) / max(abs(ref_first), 1e-30)}
    for k, r in ref.get("parts", [{}])[0].items():
        out[f"{k}1_gap"] = abs(prog["parts"][0][k] - r) / max(abs(r), 1e-30)
    leaves = sorted(ref["grad"])
    if any(k not in prog["grad"] for k in leaves):  # a leaf the program did not step
        return dict(out, grad_gap=math.inf, grad_gap_med=math.inf)
    g = leaf_gaps(prog["grad"], ref["grad"], leaves)
    return dict(out, grad_gap=max(g), grad_gap_med=statistics.median(g))


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers from the program's and the reference's readings, each a
    dict with ``losses`` (list), ``parts`` (a dict of logged parts a step),
    ``grad`` and ``change`` (leaf -> norm): ``loss_gap`` over the three
    steps; the first step's (``_first``); ``change_gap`` at the worst leaf
    and ``change_gap_med`` at the median one. Where the reference offers
    ``first_alternatives`` (its first step with a tied quantization taken
    the other way) the first step's numbers are those of the alternative
    nearest the program's. ``limits/<cell>.json`` names the numbers a cell
    compares."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    first = _first(prog, ref)
    for alt in ref.get("first_alternatives", []):
        other = _first(prog, {"losses": [alt["loss"]], "parts": [alt["parts"]],
                              "grad": alt["grad"]})
        if other["grad_gap_med"] < first["grad_gap_med"]:
            first = other
    out = dict(first, loss_gap=max(gaps))
    leaves = sorted(ref["grad"])
    if any(k not in prog["grad"] for k in leaves):
        return dict(out, change_gap=math.inf, change_gap_med=math.inf)
    med = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= TINY_GRAD * med]
    c = leaf_gaps(prog["change"], ref["change"], moving)
    return dict(out, change_gap=max(c), change_gap_med=statistics.median(c))


class TrainSession:
    """A training entry: ``self.step(batch_index)`` runs one program step.
    Subclasses build ``model``, ``opt``, ``batches``, ``W0`` (the weights,
    fp32), ``trainable`` (leaf names) and implement ``_step`` (one program
    step on batch i, returning its logs), ``_loss`` (the loss and its
    logged parts from those logs) and ``reference_readings(prec, half)``:
    the reference's readings from the same weights and batches, its
    products in precision ``prec``, with ``half`` the loss's mean taken over
    half of each batch (a fault planted in the reference)."""

    kind = "train"
    sync_each = False

    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.frames_per_unit = tr["clips"] * tr["frames"]
        self.prog = None

    def warm(self) -> None:
        """The three checked steps, which also warm every shape."""
        names = {id(p): k for k, p in self.model.named_parameters()}
        losses, parts, grad = [], [], None
        for i in range(CHECKED_STEPS):
            loss, part = self._loss(self._step(i))
            losses.append(loss)
            parts.append(part)
            if i == 0:
                grad = {names[id(p)]: st["exp_avg"] / (1 - BETA1)
                        for p, st in self.opt.state.items() if "exp_avg" in st}
                grad = leaf_norms(grad)
        params = dict(self.model.named_parameters())
        change = leaf_norms({k: params[k].detach().float() - self.W0[k] for k in self.trainable})
        self.prog = {"losses": [float(x) for x in losses], "grad": grad, "change": change,
                     "parts": [{k: float(v) for k, v in p.items()} for p in parts]}

    def step(self, i: int) -> int:
        self._step((CHECKED_STEPS + i) % len(self.batches))
        return self.frames_per_unit

    def release(self) -> None:
        self.model = self.opt = self.train_step = None

    def check(self) -> Dict[str, float]:
        return compare(self.prog, self.reference_readings())
