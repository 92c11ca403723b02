"""SLM training and best-of-N listener generation (x_engine_pt.py).

Counterpart of ``dyadic_interaction_modeling_tpu/engine/pt_engine.py``:

* ``make_slm_train_step``, ``train_epoch``, ``evaluate_epoch`` (:51-162):
  one optimizer step of the SLM pretraining loss or the SLMFT finetune loss,
  with global-norm clipping over the trainable parameters and, on the card,
  bf16 autocast over fp32 parameters (the counterpart of flax
  ``dtype=bfloat16`` with fp32 ``param_dtype``);
* ``VQTokenCache`` (:86-133): the frozen VQs' codes of each clip, computed
  the first time the clip comes and reassembled for any later batch;
* ``evaluate_finetune_epoch`` (:165-187): SLMFT's teacher-forced
  predictions for the metric battery;
* ``make_slmft_generator`` (:195-318) runs the N resamples of every clip as
  ONE batched generate whose N*B0 rows share the B0 clips' cross-attention
  context (``context_groups``), then decodes the tokens to motion; the
  per-clip pick by Frechet distance happens on the host;
* ``make_speaker_generator`` (:236-269) does the same for SpeakerSLMFT's
  BIWI speaker generation (EMOCA candidates, picked by vertex L2), with
  ``BIWI_SPEAKER_IDS`` and ``speaker_ids_from_names`` (:36-41, :321);
  ``make_speaker_train_step`` is its teacher-forced finetune step;
* ``make_lm_generator`` (no counterpart: the JAX package runs no
  context-free language model) samples from a context-free decoder such as
  ``models/deepseek_v2.DeepseekV2Decoder``: prompt ids in, sampled ids out.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..metrics.eval_utils import (
    calculate_activation_statistics,
    calculate_frechet_distance,
)
from ..models.slm import SLMFT
from ..models.xtrans import IGNORE, generate_tokens
from ..utils.profiling import is_recording, span
from .train_state import clip_by_global_norm

log = logging.getLogger(__name__)

# BIWI subject -> speaker-embedding row (x_engine_pt.py:99-102)
BIWI_SPEAKER_IDS = {
    "F2": 0, "F3": 1, "F4": 2, "M3": 3, "M4": 4, "M5": 5,
    "F1": 6, "F5": 7, "F6": 8, "F7": 9, "F8": 10, "M1": 11,
    "M2": 12, "M6": 13,
}


def _autocast(device: torch.device, amp_dtype: Optional[torch.dtype]):
    return torch.autocast(device_type=device.type, dtype=amp_dtype,
                          enabled=amp_dtype is not None)


def make_slm_train_step(model, optimizer: torch.optim.Optimizer, clip_norm: float,
                        amp_dtype: Optional[torch.dtype] = None,
                        with_vq_tokens: bool = False) -> Callable:
    """(batch, generator=None, noise=None) -> logs: one optimizer step.

    batch = (src_v, tgt, src_a, mask) tensors on the model's device, and with
    ``with_vq_tokens`` also the (z_s, z_l) codes of the frozen VQs
    (``VQTokenCache``), so the step does not run their encoders; ``model`` is
    SLM or SLMFT; ``generator`` draws the masking noise, or ``noise`` injects
    it (see ``SLM.forward``, ``SLMFT.forward``). The forward runs under
    autocast to ``amp_dtype`` when given; the cross-entropy's log-softmax
    stays fp32. The gradients of the optimizer's parameters are clipped to a
    global norm of ``clip_norm`` (none when 0). Returns the six logs as
    detached device tensors, so a step never waits for the card."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, generator: Optional[torch.Generator] = None, noise=None
             ) -> Dict[str, torch.Tensor]:
        src_v, tgt, src_a, mask = batch[:4]
        tokens = tuple(batch[4:6]) if with_vq_tokens else None
        optimizer.zero_grad(set_to_none=True)
        with _autocast(src_v.device, amp_dtype):
            out = model(src_v, tgt, src_a, mask, generator=generator, noise=noise,
                        vq_tokens=tokens)
        out.total_loss.backward()
        if clip_norm > 0:
            clip_by_global_norm(params, clip_norm)
        optimizer.step()
        return {k: v.detach() for k, v in out.logs.items()}

    return step


class VQTokenCache:
    """The frozen VQ tokenizers' codes of each clip, by clip name.

    The SLM and SLMFT steps tokenize every batch with the two frozen VQ
    encoders, though a clip's codes never change: the masked batched encode
    equals encoding each clip alone within its length, so they depend
    neither on the batch nor on its padding. The first time a clip comes
    this runs ``forward_vq`` (under ``amp_dtype`` autocast, as the step
    would) and keeps the clip's codes on the host; a batch whose clips are
    all known is then assembled there, padded as ``forward_vq`` pads (0 for
    speaker codes, ``IGNORE`` for listener codes), and copied to the card.
    Clips are cached only under unique truthy names (the dataset's clip
    path); a batch without them is computed every time.
    """

    def __init__(self, model, amp_dtype: Optional[torch.dtype] = None):
        self._model = model
        self._fq = int(model.vq_cfg.face_quan_num)
        self._amp = amp_dtype
        self._store: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def __call__(self, batch, names) -> Tuple[torch.Tensor, torch.Tensor]:
        src_v, tgt, _src_a, mask = batch[:4]
        usable = (names is not None and all(names)
                  and len(set(names)) == len(names))
        if not usable or any(n not in self._store for n in names):
            with torch.no_grad(), _autocast(src_v.device, self._amp):
                z_s, z_l = self._model.forward_vq(src_v, tgt, mask)
            if usable:
                lens = mask.sum(dim=1).cpu().numpy()
                zs_np, zl_np = z_s.cpu().numpy(), z_l.cpu().numpy()
                for i, n in enumerate(names):
                    self._store[n] = (zs_np[i, : lens[i] * self._fq].copy(),
                                      zl_np[i, : lens[i]].copy())
            return z_s, z_l
        b, l = src_v.shape[0], src_v.shape[1]
        z_s = np.zeros((b, l * self._fq), np.int32)
        z_l = np.full((b, l), IGNORE, np.int32)
        for i, n in enumerate(names):
            zs, zl = self._store[n]
            z_s[i, : zs.shape[0]] = zs
            z_l[i, : zl.shape[0]] = zl
        return (torch.as_tensor(z_s, device=src_v.device),
                torch.as_tensor(z_l, device=src_v.device))


def train_epoch(loader: Iterable, train_step: Callable,
                generator: Optional[torch.Generator] = None, epoch: int = 0
                ) -> Dict[str, float]:
    """One pass over ``loader``'s tensor batches, logging every 200 steps
    (x_engine_pt.train_epoch's cadence); the last step's logs."""
    logs = {}
    for i, batch in enumerate(loader):
        logs = train_step(batch, generator)
        if (i + 1) % 200 == 0:
            log.info("Epoch %d batch %d: %s", epoch, i + 1,
                     " ".join(f"{k} {float(v):.4f}" for k, v in logs.items()))
    return {k: float(v) for k, v in logs.items()}


@torch.no_grad()
def evaluate_epoch(model, loader: Iterable, generator: Optional[torch.Generator] = None,
                   amp_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """Mean of the logs over ``loader``'s tensor batches: the teacher-forced
    validation loss (x_engine_pt.py:134-165)."""
    sums: Dict[str, float] = {}
    n = 0
    for src_v, tgt, src_a, mask in loader:
        with _autocast(src_v.device, amp_dtype):
            logs = model(src_v, tgt, src_a, mask, generator=generator).logs
        for k, v in logs.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


@torch.no_grad()
def evaluate_finetune_epoch(model: SLMFT, loader: Iterable,
                            generator: Optional[torch.Generator] = None,
                            amp_dtype: Optional[torch.dtype] = None,
                            noises: Optional[Iterable[torch.Tensor]] = None
                            ) -> Tuple[List, List, List, List]:
    """Teacher-forced predictions for the metric battery
    (x_engine_pt.py:201-230) over tensor batches (src_v, tgt, src_a, mask
    [, ids]). The inputs are corrupted as in training (``SLMFT.forward``),
    by noise drawn from ``generator`` or taken from ``noises``, one (B, L-1)
    tensor a batch. Returns (y_trues, y_preds, x, data_ids), lists of
    per-clip numpy arrays of length len - 1."""
    y_trues, y_preds, xs, ids = [], [], [], []
    noises = iter(noises) if noises is not None else None
    for batch in loader:
        src_v, tgt, src_a, mask = batch[:4]
        data_ids = batch[4] if len(batch) > 4 else [None] * src_v.shape[0]
        noise = next(noises) if noises is not None else None
        with _autocast(src_v.device, amp_dtype):
            pred = model(src_v, tgt, src_a, mask, generator=generator, noise=noise).pred
        pred = pred.float().cpu().numpy()
        lens = mask.sum(dim=1).cpu().numpy()
        tgt_np, src_np = tgt.cpu().numpy(), src_v.cpu().numpy()
        for j in range(src_np.shape[0]):
            lj = int(lens[j])
            y_preds.append(pred[j, : lj - 1])
            y_trues.append(tgt_np[j, 1:lj])
            xs.append(src_np[j, : lj - 1])
            ids.append(data_ids[j])
    return y_trues, y_preds, xs, ids


def make_slmft_generator(model: SLMFT) -> Callable:
    """Batched generator: (batch, generator, n_samples) -> (B, N, L-1, 56)
    candidate motions, batch = (src_v, tgt, src_a, mask) tensors on the
    model's device.

    The prompt is tiled sample-major (row s*B + b is sample s of clip b, as
    ``jnp.tile`` lays it out); the VQ decode then sees the N*B rows in that
    order, which its batch-indexed positional encoding depends on.
    ``greedy`` and ``gumbel`` (injected (L-1, N*B, vocab) noise) pass through
    to ``generate_tokens``; ``return_tokens`` also returns the (N*B, L-1)
    sampled codes."""

    @torch.no_grad()
    def generate(batch, generator: Optional[torch.Generator], n_samples: int, *,
                 greedy: bool = False, gumbel: Optional[torch.Tensor] = None,
                 return_tokens: bool = False):
        src_v, tgt, src_a, mask = batch
        b, l = src_v.shape[0], src_v.shape[1]
        with span("generate"):
            with span("encode"):
                ctx, prompt = model.encode_context(src_v, tgt, src_a, mask)
            tokens = generate_tokens(model.decoder, prompt.repeat(n_samples, 1), l - 1,
                                     ctx, mask, generator, greedy=greedy,
                                     context_groups=n_samples, gumbel=gumbel)
            with span("vq_decode"):
                motion = model.decode_tokens_to_motion(tokens)
                # (N*B, L-1, 56) -> (B, N, L-1, 56)
                cands = motion.reshape(n_samples, b, l - 1, -1).transpose(0, 1)
        return (cands, tokens) if return_tokens else cands

    return generate


def make_speaker_generator(model) -> Callable:
    """Batched generator for SpeakerSLMFT: (batch, generator, n_samples) ->
    (B, N, L-1, 56) candidate EMOCA sequences, batch = (verts, emoca,
    audio, mask, template, speaker_ids) tensors on the model's device
    (``speaker_ids`` may be None).

    As ``make_slmft_generator``: one ``generate_tokens`` call whose N*B rows
    (sample-major) share the B clips' context (``context_groups=N``), the
    tokens decoded by the speaker VQ. ``greedy``, ``gumbel`` and
    ``return_tokens`` as there. The JAX package's ``chunk`` (a
    chunked-prefix schedule over the self cache) has no counterpart: K1
    reads only the live t + 1 cache entries of step t."""

    @torch.no_grad()
    def generate(batch, generator: Optional[torch.Generator], n_samples: int, *,
                 greedy: bool = False, gumbel: Optional[torch.Tensor] = None,
                 return_tokens: bool = False):
        verts, emoca, audio, mask, template, sids = batch
        b, l = verts.shape[0], verts.shape[1]
        ctx, prompt = model.encode_context(verts, emoca, audio, mask, template, sids)
        tokens = generate_tokens(model.decoder, prompt.repeat(n_samples, 1), l - 1, ctx,
                                 mask, generator, greedy=greedy,
                                 context_groups=n_samples, gumbel=gumbel)
        out = model.decode_emoca(tokens, from_logits=False)[1]
        cands = out.reshape(n_samples, b, l - 1, -1).transpose(0, 1)
        return (cands, tokens) if return_tokens else cands

    return generate


def make_lm_generator(decoder) -> Callable:
    """Batched sampling from a context-free decoder (``generate_tokens``'
    protocol, ``context=None``): (prompt, generator, n_tokens) -> (B,
    n_tokens) sampled ids, prompt (B, P) ids on the decoder's device. The
    prompt is prefilled in one batched pass (its ``prefill`` span), then
    each token is one cached step, replayed from a CUDA graph on the card.
    ``greedy``, ``gumbel``, ``temperature`` and ``filter_frac`` pass through
    to ``generate_tokens``. For a decoder with an ``expert_load`` buffer
    (``models/deepseek_v2.py``), while the recorder is on, the ``generate``
    span gets ``expert_load_pm``: the largest expert's token count over its
    layer's mean in the call's decode steps, per mille (a host sync, so
    only then)."""

    @torch.no_grad()
    def generate(prompt: torch.Tensor, generator: Optional[torch.Generator], n_tokens: int, *,
                 greedy: bool = False, gumbel: Optional[torch.Tensor] = None,
                 temperature: float = 1.0, filter_frac: float = 0.1) -> torch.Tensor:
        load = getattr(decoder, "expert_load", None) if is_recording() else None
        with span("generate") as call:
            before = None if load is None else load.clone()
            tokens = generate_tokens(decoder, prompt, n_tokens, None, None, generator,
                                     greedy=greedy, gumbel=gumbel, temperature=temperature,
                                     filter_frac=filter_frac)
            if load is not None:
                call.set(expert_load_pm=expert_load_pm((load - before).cpu()))
        return tokens

    return generate


def expert_load_pm(load: torch.Tensor) -> int:
    """The largest expert's token count over its layer's mean, per mille,
    the largest over the layers of ``load`` (layers, E); 0 when empty."""
    load = load.double()
    mean = load.mean(dim=-1)
    if not bool((mean > 0).any()):
        return 0
    return int(round(1000 * float((load.amax(dim=-1) / mean.clamp_min(1e-30)).max())))


def make_speaker_train_step(model, optimizer: torch.optim.Optimizer,
                            clip_norm: float) -> Callable:
    """(batch, mouth_map=None) -> logs: one optimizer step of SpeakerSLMFT's
    teacher-forced loss in the parameters' dtype, batch = (verts, emoca,
    audio, mask, template, speaker_ids) tensors on the model's device;
    clipping as ``make_slm_train_step``. A trainable parameter that the
    loss does not reach (the mesh head, ``W``) keeps ``grad`` None, so AdamW
    leaves it alone, weight decay included, as in the reference."""
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch, mouth_map=None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        out = model(*batch, mouth_map=mouth_map)
        out.total_loss.backward()
        if clip_norm > 0:
            clip_by_global_norm(params, clip_norm)
        optimizer.step()
        return {k: v.detach() for k, v in out.logs.items()}

    return step


def speaker_ids_from_names(names: Iterable[str], device=None) -> torch.Tensor:
    """BIWI file names (``F2_01.wav``) -> int64 speaker-embedding rows."""
    return torch.tensor([BIWI_SPEAKER_IDS[n.split("_")[0]] for n in names],
                        dtype=torch.int64, device=device)


def select_best_by_fd(candidates: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The candidate with the lowest Frechet distance to the target clip.
    candidates: (N, T, C); target: (T, C)."""
    mu1, s1 = calculate_activation_statistics(target)
    best, best_fd = None, float("inf")
    for cand in candidates:
        mu2, s2 = calculate_activation_statistics(cand)
        try:
            fd = calculate_frechet_distance(mu1, s1, mu2, s2)
        except ValueError:
            fd = float("inf")
        if fd < best_fd:
            best, best_fd = cand, fd
    return best if best is not None else candidates[0]


def select_best_by_l2(candidates: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The candidate with the lowest mean vertex L2 (x_engine_pt.py:328-334)."""
    d = np.mean(np.sqrt(np.sum((candidates - target[None]) ** 2, axis=-1)), axis=-1)
    return candidates[int(np.argmin(d))]


def evaluate_test_epoch(model: SLMFT, generate: Callable, loader: Iterable,
                        generator: Optional[torch.Generator], beam_size: int = 10,
                        select: str = "fd", device="cuda"
                        ) -> Tuple[List, List, List, List]:
    """Best-of-N sampled eval over numpy batches (src_v, tgt, src_a, mask
    [, ids]). Returns (y_trues, y_preds, x, data_ids), lists of per-clip
    numpy arrays of length len - 1."""
    y_trues, y_preds, xs, ids = [], [], [], []
    pick = select_best_by_fd if select == "fd" else select_best_by_l2
    for batch in loader:
        src_v, tgt, src_a, mask = batch[:4]
        data_ids = batch[4] if len(batch) > 4 else [None] * src_v.shape[0]
        tensors = tuple(torch.as_tensor(np.asarray(x), device=device)
                        for x in (src_v, tgt, src_a, mask))
        cands = generate(tensors, generator, beam_size)
        with span("to_host"):  # waits for the card
            cands = cands.float().cpu().numpy()
        lens = np.asarray(mask).sum(axis=1)
        tgt_np, src_np = np.asarray(tgt), np.asarray(src_v)
        with span("fd_pick"):
            for j in range(src_np.shape[0]):
                lj = int(lens[j])
                target = tgt_np[j, 1:lj]
                y_trues.append(target)
                xs.append(src_np[j, : lj - 1])
                ids.append(data_ids[j])
                y_preds.append(pick(cands[j, :, : lj - 1], target))
    return y_trues, y_preds, xs, ids
