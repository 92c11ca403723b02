"""A fixed-capacity pool of streaming listener sessions at different lengths.

Counterpart of ``dyadic_interaction_modeling_tpu/serving/pool.py``.
``StreamingListenerSession`` moves its streams in lockstep; a serving host
needs streams that join and leave at any time, so at any instant its slots
sit at different context and token counts, and each call touches only the
slots that have data. The design is the JAX package's (``pool.py:13-33``):

* every per-slot quantity (encoder, cross and decoder KV caches, the last
  logits) is one device tensor with a leading pool axis, and every call
  steps all ``capacity`` slots as one batch;
* the context and token counters are host-side; ``join`` / ``leave`` are
  bookkeeping only: every read is masked by the slot's counters, so a freed
  slot's stale cache is never seen and is overwritten by its next occupant;
* idle slots step too, but their logits and generators are left as they
  were, and their cache writes land in a slack region past the usable
  capacity (``[max_frames, max_frames + chunk)``, ``[max_tokens]``) that no
  masked read touches.

Where the JAX package ``vmap``s the single-session math over slots, the port
steps the batch with a (P,) tensor of each slot's own position: K/V are
written at each slot's position by advanced indexing, and each slot's bound
goes to K1 as a (P, L) key mask (``pos <= t_dec[slot]`` for the self step,
``pos < t_ctx[slot]`` for the cross step, ``t=None``), so one K1 launch a
layer and step serves every slot. No cache is gathered or copied. Each slot
samples from its own ``torch.Generator``, seeded at ``join``, as a solo
session seeded alike.

``mesh=`` (JAX ``pool.py:75-120``, where the pool axis is sharded over a
mesh's ``data`` axis) takes a sequence of devices: the slots split evenly
over them, each device holding a replica of the model and the caches of its
slots (a ``StreamingSessionPool`` of ``capacity / len(mesh)``). Slots are
independent, so no device talks to another, and a slot's codes are those of
``mesh=None``; results come back on the first device.

Typical host loop::

    pool = StreamingSessionPool(model, capacity=64, chunk=8)
    a = pool.join(seed=1); b = pool.join(seed=2)
    pool.feed([a, b], sp2, au2)        # both have a chunk ready
    pool.start([a], prompt_a)          # a starts generating first
    toks = pool.generate([a], 8)
    pool.leave(a)                      # the slot is free for the next caller
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.slm import SLMFT
from ..models.xtrans import gumbel_noise, init_decoder_cache, sample_tokens
from .streaming import cross_caches, head_dims, model_device, write_cross


class StreamingSessionPool:
    """``capacity`` independent streaming listener sessions over one SLMFT.

    chunk: speaker frames a ``feed``; max_frames / max_tokens: each
    session's context and listener-token capacity; temperature /
    filter_frac / greedy: the sampling controls of ``generate_tokens``
    (pool-wide)."""

    def __new__(cls, model: SLMFT, *, mesh: Optional[Sequence] = None, **kwargs):
        if mesh is not None:  # one pool a device, composed by MeshSessionPool
            return MeshSessionPool(model, mesh=mesh, **kwargs)
        return super().__new__(cls)

    def __init__(self, model: SLMFT, *, capacity: int = 8, chunk: int = 8,
                 max_frames: int = 1024, max_tokens: Optional[int] = None,
                 temperature: float = 1.0, filter_frac: float = 0.1, greedy: bool = False,
                 mesh: Optional[Sequence] = None):
        c = model.cfg
        self.model = model
        self.capacity, self.chunk, self.max_frames = capacity, chunk, max_frames
        self.max_tokens = max_tokens or max_frames
        self.greedy, self.temperature, self.filter_frac = greedy, temperature, filter_frac
        self.device, dt = model_device(model), model.dtype
        p, dh, kvh = capacity, *head_dims(c)
        lmax = max_frames + chunk           # + the slack for idle slots' writes
        self._enc_s = init_decoder_cache(p, lmax, c.enc_depth, c.enc_heads, dh, dt, kvh,
                                         self.device)
        self._enc_j = init_decoder_cache(p, lmax, c.enc_depth, c.enc_heads, dh, dt, kvh,
                                         self.device)
        self._cross = cross_caches(c, p, lmax, dt, self.device)
        self._dec = init_decoder_cache(p, self.max_tokens + 1, c.dec_depth, c.dec_heads, dh,
                                       dt, kvh, self.device)
        self._logits = torch.zeros(p, c.num_tokens, device=self.device)
        self._generators: List[Optional[torch.Generator]] = [None] * p
        self._lmax = lmax
        # host-side per-slot progress
        self._t_ctx = np.zeros(p, np.int64)
        self._t_dec = np.zeros(p, np.int64)
        self._active = np.zeros(p, bool)
        self._started = np.zeros(p, bool)
        self._tokens: List[List[torch.Tensor]] = [[] for _ in range(p)]

    # --- slot management (host bookkeeping only)

    def join(self, seed: int = 0) -> int:
        """Claim a free slot for a new stream; returns the slot id."""
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise RuntimeError("pool full; leave() a session or grow capacity")
        slot = int(free[0])
        self._active[slot], self._started[slot] = True, False
        self._t_ctx[slot] = self._t_dec[slot] = 0
        self._tokens[slot] = []
        self._generators[slot] = torch.Generator(device=self.device).manual_seed(seed)
        return slot

    def leave(self, slot: int) -> None:
        """Release a slot; its stale caches stay, unreachable behind the
        counters."""
        self._active[slot] = False

    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    def frames_fed(self, slot: int) -> int:
        return int(self._t_ctx[slot])

    def tokens_generated(self, slot: int) -> int:
        return int(self._t_dec[slot])

    def _check(self, slots: Sequence[int]) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            raise ValueError("empty slot list")
        if len(np.unique(slots)) != slots.size:
            raise ValueError("duplicate slots in one call")
        if not self._active[slots].all():
            raise ValueError("call includes a slot that has not join()ed")
        return slots

    def _act(self, slots: np.ndarray) -> np.ndarray:
        act = np.zeros(self.capacity, bool)
        act[slots] = True
        return act

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def _chunks(self, slots, speaker_chunks, audio_chunks, n_valid):
        """The listed slots' chunks scattered into (P, chunk, dim) device
        buffers (zeros for idle slots), and each listed slot's valid count."""
        sp = torch.as_tensor(speaker_chunks)
        au = torch.as_tensor(audio_chunks)
        if sp.shape[0] != slots.size or sp.shape[1] != self.chunk:
            raise ValueError(f"expected ({slots.size}, {self.chunk}, dim) chunks, "
                             f"got {tuple(sp.shape)}")
        nv = np.broadcast_to(np.asarray(self.chunk if n_valid is None else n_valid,
                                        np.int64), slots.shape)
        if (self._t_ctx[slots] + nv > self.max_frames).any():
            raise ValueError("context capacity exceeded; raise max_frames")
        rows = self._dev(slots)
        bufs = []
        for x in (sp, au):
            buf = torch.zeros((self.capacity,) + tuple(x.shape[1:]), dtype=self.model.dtype,
                              device=self.device)
            buf[rows] = x.to(self.device, self.model.dtype)
            bufs.append(buf)
        return bufs[0], bufs[1], nv

    def _ctx_mask(self) -> torch.Tensor:
        return (torch.arange(self._lmax, device=self.device)[None, :]
                < self._dev(self._t_ctx)[:, None])

    # --- streaming ops (each touches only the listed slots)

    @torch.no_grad()
    def _feed(self, slots, act, sp, au, nv) -> None:
        # idle slots write into the slack region [max_frames, max_frames + chunk)
        t = self._dev(np.where(act, self._t_ctx, self.max_frames))
        ctx = self.model.encode_context_chunk(sp, au, self._enc_s, self._enc_j, t)
        write_cross(self._cross, self.model.stream_cross_kv(ctx), t)
        self._t_ctx[slots] += nv

    def feed(self, slots: Sequence[int], speaker_chunks, audio_chunks, n_valid=None) -> None:
        """Stream one (len(slots), chunk, dim) speaker chunk (and its audio)
        into each listed slot at its own context frontier; ``n_valid``, an
        int or one a slot, marks short final chunks."""
        slots = self._check(slots)
        sp, au, nv = self._chunks(slots, speaker_chunks, audio_chunks, n_valid)
        self._feed(slots, self._act(slots), sp, au, nv)

    @torch.no_grad()
    def start(self, slots: Sequence[int], prompts) -> None:
        """Consume (len(slots), P) prompt codes for the listed slots; each
        needs at least one fed frame."""
        slots = self._check(slots)
        prompts = torch.as_tensor(prompts).long()
        if prompts.shape[0] != slots.size:
            raise ValueError("one prompt row per slot")
        if (self._t_ctx[slots] == 0).any():
            raise ValueError("feed at least one chunk before start()")
        n_p = prompts.shape[1]
        if (self._t_dec[slots] + n_p > self.max_tokens).any():
            raise ValueError("token capacity exceeded; raise max_tokens")
        act = self._act(slots)
        buf = torch.zeros(self.capacity, n_p, dtype=torch.long, device=self.device)
        buf[self._dev(slots)] = prompts.to(self.device)
        mask, live = self._ctx_mask(), self._dev(act)[:, None]
        for i in range(n_p):
            # idle slots write into the slack position max_tokens
            t = self._dev(np.where(act, self._t_dec + i, self.max_tokens))
            logits = self.model.stream_decode_step(buf[:, i: i + 1], self._dec, t,
                                                   self._cross, mask)
            self._logits = torch.where(live, logits.float(), self._logits)
        self._t_dec[slots] += n_p
        self._started[slots] = True

    def _sample(self, act: np.ndarray) -> torch.Tensor:
        """The next token of every slot; an active slot draws its noise from
        its own generator, an idle slot draws none (its token is unused)."""
        noise = None
        if not self.greedy:
            noise = torch.zeros_like(self._logits)
            for s in np.flatnonzero(act):
                noise[s] = gumbel_noise((1, noise.shape[1]), self._generators[s],
                                        self.device)[0]
        return sample_tokens(self._logits, self.greedy, self.temperature, self.filter_frac,
                             noise)

    @torch.no_grad()
    def _generate(self, slots: np.ndarray, act: np.ndarray, n: int) -> torch.Tensor:
        mask, live = self._ctx_mask(), self._dev(act)[:, None]
        toks = torch.empty(self.capacity, n, dtype=torch.long, device=self.device)
        for i in range(n):
            toks[:, i] = tok = self._sample(act)
            t = self._dev(np.where(act, self._t_dec + i, self.max_tokens))
            logits = self.model.stream_decode_step(tok[:, None], self._dec, t, self._cross,
                                                   mask)
            self._logits = torch.where(live, logits.float(), self._logits)
        toks = toks[self._dev(slots)]
        for row, slot in enumerate(slots):
            self._tokens[slot].append(toks[row])
        self._t_dec[slots] += n
        return toks

    def generate(self, slots: Sequence[int], n: int) -> torch.Tensor:
        """Sample the next ``n`` listener codes of each listed slot against
        the context it has received; (len(slots), n)."""
        slots = self._check(slots)
        if not self._started[slots].all():
            raise ValueError("call start(slots, prompts) before generate()")
        if (self._t_dec[slots] + n > self.max_tokens).any():
            raise ValueError("token capacity exceeded; raise max_tokens")
        return self._generate(slots, self._act(slots), n)

    def round(self, slots: Sequence[int], speaker_chunks, audio_chunks,
              n: Optional[int] = None, n_valid=None) -> torch.Tensor:
        """One serving round for the listed slots, which must all have
        ``start()``ed: ``feed`` a chunk, then ``generate(n)`` codes (default
        ``chunk``)."""
        slots = self._check(slots)
        n = self.chunk if n is None else n
        if not self._started[slots].all():
            raise ValueError("call start(slots, prompts) before round()")
        sp, au, nv = self._chunks(slots, speaker_chunks, audio_chunks, n_valid)
        if (self._t_dec[slots] + n > self.max_tokens).any():
            raise ValueError("token capacity exceeded; raise max_tokens")
        act = self._act(slots)
        self._feed(slots, act, sp, au, nv)
        return self._generate(slots, act, n)

    def tokens(self, slot: int) -> torch.Tensor:
        """Every listener code generated for ``slot`` so far, (T,)."""
        if not self._tokens[slot]:
            return torch.zeros(0, dtype=torch.long, device=self.device)
        return torch.cat(self._tokens[slot])

    @torch.no_grad()
    def motion(self, slot: int, tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A slot's codes VQ-decoded to motion (T, 56); see
        ``StreamingListenerSession.motion``."""
        tokens = self.tokens(slot) if tokens is None else torch.as_tensor(tokens,
                                                                          device=self.device)
        return self.model.decode_tokens_to_motion(tokens.long()[None])[0]


class MeshSessionPool:
    """``StreamingSessionPool(model, mesh=devices, ...)``: ``capacity``
    slots over ``len(devices)`` pools of ``capacity / len(devices)``, one a
    device, each with its own replica of ``model``, behind the same methods. Global slot ``s`` is
    slot ``s % per`` of the pool on ``devices[s // per]``; ``join`` takes
    the lowest free global slot, as one pool does."""

    def __init__(self, model: SLMFT, *, capacity: int = 8, mesh: Sequence = (), **kwargs):
        devices = [torch.device(d) for d in mesh]
        if not devices or capacity % len(devices):
            raise ValueError("capacity must divide evenly over the mesh's data axis "
                             f"({len(devices)} devices)")
        self.capacity, self.per = capacity, capacity // len(devices)
        self.device = devices[0]
        self.pools = []
        for dev in devices:
            replica = model if dev == model_device(model) else copy.deepcopy(model).to(dev)
            self.pools.append(StreamingSessionPool(replica, capacity=self.per, **kwargs))
        self.model = self.pools[0].model
        self.chunk = self.pools[0].chunk

    def _split(self, slots: Sequence[int]):
        """The listed slots by pool: {pool index: (rows of the call, local slots)}."""
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            raise ValueError("empty slot list")
        if len(np.unique(slots)) != slots.size:
            raise ValueError("duplicate slots in one call")
        groups = {}
        for row, s in enumerate(slots):
            rows, local = groups.setdefault(int(s) // self.per, ([], []))
            rows.append(row)
            local.append(int(s) % self.per)
        return slots.size, groups

    def _pool(self, slot: int):
        return self.pools[slot // self.per], slot % self.per

    def join(self, seed: int = 0) -> int:
        for i, pool in enumerate(self.pools):
            if not pool._active.all():
                return i * self.per + pool.join(seed)
        raise RuntimeError("pool full; leave() a session or grow capacity")

    def leave(self, slot: int) -> None:
        pool, local = self._pool(slot)
        pool.leave(local)

    def active_slots(self) -> np.ndarray:
        return np.concatenate([i * self.per + p.active_slots()
                               for i, p in enumerate(self.pools)])

    def frames_fed(self, slot: int) -> int:
        pool, local = self._pool(slot)
        return pool.frames_fed(local)

    def tokens_generated(self, slot: int) -> int:
        pool, local = self._pool(slot)
        return pool.tokens_generated(local)

    @staticmethod
    def _rows(x, rows):
        """The call's rows ``rows`` of a per-slot argument; a scalar or None
        applies to every slot."""
        if x is None or np.ndim(x) == 0:
            return x
        return x[rows] if torch.is_tensor(x) else np.asarray(x)[rows]

    def feed(self, slots, speaker_chunks, audio_chunks, n_valid=None) -> None:
        _, groups = self._split(slots)
        for i, (rows, local) in groups.items():
            self.pools[i].feed(local, self._rows(speaker_chunks, rows),
                               self._rows(audio_chunks, rows),
                               self._rows(n_valid, rows))

    def start(self, slots, prompts) -> None:
        _, groups = self._split(slots)
        for i, (rows, local) in groups.items():
            self.pools[i].start(local, self._rows(prompts, rows))

    def _gather(self, n_rows: int, groups, parts) -> torch.Tensor:
        out = None
        for (rows, _), part in zip(groups.values(), parts):
            if out is None:
                out = torch.empty((n_rows,) + tuple(part.shape[1:]), dtype=part.dtype,
                                  device=self.device)
            out[torch.as_tensor(rows, device=self.device)] = part.to(self.device)
        return out

    def generate(self, slots, n: int) -> torch.Tensor:
        n_rows, groups = self._split(slots)
        return self._gather(n_rows, groups, [self.pools[i].generate(local, n)
                                             for i, (_, local) in groups.items()])

    def round(self, slots, speaker_chunks, audio_chunks, n=None, n_valid=None):
        n_rows, groups = self._split(slots)
        return self._gather(n_rows, groups, [
            self.pools[i].round(local, self._rows(speaker_chunks, rows),
                                self._rows(audio_chunks, rows), n,
                                self._rows(n_valid, rows))
            for i, (rows, local) in groups.items()])

    def tokens(self, slot: int) -> torch.Tensor:
        pool, local = self._pool(slot)
        return pool.tokens(local)

    def motion(self, slot: int, tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        pool, local = self._pool(slot)
        return pool.motion(local, tokens)
