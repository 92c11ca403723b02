"""The serving paths on the card at full width: the streaming listener
session, the session pool, the streaming speaker session, the streaming
audio front-end, and the live avatar chain (fused and composable pipelines)
at ``bench.py``'s avatar shape. Launches are counted; each path is held
against the offline path or the plain versions of its kernels.

Marked ``cuda`` (skipped where no card is present). On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_cuda.py
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from torch_card import (BIWI_L, BIWI_VDIM, L, RENDER_RES, biwi_batch, candor,  # noqa: F401
                        card, counted, launches, plain_attention, slmft, speaker_model)

pytestmark = pytest.mark.cuda

STREAM_B, CHUNK, STREAM_ROUNDS = 4, 8, 31
K1_PER_CODE = 2 * 4  # self and cross in slm_defaults' 4 decoder layers


def _first_divergence(a, b):
    differ = (a != b).any(dim=0).nonzero()
    return None if differ.numel() == 0 else int(differ[0])


def test_streaming_listener_session(card):
    """``StreamingListenerSession`` on SLMFT, batch STREAM_B, chunk 8,
    max_frames L. In bf16: one feed, ``start`` from
    ``tokenize_listener_frames`` (K4 once), then STREAM_ROUNDS rounds of 8
    frames and 8 codes: K1 8 a code and for the prompt step, no K2/K3 (the
    chunk extension is dense). In fp32: the fed context rows against the
    offline ``decoder_context`` (1e-4); a session fed the whole clip, one
    code sequence teacher-forced through ``stream_decode_step`` with the
    kernels and with the plain versions (logits within 1e-3); where greedy
    streaming first departs from offline ``generate_tokens`` is printed
    (exactness is held on the CPU, against JAX)."""
    from dyadic_interaction_modeling_tpu_torch.models.xtrans import generate_tokens
    from dyadic_interaction_modeling_tpu_torch.serving import StreamingListenerSession

    vs, vl, va, mask = candor(STREAM_B, seed=51)
    c = CHUNK
    model = slmft(seed=2).to("cuda", torch.bfloat16).eval()
    sess = StreamingListenerSession(model, batch=STREAM_B, chunk=c, max_frames=L, seed=0)
    with counted() as got:
        sess.feed(vs[:, :c], va[:, :c])
        with torch.no_grad():
            sess.start(model.tokenize_listener_frames(vl[:, :c])[:, :1])
        for r in range(1, STREAM_ROUNDS + 1):
            sess.round(vs[:, r * c: (r + 1) * c], va[:, r * c: (r + 1) * c])
    n_tok = STREAM_ROUNDS * c
    assert got == launches(decode_attention=K1_PER_CODE * (1 + n_tok), nearest_code=1)
    toks = sess.tokens()
    assert tuple(toks.shape) == (STREAM_B, n_tok) and bool(((toks >= 0) & (toks < 512)).all())
    assert sess.frames_fed == L
    del sess, model

    model = slmft(seed=2).to("cuda").eval()
    sessions = [StreamingListenerSession(model, batch=STREAM_B, chunk=c, max_frames=L,
                                         greedy=True) for _ in range(2)]
    rows = torch.cat([sessions[0].feed(vs[:, t: t + c], va[:, t: t + c])
                      for t in range(0, L, c)], dim=1)
    for t in range(0, L, c):
        sessions[1].feed(vs[:, t: t + c], va[:, t: t + c])
    with torch.no_grad():
        ctx, prompt = model.encode_context(vs, vl, va, mask)
        offline = generate_tokens(model.decoder, prompt, L - 1, ctx, mask, greedy=True)
    ctx_err = float((rows - ctx).abs().max())
    assert ctx_err <= 1e-4, ctx_err
    g = torch.Generator(device="cuda").manual_seed(5)
    seq = torch.cat([prompt, torch.randint(0, 512, (STREAM_B, L - 1), device="cuda",
                                           generator=g)], dim=1)
    worst = 0.0
    with torch.no_grad():
        for t in range(L):
            a = model.stream_decode_step(seq[:, t: t + 1], sessions[0]._dec, t,
                                         sessions[0]._cross, sessions[0]._ctx_mask())
            with plain_attention():
                b = model.stream_decode_step(seq[:, t: t + 1], sessions[1]._dec, t,
                                             sessions[1]._cross, sessions[1]._ctx_mask())
            worst = max(worst, float((a - b).abs().max()))
    assert worst <= 1e-3, worst
    greedy = StreamingListenerSession(model, batch=STREAM_B, chunk=c, max_frames=L, greedy=True)
    for t in range(0, L, c):
        greedy.feed(vs[:, t: t + c], va[:, t: t + c])
    greedy.start(prompt)
    streamed = greedy.generate(L - 1)
    print(f"fp32 greedy streaming vs offline generate_tokens: first divergence at code "
          f"{_first_divergence(streamed, offline)}")


POOL_P, POOL_ROUNDS, POOL_LEAVE = 8, 24, (2, 12)


def _pool_schedule(pool, clips, model, rounds, on_round=None):
    """Streams join one a round (slot s's stream at round s) until the pool
    is full, each fed its first chunk and started from the code of its first
    listener frame (``tokenize_listener_frames``, K4); every started slot
    then does a ``round`` (8 frames, 8 codes) each round. At round
    POOL_LEAVE[1] the stream of slot POOL_LEAVE[0] leaves and a new one (the
    clips' last) takes its slot. ``clips``: (speaker, audio, listener)."""
    c = pool.chunk
    owner, pos = {}, {}
    for r in range(rounds):
        if r == POOL_LEAVE[1]:
            pool.leave(POOL_LEAVE[0])
            owner.pop(POOL_LEAVE[0])
        started = sorted(owner)
        if started:
            sp = torch.stack([clips[0][owner[s], pos[s]: pos[s] + c] for s in started])
            au = torch.stack([clips[1][owner[s], pos[s]: pos[s] + c] for s in started])
            pool.round(started, sp, au)
            for s in started:
                pos[s] += c
        stream = r if r < pool.capacity else (len(clips[0]) - 1 if r == POOL_LEAVE[1] else None)
        if stream is not None:
            s = pool.join(seed=100 + stream)
            owner[s], pos[s] = stream, c
            pool.feed([s], clips[0][stream:stream + 1, :c], clips[1][stream:stream + 1, :c])
            with torch.no_grad():
                prompt = model.tokenize_listener_frames(clips[2][stream:stream + 1, :c])
            pool.start([s], prompt[:, :1])
        if on_round is not None:
            on_round(r)


def test_session_pool(card):
    """``StreamingSessionPool`` at capacity POOL_P: staggered joins, a leave
    and a reused slot. In bf16: K4 once a join, K1 on every step, no K2/K3;
    one ``generate`` of n codes launches K1 n x 8 at 3 and at 8 slots (one
    launch a layer and step serves every slot, each slot's bound a key
    mask). In fp32 and greedy: each slot's logits against a solo session's
    over the same stream, while their codes agree (1e-4)."""
    from dyadic_interaction_modeling_tpu_torch import kernels
    from dyadic_interaction_modeling_tpu_torch.serving import (
        StreamingListenerSession, StreamingSessionPool)

    n_streams = POOL_P + 1
    vs, vl, va, _ = candor(n_streams, seed=61)
    c = CHUNK
    model = slmft(seed=3).to("cuda", torch.bfloat16).eval()
    pool = StreamingSessionPool(model, capacity=POOL_P, chunk=c, max_frames=L)
    per_generate = {}

    def on_round(r):
        slots = {3: [0, 1, 2], POOL_P: list(range(POOL_P))}.get(r)
        if slots:
            before = dict(kernels.LAUNCHES)
            pool.generate(slots, 4)
            torch.cuda.synchronize()
            per_generate[len(slots)] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}

    with counted() as got:
        _pool_schedule(pool, (vs, va, vl), model, POOL_ROUNDS, on_round)
    assert got["nearest_code"] == n_streams and got["flash_attention_fwd"] == 0
    assert got["decode_attention"] > 0
    assert len(per_generate) == 2 and all(
        v == launches(decode_attention=4 * K1_PER_CODE) for v in per_generate.values())
    assert all(bool(((pool.tokens(s) >= 0) & (pool.tokens(s) < 512)).all())
               for s in range(POOL_P))
    del pool, model

    model = slmft(seed=3).to("cuda").eval()
    pool = StreamingSessionPool(model, capacity=POOL_P, chunk=c, max_frames=L, greedy=True)
    solos = {}
    worst, compared = 0.0, 0

    def compare(r):
        nonlocal worst, compared
        for s, sess in solos.items():
            if pool.tokens(s).numel() and torch.equal(pool.tokens(s), sess.tokens()[0]):
                worst = max(worst, float((pool._logits[s] - sess._logits[0]).abs().max()))
                compared += 1

    class Shadow:
        """Drives a solo session for every pool slot alongside the pool."""

        def __init__(self, inner):
            self.inner, self.capacity, self.chunk = inner, inner.capacity, inner.chunk

        def join(self, seed):
            s = self.inner.join(seed)
            solos[s] = StreamingListenerSession(model, batch=1, chunk=c, max_frames=L,
                                                greedy=True)
            return s

        def leave(self, s):
            self.inner.leave(s)
            solos.pop(s)

        def feed(self, slots, sp, au):
            self.inner.feed(slots, sp, au)
            solos[slots[0]].feed(sp, au)

        def start(self, slots, prompt):
            self.inner.start(slots, prompt)
            solos[slots[0]].start(prompt)

        def round(self, slots, sp, au):
            self.inner.round(slots, sp, au)
            for i, s in enumerate(slots):
                solos[s].round(sp[i: i + 1], au[i: i + 1])

    _pool_schedule(Shadow(pool), (vs, va, vl), model, 12, compare)
    assert compared > 0 and worst <= 1e-4, (compared, worst)


def test_streaming_speaker_session(card):
    """``StreamingSpeakerSession`` at the BIWI width, fp32, fed a whole clip
    of BIWI_L frames (chunk 8), started from the clip's prompt and
    generating BIWI_L - 1 codes greedily: K1 8 a code and for the prompt
    step, no K4; its ``mesh`` within 1e-4 of the offline decode of the same
    codes. Where it first departs from ``make_speaker_generator`` greedy is
    printed."""
    from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_speaker_generator
    from dyadic_interaction_modeling_tpu_torch.serving import StreamingSpeakerSession

    model = speaker_model(seed=0).to("cuda").eval()
    clip = tuple(x[:1] for x in biwi_batch(1, seed=71))
    verts, emoca, audio, mask, template, sids = clip
    with torch.no_grad():
        offline = make_speaker_generator(model)(clip, None, 1, greedy=True,
                                                return_tokens=True)[1]
        prompt = model.encode_context(*clip)[1]
    c = CHUNK
    with counted() as got:
        sess = StreamingSpeakerSession(model, chunk=c, max_frames=BIWI_L, speaker_ids=sids,
                                       greedy=True)
        for t in range(0, BIWI_L, c):
            sess.feed(audio[:, t: t + c])
        sess.start(prompt)
        toks = sess.generate(BIWI_L - 1)
    assert got["decode_attention"] == K1_PER_CODE * BIWI_L and got["nearest_code"] == 0, got
    print(f"fp32 greedy speaker session vs make_speaker_generator: first divergence at code "
          f"{_first_divergence(toks, offline)}")
    mesh, emo = sess.mesh(template)
    with torch.no_grad():
        ref_mesh, ref_emo = model.decode_emoca(toks, from_logits=False)
    err = max(float((mesh - ref_mesh - template[:, None]).abs().max()),
              float((emo - ref_emo).abs().max()))
    assert tuple(mesh.shape) == (1, BIWI_L - 1, BIWI_VDIM) and err <= 1e-4, err


def test_streaming_audio_frontend(card):
    """``StreamingAudioFrontend`` on the HuBERT-base trunk, fp32: batch 4,
    fps 30, chunk 8, window 60, lookahead 2, over 4 s of audio pushed in
    irregular pieces, against one whole push: bitwise-equal emissions."""
    from dyadic_interaction_modeling_tpu_torch.models.hubert import HubertModel
    from dyadic_interaction_modeling_tpu_torch.serving import StreamingAudioFrontend

    torch.manual_seed(0)
    model = HubertModel().to("cuda").eval()
    kw = dict(fps=30, chunk=8, window_frames=60, lookahead=2, batch=4)
    wave = torch.randn(4, 4 * 16000, generator=torch.Generator().manual_seed(51)).numpy()
    whole = StreamingAudioFrontend(model, **kw).push(wave)
    fe, outs, at = StreamingAudioFrontend(model, **kw), [], 0
    for n in itertools.cycle((1601, 37, 5000, 12345, 999)):
        got = fe.push(wave[:, at: at + n])
        if got is not None:
            outs.append(got)
        at += n
        if at >= wave.shape[1]:
            break
    pieces = torch.cat(outs, dim=1)
    assert tuple(whole.shape) == (4, fe.frames_emitted, 768)
    assert torch.equal(pieces, whole)


# the live avatar chain at bench.py's avatar shape (bench.py:55, 64-65, 429-445)
AVATAR_MAX, AVATAR_WINDOW, AVATAR_ROUNDS = 1024, 10, 24
AVATAR_STREAM = 48  # chunks of speaker input
AVATAR_RENDER = dict(flame_coeff_nc=56, coeff_nc=73, descriptor_nc=256, mapping_layers=3)
# a steady round of either pipeline: K1 8 a code (self and cross in
# slm_defaults' 4 decoder layers) x 8 codes; K2 once in each of the listener
# VQ decoder's 6 layers, one masked decode of the 1024-token buffer (L >=
# FLASH_MIN_LEN under a key mask)
AVATAR_ROUND = dict(decode_attention=64, flash_attention_fwd=6)


def _avatar_inputs():
    """``bench.py``'s low-frequency 256 x 256 source (1, H, W, 3) and
    AVATAR_STREAM chunks of speaker motion (1, T, 56) and audio (1, T, 768),
    seeded, numpy as a server receives them."""
    lin = np.linspace(0, 6.0, RENDER_RES)
    src = np.sin(lin[:, None, None] + 1.7 * lin[None, :, None] + np.arange(3)) * 0.7
    rng = np.random.default_rng(73)
    t = AVATAR_STREAM * CHUNK
    return (src[None].astype(np.float32), rng.standard_normal((1, t, 56), dtype=np.float32),
            rng.standard_normal((1, t, 768), dtype=np.float32))


def _renderer(dtype=torch.float32, warp_dtype=None):
    """``FaceGenerator`` at AVATAR_RENDER, seeded, on the card."""
    from dyadic_interaction_modeling_tpu_torch.render.generator import FaceGenerator

    torch.manual_seed(72)
    sd = FaceGenerator(**AVATAR_RENDER).state_dict()
    m = FaceGenerator(**AVATAR_RENDER, dtype=dtype, warp_dtype=warp_dtype)
    m.load_state_dict(sd, strict=True)
    return m.to("cuda").eval()


def _avatar_pipes(model, renderer, src, *, uint8=True, lookahead=CHUNK, depth=1):
    """The two pipelines of ``bench.py``'s avatar shape (batch 1, chunk 8,
    1024 frames and tokens, window 10, radius 13, the fake image only), one
    session seed and the zero prompt: {"fused": ..., "composable": ...} as
    factories."""
    from dyadic_interaction_modeling_tpu_torch.serving import (
        FusedAvatarPipeline, StreamingAvatarPipeline, StreamingListenerSession)

    c = CHUNK

    def fused():
        return FusedAvatarPipeline(
            model, renderer=renderer, source_images=src, chunk=c, max_frames=AVATAR_MAX,
            max_tokens=AVATAR_MAX, seed=7, vq_lookahead=lookahead,
            smooth_window=AVATAR_WINDOW, semantic_radius=13, render_uint8=uint8,
            pipeline_depth=depth)

    def composable():
        sess = StreamingListenerSession(model, chunk=c, max_frames=AVATAR_MAX,
                                        max_tokens=AVATAR_MAX, seed=7)
        return StreamingAvatarPipeline(
            sess, vq_lookahead=lookahead, vq_granularity=c, smooth_window=AVATAR_WINDOW,
            semantic_radius=13, renderer=renderer, source_images=src,
            render_frames_per_call=c, render_outputs=("fake_image",), render_uint8=uint8,
            render_pipeline_depth=depth)

    return {"fused": fused, "composable": composable}


def _push(pipe, sp, au, i):
    return pipe.push(sp[:, i * CHUNK: (i + 1) * CHUNK], au[:, i * CHUNK: (i + 1) * CHUNK])


def _avatar_stream(pipe, sp, au, n):
    """n chunks pushed, then flush: (per-call outputs, codes, frames)."""
    outs = [_push(pipe, sp, au, i) for i in range(n)]
    outs.append(pipe.flush())
    return (outs, np.concatenate([o["tokens"] for o in outs], axis=1),
            np.concatenate([o["fake_image"] for o in outs], axis=1))


def _assert_k1_at_a_round(pipe, sp, au, i, tol):
    """K1 at the avatar's own calls: the push of chunk i with every
    ``decode_attention`` call recorded (its inputs copied, since the caches
    change in place), then each call's inputs through the kernel and its
    plain version: AVATAR_ROUND's calls, within tol."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.decode import (
        decode_attention, decode_attention_plain)
    from dyadic_interaction_modeling_tpu_torch.models import xtrans

    calls = []

    def record(q, k, v, t=None, key_mask=None, *, scale):
        calls.append((*(x.clone() if isinstance(x, torch.Tensor) else x
                        for x in (q, k, v, t, key_mask)), scale))
        return decode_attention(q, k, v, t, key_mask, scale=scale)

    with mock.patch.object(xtrans, "decode_attention", record):
        _push(pipe, sp, au, i)
    worst = 0.0
    for q, k, v, t, km, scale in calls:
        out = decode_attention(q, k, v, t, km, scale=scale)
        ref = decode_attention_plain(q, k, v, t, km, scale=scale)
        worst = max(worst, float((out.float() - ref.float()).abs().max()))
    assert len(calls) == AVATAR_ROUND["decode_attention"] and worst <= tol, (len(calls), worst)


@pytest.mark.parametrize("uint8", [False, True])
def test_avatar_fused_equals_composable(card, uint8):
    """fp32 (TF32 off): ``FusedAvatarPipeline`` against
    ``StreamingAvatarPipeline`` (granularity = chunk) on one seeded stream
    of AVATAR_ROUNDS chunks, one session seed: codes bitwise equal, float
    frames within 5e-5 (uint8 within one level), as many frames as fed, the
    fused pipeline's first frames on the round d_win + pipeline_depth + 1."""
    src, sp, au = _avatar_inputs()
    n, c = AVATAR_ROUNDS, CHUNK
    pipes = _avatar_pipes(slmft(seed=71).to("cuda").eval(), _renderer(), src, uint8=uint8)
    fused = pipes["fused"]()
    f_outs, f_toks, f_frames = _avatar_stream(fused, sp, au, n)
    _, c_toks, c_frames = _avatar_stream(pipes["composable"](), sp, au, n)
    assert np.array_equal(f_toks, c_toks) and f_toks.shape == (1, n * c)
    assert f_frames.shape == c_frames.shape == (1, n * c, RENDER_RES, RENDER_RES, 3)
    err = float(np.abs(f_frames.astype(np.float64) - c_frames).max())
    assert err <= (1 if uint8 else 5e-5), err
    first = next(i for i, o in enumerate(f_outs) if o["fake_image"].shape[1])
    assert first == fused.d_win + fused.pipeline_depth


def test_avatar_live_equals_the_offline_chain(card):
    """fp32: the composable pipeline with ``vq_lookahead=None`` against the
    offline chain on its codes (``decode_tokens_to_motion``,
    ``smooth_logits_matrix``, ``semantic_window`` a frame,
    ``render_windows``) within one uint8 level; then K1 at the calls of a
    steady fused round (self and cross, caches of 1024, the (1, 1024)
    context mask) against its plain version (1e-5)."""
    from dyadic_interaction_modeling_tpu_torch.postprocess import smooth_logits_matrix
    from dyadic_interaction_modeling_tpu_torch.render.data import semantic_window
    from dyadic_interaction_modeling_tpu_torch.render.inference import (
        render_windows, to_uint8_frame)
    from dyadic_interaction_modeling_tpu_torch.serving import (
        StreamingAvatarPipeline, StreamingListenerSession)

    src, sp, au = _avatar_inputs()
    c = CHUNK
    model, r32 = slmft(seed=71).to("cuda").eval(), _renderer()
    sess = StreamingListenerSession(model, chunk=c, max_frames=AVATAR_MAX,
                                    max_tokens=AVATAR_MAX, seed=7)
    live = StreamingAvatarPipeline(
        sess, vq_lookahead=None, smooth_window=AVATAR_WINDOW, semantic_radius=13,
        renderer=r32, source_images=src, render_frames_per_call=c,
        render_outputs=("fake_image",), render_uint8=True)
    _, toks, frames = _avatar_stream(live, sp, au, AVATAR_ROUNDS)
    t_total = toks.shape[1]
    with torch.no_grad():
        coeffs = model.decode_tokens_to_motion(
            torch.as_tensor(toks, device="cuda").long(),
            torch.full((1,), t_total, device="cuda")).float().cpu().numpy()[0]
    smoothed = smooth_logits_matrix(coeffs, AVATAR_WINDOW)
    windows = np.stack([semantic_window(smoothed, i, 13) for i in range(t_total)])
    offline = to_uint8_frame(render_windows(r32, src[0], windows, batch_size=c)["fake_image"])
    assert frames.shape[1] == t_total
    assert int(np.abs(frames[0].astype(int) - offline.astype(int)).max()) <= 1
    pipe = _avatar_pipes(model, r32, src)["fused"]()
    for i in range(3):
        _push(pipe, sp, au, i)
    _assert_k1_at_a_round(pipe, sp, au, 3, 1e-5)


def test_avatar_bf16_kernels_and_no_sync(card):
    """bf16: K2 at the masked decode's calls ((8, 1024, 48), a key mask of
    lengths 8 k for k in 3, 24, 128) against its plain version (2e-2
    absolute and relative); steady fused rounds 2-4 enqueue with no
    synchronizing call (``torch.cuda.set_sync_debug_mode``), a pipeline that
    keeps every download in flight; K1 at the calls of the next round
    against its plain version (2e-2)."""
    import warnings
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    from dyadic_interaction_modeling_tpu_torch.ops import transformer

    src, sp, au = _avatar_inputs()
    c = CHUNK
    model = slmft(seed=71).to("cuda", torch.bfloat16).eval()
    calls, real = [], transformer.flash_attention

    def record(q, k, v, key_mask=None, **kw):
        calls.append((q, k, v, key_mask, kw))
        return real(q, k, v, key_mask, **kw)

    g = torch.Generator(device="cuda").manual_seed(74)
    buf = torch.randint(0, 512, (1, AVATAR_MAX), device="cuda", generator=g)
    for k_round in (3, 24, 128):
        calls.clear()
        with mock.patch.object(transformer, "flash_attention", record), torch.no_grad():
            model.decode_tokens_to_motion(buf, torch.full((1,), c * k_round, device="cuda"))
        worst, shapes = 0.0, set()
        for q, k, v, km, kw in calls:
            o = flash_attention_fwd(q, k, v, km, **kw)[0]
            ro = flash_attention_fwd_plain(q, k, v, km, **kw)[0]
            worst = max(worst, float(((o.float() - ro.float()).abs()
                                      - 2e-2 * ro.float().abs()).max()))
            shapes.add((tuple(q.shape), q.dtype, None if km is None else tuple(km.shape)))
        assert len(calls) == 6
        assert shapes == {((8, AVATAR_MAX, 48), torch.bfloat16, (1, AVATAR_MAX))}
        assert worst <= 2e-2, worst

    pipe = _avatar_pipes(model, _renderer(torch.bfloat16), src, depth=AVATAR_MAX)["fused"]()
    _push(pipe, sp, au, 0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(1, 4):
                _push(pipe, sp, au, i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:160] for w in caught if "called a synchronizing" in str(w.message)]
    assert not syncs, syncs[:3]
    _assert_k1_at_a_round(pipe, sp, au, 4, 2e-2)
    pipe.flush()


@pytest.mark.parametrize("warp", [None, torch.float32])
@pytest.mark.parametrize("name", ["fused", "composable"])
def test_avatar_round_launches(card, name, warp):
    """Each pipeline in the bench config (bf16 SLMFT, bf16 generator and
    warp) and the mixed one (fp32 warp), filled until its first frames and
    one round more: the launches of a steady round."""
    src, sp, au = _avatar_inputs()
    model = slmft(seed=71).to("cuda", torch.bfloat16).eval()
    pipe = _avatar_pipes(model, _renderer(torch.bfloat16, warp), src)[name]()
    i = 0
    while _push(pipe, sp, au, i)["fake_image"].shape[1] == 0:
        i += 1
    _push(pipe, sp, au, i + 1)
    with counted() as got:
        _push(pipe, sp, au, i + 2)
    assert got == launches(**AVATAR_ROUND)
