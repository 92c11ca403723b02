"""The port's ``FusedAvatarPipeline`` (``serving/fused.py``) against its
composable ``StreamingAvatarPipeline`` on the CPU, stream for stream, at the
tiny SLMFT of ``tests/test_avatar.py:100-117`` and a small ``FaceGenerator``
at 64 x 64.

* Sampled codes (temperature 1, the session's generator, one seed) bitwise
  equal; float frames within 5e-5 (the fused round smooths in fp32 on the
  device, the host twin in float64: the bound of JAX's own fused test,
  ``tests/test_fused_avatar.py:91-92``); copy edges, uint8 frames within
  one level, and ``pipeline_depth`` 0.
* The lags ``d_raw``, ``d_sm``, ``d_win`` and ``latency_frames`` equal
  those of a JAX ``FusedAvatarPipeline`` built with the same arguments
  (construction compiles nothing in JAX; it allocates a JAX session's
  caches), the first round that emits frames and each round's count.
* JAX's guards and their messages (``tests/test_fused_avatar.py:125-164``).
"""

import time

import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.render import generator as JG
from dyadic_interaction_modeling_tpu.serving import FusedAvatarPipeline as JFused
from dyadic_interaction_modeling_tpu_torch.serving import (
    FusedAvatarPipeline,
    StreamingAvatarPipeline,
    StreamingListenerSession,
)
from tests.test_torch_avatar import RENDER, render_pair, pair, source, speaker_clip  # noqa: F401


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kw_of(chunk, rounds, **kw):
    return dict(vq_lookahead=kw.get("vq_lookahead", chunk),
                smooth_window=kw.get("smooth_window", 4), edge_mode=kw.get("edge_mode", "zero"),
                semantic_radius=kw.get("semantic_radius", 6),
                render_outputs=("fake_image",), render_uint8=kw.get("render_uint8", False))


def run_composable(tm, renderer, src, vs, va, *, chunk, rounds, seed=7, **kw):
    sess = StreamingListenerSession(tm, batch=vs.shape[0], chunk=chunk,
                                    max_frames=chunk * rounds,
                                    max_tokens=chunk * rounds + 1, seed=seed)
    pipe = StreamingAvatarPipeline(sess, vq_granularity=chunk, renderer=renderer,
                                   source_images=src, render_frames_per_call=chunk,
                                   **kw_of(chunk, rounds, **kw))
    outs = [pipe.push(vs[:, t: t + chunk], va[:, t: t + chunk])
            for t in range(0, chunk * rounds, chunk)]
    outs.append(pipe.flush())
    return (np.concatenate([o["tokens"] for o in outs], axis=1),
            np.concatenate([o["fake_image"] for o in outs], axis=1))


def run_fused(tm, renderer, src, vs, va, *, chunk, rounds, seed=7, pipeline_depth=1, **kw):
    pipe = FusedAvatarPipeline(tm, renderer=renderer, source_images=src, batch=vs.shape[0],
                               chunk=chunk, max_frames=chunk * rounds,
                               max_tokens=chunk * rounds + 1, seed=seed,
                               pipeline_depth=pipeline_depth, **kw_of(chunk, rounds, **kw))
    outs = [pipe.push(vs[:, t: t + chunk], va[:, t: t + chunk])
            for t in range(0, chunk * rounds, chunk)]
    outs.append(pipe.flush())
    return (pipe, outs, np.concatenate([o["tokens"] for o in outs], axis=1),
            np.concatenate([o["fake_image"] for o in outs], axis=1))


def test_fused_matches_composable_and_jax_lags(pair, render_pair):
    jm, params, tm = pair
    chunk, rounds = 4, 8
    t_total = chunk * rounds
    src = source()
    vs, va = speaker_clip(1, t_total)
    h_toks, h_fake = run_composable(tm, render_pair[1], src, vs, va, chunk=chunk, rounds=rounds)
    pipe, outs, f_toks, f_fake = run_fused(tm, render_pair[1], src, vs, va, chunk=chunk,
                                           rounds=rounds)
    np.testing.assert_array_equal(f_toks, h_toks)
    assert f_toks.shape == (1, t_total) and len(np.unique(f_toks)) > 1  # sampled
    assert f_fake.shape == h_fake.shape == (1, t_total, 64, 64, 3)
    np.testing.assert_allclose(f_fake, h_fake, rtol=0, atol=5e-5)

    # d_win = 1 + 1 + 2 = 4 and a double-buffered download: the first frames
    # come on round 6, then a chunk a round, the rest at flush
    assert (pipe.d_raw, pipe.d_sm, pipe.d_win) == (1, 2, 4)
    assert pipe.latency_frames == (4 + 1) * chunk
    counts = [o["fake_image"].shape[1] for o in outs]
    assert counts == [0] * 5 + [chunk] * (rounds - 5) + [t_total - (rounds - 5) * chunk]
    # round 1 runs through the session; the codes of round k >= 2 come with k + 1
    assert [o["tokens"].shape[1] for o in outs] == [chunk, 0] + [chunk] * (rounds - 1)

    # the lags of a JAX pipeline built with the same arguments
    start = time.perf_counter()
    ref = JFused(jm, params, renderer=JG.FaceGenerator(**RENDER), render_params=None,
                 source_images=src, batch=1, chunk=chunk, max_frames=t_total,
                 max_tokens=t_total + 1, rng=7, **kw_of(chunk, rounds))
    assert time.perf_counter() - start < 10  # a JAX session's caches; nothing compiled
    assert ((ref.d_raw, ref.d_sm, ref.d_win, ref.latency_frames)
            == (pipe.d_raw, pipe.d_sm, pipe.d_win, pipe.latency_frames))


def test_fused_copy_edges_uint8_and_unbuffered(pair, render_pair):
    jm, params, tm = pair
    chunk, rounds = 4, 7
    src = source(2)
    vs, va = speaker_clip(2, chunk * rounds, seed=9)
    kw = dict(smooth_window=6, edge_mode="copy", semantic_radius=6, render_uint8=True)
    h_toks, h_fake = run_composable(tm, render_pair[1], src, vs, va, chunk=chunk,
                                    rounds=rounds, **kw)
    pipe, outs, f_toks, f_fake = run_fused(tm, render_pair[1], src, vs, va, chunk=chunk,
                                           rounds=rounds, pipeline_depth=0, **kw)
    np.testing.assert_array_equal(f_toks, h_toks)
    assert f_fake.dtype == np.uint8 and f_fake.shape == h_fake.shape == (2, 28, 64, 64, 3)
    assert np.abs(f_fake.astype(int) - h_fake.astype(int)).max() <= 1
    # unbuffered: frames from round d_win + 1 = 5 on
    assert pipe.d_win == 4 and pipe.latency_frames == 4 * chunk
    assert [o["fake_image"].shape[1] for o in outs] == [0] * 4 + [chunk] * 3 + [16]
    ref = JFused(jm, params, renderer=JG.FaceGenerator(**RENDER), render_params=None,
                 source_images=src, batch=2, chunk=chunk, max_frames=chunk * rounds,
                 pipeline_depth=0, **kw_of(chunk, rounds, **kw))
    assert (ref.d_sm, ref.d_win, ref.latency_frames) == (pipe.d_sm, pipe.d_win,
                                                         pipe.latency_frames)


def test_fused_guards(pair, render_pair):
    tm, renderer = pair[2], render_pair[1]
    src = source()
    vs, va = speaker_clip(1, 8)

    def build(**kw):
        args = dict(renderer=renderer, source_images=src, chunk=4, vq_lookahead=4,
                    max_frames=16, semantic_radius=6)
        args.update(kw)
        return FusedAvatarPipeline(tm, **args)

    with pytest.raises(ValueError, match="multiple"):
        build(vq_lookahead=6)
    with pytest.raises(ValueError, match="multiple"):
        build(vq_lookahead=0)
    with pytest.raises(ValueError, match="even window"):
        build(smooth_window=5)
    with pytest.raises(ValueError, match="even window"):
        build(edge_mode="wrap")
    with pytest.raises(ValueError, match="one source face per"):
        build(batch=2)

    pipe = build(max_frames=8, max_tokens=16)
    pipe.push(vs[:, :4], va[:, :4])
    pipe.push(vs[:, 4:8], va[:, 4:8])
    with pytest.raises(ValueError, match="context capacity"):
        pipe.push(vs[:, :4], va[:, :4])
    pipe.flush()
    with pytest.raises(ValueError, match="flushed"):
        pipe.flush()
    with pytest.raises(ValueError, match="flushed"):
        pipe.push(vs[:, :4], va[:, :4])

    pipe = build(max_frames=16, max_tokens=8)  # the prompt takes a token
    pipe.push(vs[:, :4], va[:, :4])
    with pytest.raises(ValueError, match="token capacity"):
        pipe.push(vs[:, 4:8], va[:, 4:8])
    assert pipe.frames_fed == 4
