"""The port's live avatar operators (``serving/avatar.py``) and post-processing
(``postprocess/smoothing.py``) against the JAX package on the CPU.

* ``smooth_logits_matrix`` (zero and copy edges, T < window),
  ``export_emoca_dirs`` and ``merge_biwi_to_emoca``: bitwise, files byte
  for byte; ``StreamingSmoother`` and ``StreamingSemanticWindower`` equal to
  JAX's for random push slicings, the guards included.
* ``StreamingCoeffDecoder`` at the JAX tests' tiny SLMFT
  (``tests/test_avatar.py:100-117``): push invariance exact within the port;
  the lookahead horizons, granularity 4 and ``lookahead=None`` within
  2e-4 / 2e-5 of JAX's unpadded prefix decode; the capacity guard leaving
  the state intact.
* ``StreamingRenderer`` on a small ``FaceGenerator`` at 64 x 64 (at 32 x 32
  the hourglass reaches 1 x 1, where instance norm raises): frames within
  1e-4 of JAX's generator on the same windows, uint8 within one level of the
  float frames, the double-buffered stream equal to the plain one.
* ``StreamingAvatarPipeline`` with ``vq_lookahead=None`` and a greedy
  session: each stage against a JAX reference on the port's codes (decode
  2e-4 / 2e-5, smoothing 1e-12, windows 1e-6, frames 1e-4), and the
  emission counts of a bounded lookahead.

The weights go JAX -> port through ``utils/weights.py`` (JAX's params come
from a seeded port model through JAX's importers, so no JAX init is
compiled). JAX's decode and generator are jitted at one shape each.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.models import slm as JS
from dyadic_interaction_modeling_tpu.postprocess import smoothing as JP
from dyadic_interaction_modeling_tpu.render import generator as JG
from dyadic_interaction_modeling_tpu.render.data import semantic_window as j_semantic_window
from dyadic_interaction_modeling_tpu.render.import_torch import torch_face_generator_to_flax
from dyadic_interaction_modeling_tpu.serving import avatar as JA
from dyadic_interaction_modeling_tpu_torch.postprocess import smoothing as TP
from dyadic_interaction_modeling_tpu_torch.render import generator as TG
from dyadic_interaction_modeling_tpu_torch.serving import (
    StreamingAvatarPipeline,
    StreamingCoeffDecoder,
    StreamingListenerSession,
    StreamingRenderer,
    StreamingSemanticWindower,
    StreamingSmoother,
)
from dyadic_interaction_modeling_tpu_torch.serving.avatar import listener_decode_fn
from dyadic_interaction_modeling_tpu_torch.utils.weights import jax_face_generator_to_state_dict
from tests.test_torch_streaming import slmft_pair

RENDER = dict(flame_coeff_nc=56, coeff_nc=24, descriptor_nc=32, mapping_layers=1)
RES, RADIUS = 64, 6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_slices(rng, total):
    cuts, t = [], 0
    while t < total:
        n = min(int(rng.integers(1, 5)), total - t)
        cuts.append(n)
        t += n
    return cuts


def stream(op, x, slices, axis=-2):
    """Push ``x`` through a streaming operator in ``slices``, then flush."""
    parts, t = [], 0
    for n in slices:
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(t, t + n)
        parts.append(op.push(x[tuple(idx)]))
        t += n
    parts.append(op.flush())
    return parts


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# --- postprocess.smoothing -------------------------------------------------

@pytest.mark.parametrize("t_total,window,edge_mode", [
    (23, 10, "zero"), (23, 10, "copy"), (7, 10, "zero"), (7, 10, "copy"), (11, 4, "zero")])
def test_smooth_logits_matrix_is_bitwise_jax(t_total, window, edge_mode):
    x = np.random.default_rng(t_total + window).normal(size=(t_total, 5))
    got = TP.smooth_logits_matrix(x, window, edge_mode)
    want = JP.smooth_logits_matrix(x, window, edge_mode)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_export_and_biwi_merge_write_jax_files(tmp_path):
    rng = np.random.default_rng(1)
    coeffs = rng.normal(size=(14, 56))
    gt = {f"frame_{i:03d}": {"cam": rng.normal(size=3), "shape": rng.normal(size=100)}
          for i in range(1, 13)}
    gt["frame_999"] = {"cam": np.zeros(3)}   # past the clip: skipped
    gt["bad_name"] = {"cam": np.zeros(3)}    # unparsable: skipped
    for mod, name in ((TP, "port"), (JP, "jax")):
        mod.export_emoca_dirs(str(tmp_path / name / "emoca"), "clip0", coeffs)
        mod.export_emoca_dirs(str(tmp_path / name / "raw"), "clip0", coeffs, smooth_window=None)
        mod.merge_biwi_to_emoca(str(tmp_path / name / "biwi"), "F1_01", coeffs, gt)
    port, ref = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert len(port) == 14 * 2 * 2 + 12 * 4 and port == ref


def test_streaming_smoother_equals_jax_and_offline():
    rng = np.random.default_rng(0)
    for t_total in (3, 7, 10, 11, 23):
        for window in (4, 10):
            for edge_mode in ("zero", "copy"):
                x = rng.normal(size=(2, t_total, 3))
                slices = random_slices(rng, t_total)
                got = stream(StreamingSmoother(window, edge_mode), x, slices)
                want = stream(JA.StreamingSmoother(window, edge_mode), x, slices)
                for g, w in zip(got, want):
                    assert g.shape == w.shape and np.array_equal(g, w)
                streamed = np.concatenate([p for p in got if p.shape[-2]], axis=-2)
                for b in range(2):
                    np.testing.assert_allclose(
                        streamed[b], TP.smooth_logits_matrix(x[b], window, edge_mode),
                        rtol=0, atol=1e-12, err_msg=f"T={t_total} w={window} {edge_mode}")
    for bad in (dict(window=5), dict(edge_mode="wrap")):
        with pytest.raises(ValueError):
            StreamingSmoother(**bad)


def test_streaming_windower_equals_jax_and_offline():
    rng = np.random.default_rng(2)
    coeffs = rng.normal(size=(17, 5)).astype(np.float32)
    for radius in (2, 6):
        slices = random_slices(rng, 17)
        got = stream(StreamingSemanticWindower(radius), coeffs[None], slices)
        want = stream(JA.StreamingSemanticWindower(radius), coeffs[None], slices)
        assert [len(p) for p in got] == [len(p) for p in want]
        windows = sum(got, [])
        assert len(windows) == 17
        for i, (g, w) in enumerate(zip(windows, sum(want, []))):
            assert g.shape == (1, 5, 2 * radius + 1) and np.array_equal(g, w)
            np.testing.assert_array_equal(g[0], j_semantic_window(coeffs, i, radius))


# --- StreamingCoeffDecoder -------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jm, params, tm = slmft_pair()
    return jm, {"params": params}, tm


@functools.lru_cache(maxsize=None)
def _jax_decode(jm):
    return jax.jit(lambda p, toks, n: jm.apply(p, toks, lengths=n,
                                               method=JS.SLMFT.decode_tokens_to_motion))


def jax_prefix_decode(pair, tokens, n_ctx):
    """JAX's unpadded masked decode of ``tokens[:, :n_ctx]``."""
    jm, params, _ = pair
    toks = np.asarray(tokens[:, :n_ctx], np.int32)
    return np.asarray(_jax_decode(jm)(params, toks,
                                      np.full((tokens.shape[0],), n_ctx, np.int32)))


def test_coeff_decoder_horizons_against_jax(pair):
    tm = pair[2]
    tokens = np.random.default_rng(3).integers(0, 24, size=(2, 12)).astype(np.int32)
    la = 3

    def run(slices, **kw):
        dec = StreamingCoeffDecoder(listener_decode_fn(tm), batch=2, capacity=16, **kw)
        parts = stream(dec, tokens, slices, axis=1)
        return dec, parts, np.concatenate([p for p in parts if p.shape[1]], axis=1)

    _, _, a = run([4, 4, 4], lookahead=la)
    _, _, b = run([1, 6, 2, 3], lookahead=la)
    np.testing.assert_array_equal(a, b)  # push invariance is exact
    assert a.shape == (2, 12, 56)
    for t in (0, 5, 8, 11):  # frame t from codes[:, : min(t + la + 1, T)]
        off = jax_prefix_decode(pair, tokens, min(t + la + 1, 12))
        np.testing.assert_allclose(a[:, t], off[:, t], rtol=2e-4, atol=2e-5, err_msg=f"t={t}")

    # chunk-granular horizons: frame t from codes[:, : round_up(t + la + 1, g)],
    # clamped to T at flush
    g, la_g = 4, 1
    dec, parts, coarse = run([7, 5], lookahead=la_g, granularity=g)
    assert dec.latency_frames == la_g + g - 1
    assert parts[0].shape[1] == 3 and coarse.shape[1] == 12
    for t in (0, 3, 6, 11):
        h = min(g * -(-(t + la_g + 1) // g), 12)
        if t >= 12 - la_g:
            h = 12
        off = jax_prefix_decode(pair, tokens, h)
        np.testing.assert_allclose(coarse[:, t], off[:, t], rtol=2e-4, atol=2e-5,
                                   err_msg=f"g=4 t={t}")

    # lookahead=None: nothing until flush, then the whole offline decode
    dec = StreamingCoeffDecoder(listener_decode_fn(tm), batch=2, capacity=16, lookahead=None,
                                coeff_dim=56)
    assert dec.push(tokens).shape == (2, 0, 56)
    with pytest.raises(ValueError, match="capacity"):
        dec.push(np.zeros((2, 8), np.int32))
    assert dec.frames_available == 12  # the failed push changed nothing
    np.testing.assert_allclose(dec.flush(), jax_prefix_decode(pair, tokens, 12),
                               rtol=2e-4, atol=2e-5)


# --- StreamingRenderer -----------------------------------------------------

@pytest.fixture(scope="module")
def render_pair():
    """(JAX generator, its params, the port's generator loaded from them)."""
    torch.manual_seed(5)
    seed_model = TG.FaceGenerator(**RENDER)
    params = torch_face_generator_to_flax(seed_model.state_dict(), mapping_layers=1)
    port = TG.FaceGenerator(**RENDER)
    port.load_state_dict(jax_face_generator_to_state_dict(params), strict=True)
    jm = JG.FaceGenerator(**RENDER)
    fn = jax.jit(lambda p, img, sems: jm.apply({"params": p}, img, sems)["fake_image"])
    return functools.partial(fn, params), port.eval()


def source(b=1, seed=7):
    return np.random.default_rng(seed).uniform(-1, 1, (b, RES, RES, 3)).astype(np.float32)


def jax_render(render_pair, src, windows):
    """JAX's frames of (T, C, W) windows against one (H, W, 3) source, four
    at a time (one jitted shape)."""
    fn, out = render_pair[0], []
    for i in range(0, len(windows), 4):
        w = windows[i: i + 4]
        pad = np.concatenate([w, np.repeat(w[-1:], 4 - len(w), axis=0)])
        out.append(np.asarray(fn(np.repeat(src[None], 4, axis=0), pad))[: len(w)])
    return np.concatenate(out)


def renderer_stream(r, windows, one_at_a_time=False):
    """Per-push emissions and the flush of a renderer fed ``windows``."""
    if one_at_a_time:
        outs = [r.push([w])["fake_image"] for w in windows]
    else:
        outs = [r.push(windows)["fake_image"]]
    return outs + [r.flush()["fake_image"]]


def test_streaming_renderer_matches_jax_uint8_and_pipelined(render_pair):
    model = render_pair[1]
    src = source()
    rng = np.random.default_rng(11)
    windows = [rng.normal(size=(1, 56, 2 * RADIUS + 1)).astype(np.float32) for _ in range(7)]

    rf = StreamingRenderer(model, src, frames_per_call=2)
    fl = [rf.push(windows), rf.flush()]
    float_frames = np.concatenate([o["fake_image"] for o in fl], axis=1)
    warp = np.concatenate([o["warp_image"] for o in fl], axis=1)
    assert float_frames.shape == warp.shape == (1, 7, RES, RES, 3)
    assert float_frames.dtype == np.float32
    want = jax_render(render_pair, src[0], np.concatenate(windows))
    np.testing.assert_allclose(float_frames[0], want, rtol=1e-4, atol=1e-4)

    ru = StreamingRenderer(model, src, frames_per_call=2, outputs=("fake_image",),
                           as_uint8=True)
    head = ru.push(windows)
    assert set(head) == {"fake_image"} and head["fake_image"].dtype == np.uint8
    u8 = np.concatenate([head["fake_image"], ru.flush()["fake_image"]], axis=1)
    expect = ((np.clip(float_frames, -1, 1) + 1) * 127.5).astype(np.uint8)
    assert u8.shape == expect.shape
    assert np.abs(u8.astype(np.int16) - expect.astype(np.int16)).max() <= 1

    # pipeline_depth=1 lags one call behind; the whole stream is the same
    r0 = StreamingRenderer(model, src, frames_per_call=2, outputs=("fake_image",))
    r1 = StreamingRenderer(model, src, frames_per_call=2, outputs=("fake_image",),
                           pipeline_depth=1)
    outs0 = renderer_stream(r0, windows, one_at_a_time=True)
    outs1 = renderer_stream(r1, windows, one_at_a_time=True)
    assert sum(o.shape[1] for o in outs0[:4]) == 4
    assert sum(o.shape[1] for o in outs1[:4]) == 2
    np.testing.assert_array_equal(np.concatenate(outs0, axis=1), np.concatenate(outs1, axis=1))
    np.testing.assert_array_equal(np.concatenate(outs0, axis=1), float_frames)


# --- StreamingAvatarPipeline -----------------------------------------------

def speaker_clip(b, l, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, 56)).astype(np.float32),
            rng.standard_normal((b, l, 16)).astype(np.float32))


def test_avatar_pipeline_stages_match_jax(pair, render_pair):
    tm, model = pair[2], render_pair[1]
    window, t_total = 4, 12
    src = source()
    vs, va = speaker_clip(1, t_total)
    sess = StreamingListenerSession(tm, batch=1, chunk=4, max_frames=16, max_tokens=16,
                                    greedy=True)
    pipe = StreamingAvatarPipeline(sess, vq_lookahead=None, smooth_window=window,
                                   edge_mode="zero", semantic_radius=RADIUS, renderer=model,
                                   source_images=src, render_frames_per_call=4)
    assert pipe.latency_frames == 0 + (window - window // 2 - 1) + RADIUS
    outs = [pipe.push(vs[:, t: t + 4], va[:, t: t + 4]) for t in range(0, t_total, 4)]
    outs.append(pipe.flush())

    tokens = np.concatenate([o["tokens"] for o in outs], axis=1)
    np.testing.assert_array_equal(tokens, sess.tokens().numpy())
    coeffs = np.concatenate([o["coeffs"] for o in outs], axis=1)
    smoothed = np.concatenate([o["smoothed"] for o in outs if o["smoothed"].shape[-2]],
                              axis=-2)
    windows = sum((o["windows"] for o in outs), [])
    fake = np.concatenate([o["fake_image"] for o in outs], axis=1)
    assert coeffs.shape == smoothed.shape == (1, t_total, 56)
    assert len(windows) == t_total and fake.shape == (1, t_total, RES, RES, 3)

    np.testing.assert_allclose(coeffs, jax_prefix_decode(pair, tokens, t_total),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(smoothed[0], JP.smooth_logits_matrix(coeffs[0], window),
                               rtol=0, atol=1e-12)
    for i, w in enumerate(windows):
        np.testing.assert_allclose(w[0], j_semantic_window(smoothed[0], i, RADIUS),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(fake[0], jax_render(render_pair, src[0], np.concatenate(windows)),
                               rtol=1e-4, atol=1e-4)


def test_avatar_pipeline_bounded_lookahead_counts(pair):
    tm = pair[2]
    vs, va = speaker_clip(2, 12)
    sess = StreamingListenerSession(tm, batch=2, chunk=4, max_frames=16, max_tokens=16,
                                    greedy=True)
    pipe = StreamingAvatarPipeline(sess, vq_lookahead=2, smooth_window=4, semantic_radius=6)
    assert pipe.latency_frames == 2 + 1 + 6
    counts = []
    for t in range(0, 12, 4):
        out = pipe.push(vs[:, t: t + 4], va[:, t: t + 4])
        counts.append((out["coeffs"].shape[1], out["smoothed"].shape[-2], len(out["windows"])))
    # coeffs lag the codes by la, smoothing by one more, windows by the radius
    assert counts[0] == (2, 2, 0)
    fin = pipe.flush()
    assert sum(c[0] for c in counts) + fin["coeffs"].shape[1] == 12
    assert sum(c[1] for c in counts) + fin["smoothed"].shape[-2] == 12
    assert sum(c[2] for c in counts) + len(fin["windows"]) == 12
    with pytest.raises(ValueError, match="one source face per session stream"):
        StreamingAvatarPipeline(
            StreamingListenerSession(tm, batch=2, chunk=4, max_frames=16),
            renderer=object(), source_images=source(1), semantic_radius=6)
