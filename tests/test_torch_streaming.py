"""The torch port's streaming sessions against the JAX package's, at the JAX
tests' tiny width (``tests/test_streaming.py:30``: dim 32, audio 16, 2 + 2
encoder and 2 decoder layers, 2 heads, 24 codes): the causal encoder
extension against the offline causal forward (at one start for the batch
and at a start a row), ``StreamingListenerSession`` token-exact against the
JAX session, greedy and sampled at temperature 0.7 / filter 0.2 (the JAX
session's Gumbel noise injected), over several ``generate`` calls, partial
context, a short final chunk and ``round``; the session fed a whole clip
against the offline ``generate_tokens``; the guards; and
``StreamingSpeakerSession`` against the JAX speaker session (greedy, partial
context, ``mesh``). The JAX package's bf16 and ``mesh=`` cases are not
ported: the port has no ``parallel/`` yet, and bf16 runs on the card.
"""

import jax
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu import config as JC
from dyadic_interaction_modeling_tpu.models import slm as JS
from dyadic_interaction_modeling_tpu.serving import (
    StreamingListenerSession as JSession)
from dyadic_interaction_modeling_tpu.serving import (
    StreamingSpeakerSession as JSpeakerSession)
from dyadic_interaction_modeling_tpu.utils.torch_import import torch_slm_to_flax
from dyadic_interaction_modeling_tpu_torch import config as TC
from dyadic_interaction_modeling_tpu_torch.models import slm as TS
from dyadic_interaction_modeling_tpu_torch.models.xtrans import (
    generate_tokens, init_decoder_cache)
from dyadic_interaction_modeling_tpu_torch.serving import (
    StreamingListenerSession, StreamingSpeakerSession)
from dyadic_interaction_modeling_tpu_torch.utils import weights as W

SLM_TINY = dict(dim=32, dim_audio=16, enc_depth=2, enc_heads=2, dec_depth=2, dec_heads=2,
                enc_max_seq_len=64, dec_max_seq_len=64, num_tokens=24)
VQ_TINY = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
               intermediate_size=64, zquant_dim=16, n_embed=24)
B, L, VDIM = 2, 16, 120


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(mod):
    slm_cfg, vq_cfg = mod.slm_defaults(), mod.vq_listener_defaults()
    slm_cfg.update(SLM_TINY)
    vq_cfg.update(VQ_TINY)
    return slm_cfg, vq_cfg


def clip(seed=0, b=B, l=L):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, l, 56), (b, l, 56), (b, l, 16)))


def _port_to_jax(jm, port, variant, args):
    """JAX params from a seeded port model through the JAX package's
    importer, and the port model reloaded from the port's bridge of them."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    with torch.no_grad():  # non-zero patch embeddings, so the tests see them
        for name in ("patch_embed_s", "patch_embed_dec_s", "patch_embed_dec_l"):
            getattr(port, name).normal_()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = torch_slm_to_flax(sd, jm.cfg, jm.vq_cfg, variant=variant,
                               params_template=template)["params"]
    bridge = (W.jax_speaker_slmft_to_state_dict if variant == "speaker_slmft"
              else W.jax_slm_to_state_dict)
    port.load_state_dict(bridge(params, port.cfg, port.vq_cfg), strict=True)
    return jax.tree_util.tree_map(np.asarray, params), port.eval()


def slmft_pair(seed=0):
    """(JAX SLMFT, its params, the port's SLMFT with the same weights)."""
    (jcfg, jvq), (tcfg, tvq) = cfgs(JC), cfgs(TC)
    jm = JS.SLMFT(jcfg, jvq)
    vs, vl, va = clip()
    torch.manual_seed(seed)
    params, tm = _port_to_jax(jm, TS.SLMFT(tcfg, tvq), "slmft",
                              (vs, vl, va, np.ones((B, L), bool), jax.random.PRNGKey(1)))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return slmft_pair()


def jax_noise(key):
    """The JAX sessions' sampling noise as a port ``NoiseFn``: a split of the
    running key each step, its Gumbel draw (``jax.random.categorical``)."""
    state = {"rng": key}

    def draw(shape):
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))

    return draw


def test_extend_matches_offline_causal_forward(pair):
    """Chunks through ``ContinuousTransformerWrapper.extend`` equal the
    causal forward over the whole clip within 1e-5, with one start for the
    batch and with a start a row (the pool's), rows offset by a chunk."""
    tm = pair[2]
    enc = tm.encoder_s
    x = torch.from_numpy(clip(1)[0])
    full = enc(x, attn_mask=torch.ones(L, L, dtype=torch.bool).tril())
    with torch.no_grad():
        cache = init_decoder_cache(B, L, 2, 2)
        out = torch.cat([enc.extend(x[:, t: t + 4], cache, t) for t in range(0, L, 4)], 1)
        np.testing.assert_allclose(out.numpy(), full.detach().numpy(), rtol=1e-5, atol=1e-5)
        # row 1 runs a chunk behind row 0: its chunk i goes in with row 0's i + 1
        cache = init_decoder_cache(B, L + 4, 2, 2)
        rows = []
        for i in range(L // 4 + 1):
            t = torch.tensor([4 * i, 4 * i - 4]).clamp(min=0)
            chunk = torch.stack([x[0, 4 * i: 4 * i + 4] if i < L // 4 else x[0, :4] * 0,
                                 x[1, t[1]: t[1] + 4]])
            if i == 0:  # row 1 idles at the slack positions [L, L + 4)
                t = torch.tensor([0, L])
            rows.append(enc.extend(chunk, cache, t))
    got0 = torch.cat([r[0] for r in rows[:-1]])
    got1 = torch.cat([r[1] for r in rows[1:]])
    np.testing.assert_allclose(got0.numpy(), full[0].detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got1.numpy(), full[1].detach().numpy(), rtol=1e-5, atol=1e-5)


def _drive(sess, vs, va, prompt):
    """One call pattern for both packages: two chunks (partial context),
    start, two generate calls, a short final chunk (n_valid 2, junk tail),
    one more generate, then a round. Returns the tokens and the fed
    context rows."""
    ctx = [np.asarray(sess.feed(vs[:, 0:4], va[:, 0:4])),
           np.asarray(sess.feed(vs[:, 4:8], va[:, 4:8]))]
    sess.start(prompt)
    sess.generate(4)
    sess.generate(4)
    junk_s, junk_a = vs[:, 8:12].copy(), va[:, 8:12].copy()
    junk_s[:, 2:], junk_a[:, 2:] = 13.0, -7.0
    sess.feed(junk_s, junk_a, n_valid=2)
    assert sess.frames_fed == 10
    sess.generate(4)
    sess.round(vs[:, 10:14], va[:, 10:14], n=4)
    return np.asarray(sess.tokens()), ctx


@pytest.mark.parametrize("greedy", [True, False])
def test_session_matches_jax_session(pair, greedy):
    """Token-exact against the JAX session over the same calls; sampled at
    temperature 0.7 and filter_frac 0.2 under the JAX session's noise; the
    fed context rows within 1e-5."""
    jm, params, tm = pair
    vs, _, va = clip(2)
    prompt = np.array([[3], [5]], np.int32)
    kw = dict(batch=B, chunk=4, max_frames=16, max_tokens=20, greedy=greedy,
              temperature=0.7, filter_frac=0.2)
    ref, jctx = _drive(JSession(jm, {"params": params}, rng=7, **kw), vs, va, prompt)
    got, tctx = _drive(StreamingListenerSession(tm, noise=jax_noise(jax.random.PRNGKey(7)),
                                                **kw), vs, va, prompt)
    assert got.shape == (B, 16)
    np.testing.assert_array_equal(got, ref)
    for a, b in zip(tctx, jctx):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("greedy", [True, False])
def test_session_fed_the_clip_matches_offline_generation(pair, greedy):
    """Fed the whole clip, the session gives ``generate_tokens``' tokens
    (greedy, and sampled under the same noise), its context rows those of
    ``decoder_context`` within 1e-5; ``motion`` decodes them."""
    tm = pair[2]
    vs, vl, va = clip(3)
    mask = torch.ones(B, L, dtype=torch.bool)
    with torch.no_grad():
        ctx, prompt = tm.encode_context(*map(torch.from_numpy, (vs, vl, va)), mask)
    noise = torch.from_numpy(np.random.default_rng(4).gumbel(size=(L - 1, B, 24))
                             .astype(np.float32))
    ref = generate_tokens(tm.decoder, prompt, L - 1, ctx, mask, greedy=greedy, gumbel=noise)
    steps = iter(noise)
    sess = StreamingListenerSession(tm, batch=B, chunk=4, max_frames=L, greedy=greedy,
                                    noise=lambda shape: next(steps))
    rows = torch.cat([sess.feed(vs[:, t: t + 4], va[:, t: t + 4]) for t in range(0, L, 4)], 1)
    np.testing.assert_allclose(rows.numpy(), ctx.numpy(), rtol=1e-5, atol=1e-5)
    sess.start(prompt)
    sess.generate(7)
    sess.generate(8)
    np.testing.assert_array_equal(sess.tokens().numpy(), ref.numpy())
    assert sess.tokens_generated == L - 1 and sess.motion().shape == (B, L - 1, 56)


def test_session_guards_and_round(pair):
    """The JAX session's guards, and ``round`` equal to ``feed`` then
    ``generate``."""
    tm = pair[2]
    vs, _, va = clip(5)
    sess = StreamingListenerSession(tm, batch=B, chunk=4, max_frames=8, max_tokens=4,
                                    greedy=True)
    with pytest.raises(ValueError, match="feed at least one"):
        sess.start(np.zeros((B, 1), np.int32))
    with pytest.raises(ValueError, match="before round"):
        sess.round(vs[:, :4], va[:, :4])
    sess.feed(vs[:, :4], va[:, :4])
    with pytest.raises(ValueError, match="chunks of 4"):
        sess.feed(vs[:, :3], va[:, :3])
    with pytest.raises(ValueError, match="before generate"):
        sess.generate(1)
    sess.feed(vs[:, 4:8], va[:, 4:8])
    with pytest.raises(ValueError, match="context capacity"):
        sess.feed(vs[:, :4], va[:, :4])
    sess.start(np.zeros((B, 1), np.int32))
    sess.generate(3)
    with pytest.raises(ValueError, match="token capacity"):
        sess.generate(1)

    def run(fused):
        s = StreamingListenerSession(tm, batch=B, chunk=4, max_frames=16, max_tokens=16,
                                     seed=9)
        s.feed(vs[:, :4], va[:, :4])
        s.start(np.zeros((B, 1), np.int32))
        for t, nv in ((4, 4), (8, 2)):
            if fused:
                s.round(vs[:, t: t + 4], va[:, t: t + 4], n=3, n_valid=nv)
            else:
                s.feed(vs[:, t: t + 4], va[:, t: t + 4], n_valid=nv)
                s.generate(3)
        assert s.frames_fed == 10
        return s.tokens()

    assert torch.equal(run(True), run(False))


# --- the speaker session (BIWI), at the JAX test's width: 12 frames of 120-d
# vertices (tests/test_speaker_streaming.py:28)


@pytest.fixture(scope="module")
def speaker():
    (jcfg, jvq), (tcfg, tvq) = cfgs(JC), cfgs(TC)
    jm = JS.SpeakerSLMFT(jcfg, jvq, vertice_dim=VDIM)
    rng = np.random.default_rng(6)
    verts = rng.standard_normal((B, 12, VDIM)).astype(np.float32)
    emoca = rng.standard_normal((B, 12, 56)).astype(np.float32)
    audio = rng.standard_normal((B, 12, 16)).astype(np.float32)
    template = rng.standard_normal((B, VDIM)).astype(np.float32)
    sids = np.array([3, 7], np.int32)
    batch = (verts, emoca, audio, np.ones((B, 12), bool), template, sids)
    torch.manual_seed(1)
    params, tm = _port_to_jax(jm, TS.SpeakerSLMFT(tcfg, tvq, vertice_dim=VDIM),
                              "speaker_slmft", batch)
    return jm, params, tm, batch


def test_speaker_session_matches_jax_session(speaker):
    """Greedy: the whole clip in three chunks, two generate calls, then a
    session with partial context that keeps feeding: token-exact against the
    JAX speaker session; ``mesh`` and EMOCA within 1e-5 of the JAX one's;
    the guards."""
    jm, params, tm, (verts, emoca, audio, mask, template, sids) = speaker
    with torch.no_grad():
        prompt = tm.encode_context(*map(torch.from_numpy, (verts, emoca, audio, mask,
                                                           template, sids)))[1].numpy()
    kw = dict(batch=B, chunk=4, max_frames=16, max_tokens=16, speaker_ids=sids, greedy=True)
    outs = []
    for sess in (JSpeakerSession(jm, {"params": params}, **kw),
                 StreamingSpeakerSession(tm, **kw)):
        sess.feed(audio[:, 0:4])
        sess.feed(audio[:, 4:8])
        sess.start(prompt)
        partial = np.asarray(sess.generate(4))
        sess.feed(audio[:, 8:12])
        sess.generate(7)
        mesh, emo = sess.mesh(template)
        outs.append((partial, np.asarray(sess.tokens()), np.asarray(mesh), np.asarray(emo)))
    (jp, jt, jmesh, jemo), (tp, tt, tmesh, temo) = outs
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tt, jt)
    assert tmesh.shape == (B, 11, VDIM) and temo.shape == (B, 11, 56)
    np.testing.assert_allclose(tmesh, jmesh, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(temo, jemo, rtol=1e-5, atol=1e-5)

    sess = StreamingSpeakerSession(tm, batch=B, chunk=4, max_frames=8, max_tokens=4,
                                   greedy=True)
    with pytest.raises(ValueError, match="feed at least one audio chunk"):
        sess.start(prompt)
    sess.feed(audio[:, :4])
    with pytest.raises(ValueError, match="chunks of 4"):
        sess.feed(audio[:, :3])
    sess.feed(audio[:, 4:8])
    with pytest.raises(ValueError, match="context capacity"):
        sess.feed(audio[:, :4])
    sess.start(prompt)
    sess.generate(3)
    with pytest.raises(ValueError, match="token capacity"):
        sess.generate(1)
