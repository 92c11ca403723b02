"""The torch port's x-transformers stack against the JAX package's: encoder
with attn_mask and key mask, cached decode steps (step_self, step_cross with
groups, kv_heads), greedy and shared-noise sampled generation, and MQA
best-of-N past K1's query rows a cache row at K1's head width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyadic_interaction_modeling_tpu.models import xtrans as J
from dyadic_interaction_modeling_tpu_torch.models import xtrans as T
from dyadic_interaction_modeling_tpu_torch.utils import weights as W

DIM, HEADS, DH, DEPTH, V = 32, 4, 8, 2, 48
B0, N, LC, LT = 3, 2, 10, 9


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _strip(sd, prefix):
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _decoder_pair(kv_heads, pos_emb, dh=DH, b0=B0):
    jd = J.TokenDecoder(num_tokens=V, dim=DIM, max_seq_len=32, depth=DEPTH,
                        heads=HEADS, dim_head=dh, use_abs_pos_emb=pos_emb,
                        kv_heads=kv_heads)
    rng = np.random.default_rng(0)
    ctx = rng.standard_normal((b0, LC, DIM)).astype(np.float32)
    cmask = np.ones((b0, LC), dtype=bool)
    cmask[1, 6:] = False
    toks = rng.integers(0, V, (b0, LT)).astype(np.int32)
    params = jax.jit(lambda k, t, c, m: jd.init(k, t, context=c, context_mask=m))(
        jax.random.PRNGKey(1), jnp.asarray(toks), jnp.asarray(ctx),
        jnp.asarray(cmask))["params"]
    sd = {}
    W._xt_token_decoder(sd, "net", _np_tree(params), DEPTH, DIM)
    td = T.TokenDecoder(V, DIM, 32, DEPTH, HEADS, dh, use_abs_pos_emb=pos_emb,
                        kv_heads=kv_heads)
    td.load_state_dict(W._to_torch(_strip(sd, "net")), strict=True)
    return jd, params, td.eval(), ctx, cmask, toks


@pytest.fixture(scope="module", params=[(None, True), (2, False), (1, False)],
                ids=["mha-pos", "gqa2", "mqa"])
def dec(request):
    return _decoder_pair(*request.param)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_encoder_attn_mask_and_key_mask(kv_heads):
    enc = J.ContinuousTransformerWrapper(dim=DIM, dim_out=DIM, max_seq_len=32,
                                         depth=DEPTH, heads=HEADS, dim_head=DH,
                                         kv_heads=kv_heads)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B0, 12, 20)).astype(np.float32)
    mask = np.arange(12)[None, :] < np.array([12, 8, 3])[:, None]
    tri = np.tril(np.ones((12, 12), dtype=bool))
    params = jax.jit(lambda k, x, m, a: enc.init(k, x, mask=m, attn_mask=a,
                                                 return_embeddings=True))(
        jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(tri))["params"]
    ref = jax.jit(lambda p, x, m, a: enc.apply({"params": p}, x, mask=m, attn_mask=a,
                                               return_embeddings=True))(
        params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(tri))
    sd = {}
    W._xt_continuous(sd, "enc", _np_tree(params), DEPTH, DIM)
    te = T.ContinuousTransformerWrapper(20, DIM, 32, DEPTH, HEADS, DH, kv_heads=kv_heads)
    te.load_state_dict(W._to_torch(_strip(sd, "enc")), strict=True)
    with torch.no_grad():
        out = te(torch.from_numpy(x), mask=torch.from_numpy(mask),
                 attn_mask=torch.from_numpy(tri))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_full_teacher_forced_pass(dec):
    jd, params, td, ctx, cmask, toks = dec
    ref = jax.jit(lambda p, t, c, m: jd.apply({"params": p}, t, context=c,
                                              context_mask=m))(
        params, jnp.asarray(toks), jnp.asarray(ctx), jnp.asarray(cmask))
    with torch.no_grad():
        out = td(torch.from_numpy(toks), context=torch.from_numpy(ctx),
                 context_mask=torch.from_numpy(cmask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _teacher_forced_steps(pair, n):
    """step_self + step_cross(groups=n) through decode_step, teacher-forced,
    against the JAX decode_step (its dense path)."""
    jd, params, td, ctx, cmask, toks = pair
    b0, dh = toks.shape[0], td.dim_head
    seq = np.tile(toks, (n, 1))
    seq[b0:] = (seq[b0:] + 5 * np.repeat(np.arange(1, n), b0)[:, None]) % V  # samples differ
    jkv = jd.apply({"params": params}, jnp.asarray(ctx), method=J.TokenDecoder.cross_kv)
    jcache = J.init_decoder_cache(n * b0, LT, DEPTH, HEADS, dh, kv_heads=jd.kv_heads)
    tkv = td.cross_kv(torch.from_numpy(ctx))
    tcache = T.init_decoder_cache(n * b0, LT, DEPTH, HEADS, dh, kv_heads=td.kv_heads)
    jstep = jax.jit(lambda tok, cache, t: jd.apply(
        {"params": params}, tok, cache, t, jkv, jnp.asarray(cmask), n,
        method=J.TokenDecoder.decode_step))
    for t in range(LT):
        jl, jcache = jstep(jnp.asarray(seq[:, t:t + 1]), jcache, jnp.asarray(t))
        with torch.no_grad():
            tl = td.decode_step(torch.from_numpy(seq[:, t:t + 1]), tcache, t, tkv,
                                torch.from_numpy(cmask), n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tcache["k_1"].numpy(), np.asarray(jcache["k_1"]),
                               atol=1e-4, rtol=1e-4)


def test_cached_steps_with_context_groups(dec):
    _teacher_forced_steps(dec, N)


def _jax_generate(jd, params, prompt, ctx, cmask, key, greedy, n=N):
    return np.asarray(J.generate_tokens(
        jd, {"params": params}, jnp.asarray(prompt), LT - 1, jnp.asarray(ctx),
        jnp.asarray(cmask), key, greedy=greedy, context_groups=n))


def test_greedy_generation_token_exact(dec):
    jd, params, td, ctx, cmask, toks = dec
    prompt = np.tile(toks[:, :1], (N, 1))
    ref = _jax_generate(jd, params, prompt, ctx, cmask, jax.random.PRNGKey(0), True)
    out = T.generate_tokens(td, torch.from_numpy(prompt), LT - 1, torch.from_numpy(ctx),
                            torch.from_numpy(cmask), greedy=True, context_groups=N)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampled_generation_token_exact_under_shared_noise(dec):
    """jax.random.categorical is argmax(logits + gumbel(key)); feeding the
    port the same per-step Gumbel noise (keys from rng, sub = split(rng))
    gives the same sampled stream."""
    jd, params, td, ctx, cmask, toks = dec
    prompt = np.tile(toks[:, :1], (N, 1))
    key = jax.random.PRNGKey(7)
    ref = _jax_generate(jd, params, prompt, ctx, cmask, key, False)
    noise, rng = [], key
    for _ in range(LT - 1):
        rng, sub = jax.random.split(rng)
        noise.append(np.asarray(jax.random.gumbel(sub, (N * B0, V))))
    out = T.generate_tokens(td, torch.from_numpy(prompt), LT - 1, torch.from_numpy(ctx),
                            torch.from_numpy(cmask), context_groups=N,
                            gumbel=torch.from_numpy(np.stack(noise)))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generator_sampling_is_seeded_and_in_top_k():
    jd, params, td, ctx, cmask, toks = _decoder_pair(None, False)
    args = (td, torch.from_numpy(toks[:, :1]), 6, torch.from_numpy(ctx),
            torch.from_numpy(cmask))
    a = T.generate_tokens(*args, generator=torch.Generator().manual_seed(3))
    b = T.generate_tokens(*args, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.shape == (B0, 6)
    assert int(a.min()) >= 0 and int(a.max()) < V


def test_top_k_filter_keeps_ties_like_jax():
    logits = np.array([[3.0, 1.0, 3.0, 2.0, 0.5, 2.0, -1.0, 0.0, 1.0, 2.0,
                        -2.0, 4.0]], dtype=np.float32)
    ref = np.asarray(J.top_k_filter(jnp.asarray(logits), 0.3))
    out = T.top_k_filter(torch.from_numpy(logits), 0.3).numpy()
    np.testing.assert_array_equal(out, ref)


def test_kv_heads_must_divide_heads():
    with pytest.raises(ValueError, match="attn_kv_heads"):
        T.XAttention(DIM, heads=4, dim_head=DH, kv_heads=3)


# MQA best-of-65 at K1's head width: step_cross folds G x N = 4 x 65 = 260
# query rows a context, past K1's MAX_NQ, so K1 takes them in two slices
WIDE_DH, WIDE_N = 64, 65


@pytest.fixture(scope="module")
def wide_mqa():
    return _decoder_pair(1, False, dh=WIDE_DH, b0=2)


@pytest.fixture
def one_thread():
    """One intra-op thread: the model is small, and the test run's workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mqa_steps_past_k1_query_rows_take_the_dense_step(wide_mqa, monkeypatch, one_thread):
    """At K1's head width, step_self (G = 4 rows) reaches K1's wrapper whole
    and step_cross at G N = 260 > MAX_NQ in two slices of 130 rows, on every
    device as here (none is left to the dense step), and both equal the JAX
    package's decode step."""
    assert HEADS * WIDE_N > T.MAX_NQ >= HEADS and WIDE_DH in T.DECODE_D
    rows_seen = []
    k1 = T.decode_attention

    def counting(q, *args, **kwargs):
        rows_seen.append(q.shape[1])
        return k1(q, *args, **kwargs)

    monkeypatch.setattr(T, "decode_attention", counting)
    _teacher_forced_steps(wide_mqa, WIDE_N)
    assert rows_seen == [HEADS, 130, 130] * (LT * DEPTH)


def test_mqa_greedy_best_of_65_token_exact(wide_mqa, one_thread):
    jd, params, td, ctx, cmask, toks = wide_mqa
    prompt = np.tile(toks[:, :1], (WIDE_N, 1))
    ref = _jax_generate(jd, params, prompt, ctx, cmask, jax.random.PRNGKey(0), True, WIDE_N)
    out = T.generate_tokens(td, torch.from_numpy(prompt), LT - 1, torch.from_numpy(ctx),
                            torch.from_numpy(cmask), greedy=True, context_groups=WIDE_N)
    np.testing.assert_array_equal(out.numpy(), ref)
