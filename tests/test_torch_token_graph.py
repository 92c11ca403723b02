"""The decode step at a position on the card, and ``generate_tokens``' token
loop replayed from CUDA graphs (``models/xtrans.py``).

On the CPU: ``decode_step`` at a 0-d int32 position equals the int path
bitwise (logits and cache); a (1,) position keeps its per-row meaning; the
rule that engages the graph and the key it is captured for. Marked ``cuda``
(skipped where no card is present): the graphed ``generate_tokens`` against
the eager loop, ``_eager_tokens``. On the card, without the repo's conftest
(it imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_token_graph.py
"""

from __future__ import annotations

import copy

import pytest
import torch

from dyadic_interaction_modeling_tpu_torch.kernels import LAUNCHES
from dyadic_interaction_modeling_tpu_torch.models import xtrans as X
from dyadic_interaction_modeling_tpu_torch.utils.profiling import recording
from torch_card import card  # noqa: F401  (a fixture)

# the gen cell's layout at a small width: 12 heads of 64, best-of-N rows
# sharing a context, a context mask
DIM, DEPTH, HEADS, DH, V, MAXLEN = 96, 2, 12, 64, 40, 64
B0, N, LC, STEPS = 3, 4, 7, 9


def _decoder(dtype=torch.float32, device="cpu", kv_heads=None, dim=DIM, depth=DEPTH,
             vocab=V, max_len=MAXLEN) -> X.TokenDecoder:
    torch.manual_seed(0)
    dec = X.TokenDecoder(vocab, dim, max_len, depth, HEADS, DH, kv_heads=kv_heads)
    return dec.to(device, dtype).eval()


def _inputs(b0=B0, n=N, lc=LC, dim=DIM, steps=STEPS, vocab=V, device="cpu", seed=1):
    """Context (b0, lc, dim), its mask (b0, lc) and (n * b0, steps) tokens."""
    g = torch.Generator().manual_seed(seed)
    ctx = torch.randn(b0, lc, dim, generator=g)
    mask = torch.arange(lc)[None] < torch.randint(2, lc + 1, (b0,), generator=g)[:, None]
    seq = torch.randint(0, vocab, (n * b0, steps), generator=g, dtype=torch.int32)
    return ctx.to(device), mask.to(device), seq.to(device)


@pytest.mark.parametrize("dtype,kv_heads", [(torch.float32, None), (torch.bfloat16, None),
                                            (torch.float32, 4)])
def test_decode_step_at_a_device_position_equals_the_int_path_bitwise(dtype, kv_heads):
    dec = _decoder(dtype, kv_heads=kv_heads)
    ctx, mask, seq = _inputs()
    cross = dec.cross_kv(ctx.to(dtype))
    caches = [X.init_decoder_cache(N * B0, STEPS, DEPTH, HEADS, DH, dtype, kv_heads)
              for _ in range(2)]
    with torch.no_grad():
        for t in range(STEPS):
            tok = seq[:, t: t + 1]
            a = dec.decode_step(tok, caches[0], t, cross, mask, N)
            b = dec.decode_step(tok, caches[1], torch.tensor(t, dtype=torch.int32), cross,
                                mask, N)
            assert torch.equal(a, b), t
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name]), name


def test_a_one_row_position_keeps_its_per_row_meaning(monkeypatch):
    """A pool of one session passes a (1,) position: K1 then takes the
    bound as a key mask, as for any pool; a 0-d position gives K1 the
    tensor itself. Both give the int path's logits."""
    one, zero_d = torch.tensor([3]), torch.tensor(3, dtype=torch.int32)
    assert X.per_row(one) and not X.device_step(one)
    assert X.device_step(zero_d) and not X.per_row(zero_d)
    lmax = STEPS + 2  # the self steps' key length, apart from the context's LC
    seen = []
    real = X.decode_rows

    def spy(q, k, v, t=None, key_mask=None, *, scale):
        if k.shape[1] == lmax:
            seen.append((t, key_mask))
        return real(q, k, v, t, key_mask, scale=scale)

    monkeypatch.setattr(X, "decode_rows", spy)
    dec = _decoder()
    ctx, mask, seq = _inputs(b0=1, n=1)
    cross = dec.cross_kv(ctx)
    caches = [X.init_decoder_cache(1, lmax, DEPTH, HEADS, DH) for _ in range(3)]
    with torch.no_grad():
        for t in range(4):
            tok = seq[:, t: t + 1]
            want = dec.decode_step(tok, caches[0], t, cross, mask)
            seen.clear()
            got = dec.decode_step(tok, caches[1], torch.tensor([t]), cross, mask)
            assert torch.equal(got, want)
            assert all(tt is None and km is not None and km.shape == (1, lmax)
                       for tt, km in seen) and len(seen) == DEPTH
            seen.clear()
            got = dec.decode_step(tok, caches[2], torch.tensor(t, dtype=torch.int32), cross, mask)
            assert torch.equal(got, want)
            assert all(isinstance(tt, torch.Tensor) and tt.dim() == 0 and km is None
                       for tt, km in seen) and len(seen) == DEPTH


def test_the_graph_engages_on_the_card_from_an_int_start_without_injected_noise():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert X.graph_engages(cuda, 1, None)
    assert not X.graph_engages(cpu, 1, None)
    assert not X.graph_engages(cuda, 1, torch.zeros(STEPS, N * B0, V))  # injected gumbel
    assert not X.graph_engages(cuda, torch.tensor([1, 1, 1]), None)    # per-row start
    assert not X.graph_engages(cuda, torch.tensor(1, dtype=torch.int32), None)


def test_the_graph_key_follows_shapes_dtypes_weights_and_sampling_settings():
    dec = _decoder()
    ctx, mask, seq = _inputs()
    base = dict(decoder=dec, prompt=seq[:, :1], seq_len=STEPS, context=ctx, context_mask=mask,
                context_groups=N, temperature=1.0, filter_frac=0.1)

    def key(**change):
        return X.token_graph_key(**{**base, **change})

    assert key() == key(context=ctx.clone(), context_mask=mask.clone(), prompt=seq[:, 1:2])
    changes = dict(
        prompt=[seq[: (N - 1) * B0, :1], seq[:, :2], seq[:, :1].long()],
        seq_len=[STEPS + 1],
        context=[ctx[:, :-1], ctx[:2]],
        context_mask=[None, mask[:, :-1]],
        context_groups=[N - 1],
        temperature=[0.7],
        filter_frac=[0.2],
        decoder=[copy.deepcopy(dec), _decoder(torch.bfloat16)],  # other weights, dtype
    )
    keys = {key()}
    for name, values in changes.items():
        for value in values:
            k = key(**{name: value})
            assert k != key(), (name, value)
            keys.add(k)
    assert len(keys) == 1 + sum(len(v) for v in changes.values())


def test_the_cpu_loop_runs_eagerly_and_counts_no_graphed_step():
    dec = _decoder()
    ctx, mask, seq = _inputs()
    for greedy in (True, False):
        args = (dec, seq[:, :1], STEPS, ctx, mask)
        with recording() as spans:
            out = X.generate_tokens(*args, torch.Generator().manual_seed(2), greedy=greedy,
                                    context_groups=N)
        ref = X._eager_tokens(*args, torch.Generator().manual_seed(2), greedy, N, None, 1.0, 0.1)
        assert torch.equal(out, ref) and out.shape == (N * B0, STEPS)
        assert [s.counts for s in spans if s.name == "token_loop"] == [
            {"graphed": 0, "captured": 0}]
        assert not any(s.name == "capture" for s in spans)


# --- on the card ---------------------------------------------------------


def _loop_counts(spans):
    (loop,) = [s.counts for s in spans if s.name == "token_loop"]
    return loop["graphed"], loop["captured"]


def _against_eager(dec, prompt, steps, ctx, mask, n, greedy, seed, twin=None):
    """The graphed call and the eager loop from identically seeded
    generators (or ``twin``, a pair carried over from an earlier call):
    (graphed tokens, eager tokens, (graphed, captured), launches of each)."""
    ga, gb = twin or (torch.Generator(device="cuda").manual_seed(seed),
                      torch.Generator(device="cuda").manual_seed(seed))
    before = dict(LAUNCHES)
    with recording() as spans:
        out = X.generate_tokens(dec, prompt, steps, ctx, mask, ga, greedy=greedy,
                                context_groups=n)
    mid = dict(LAUNCHES)
    ref = X._eager_tokens(dec, prompt, steps, ctx, mask, gb, greedy, n, None, 1.0, 0.1)
    torch.cuda.synchronize()
    launches = ({k: mid[k] - before[k] for k in before},
                {k: LAUNCHES[k] - mid[k] for k in before})
    assert torch.equal(ga.get_state(), gb.get_state())  # the same draws were made
    return out, ref, _loop_counts(spans), launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graphed_generation_equals_the_eager_loop(card, dtype):
    """4 clips x best-of-3 rows of 12 heads: 144 cache rows, so K1's plan is
    one key split with the int and the device position alike. The first
    call of each kind captures after one eager step; the next replays every
    step but the last; a new generator reuses the graph and follows its own
    stream."""
    b0, n = 4, 3
    dec = _decoder(dtype, "cuda")
    ctx, mask, seq = _inputs(b0=b0, n=n, device="cuda")
    prompt = seq[:, :1]
    for greedy in (False, True):
        twin = (torch.Generator(device="cuda").manual_seed(11),
                torch.Generator(device="cuda").manual_seed(11))
        for call, want in enumerate([(STEPS - 2, 1), (STEPS - 1, 0), (STEPS - 1, 0)]):
            out, ref, counts, (lg, le) = _against_eager(
                dec, prompt, STEPS, ctx, mask, n, greedy, 12 + call,
                twin if call < 2 else None)
            assert torch.equal(out, ref), (greedy, call)
            assert counts == want, (greedy, call)
            assert lg == le and lg["decode_attention"] == 2 * DEPTH * STEPS
    # injected noise runs the eager loop on the card too
    noise = torch.randn(STEPS, n * b0, V, device="cuda")
    with recording() as spans:
        out = X.generate_tokens(dec, prompt, STEPS, ctx, mask, gumbel=noise, context_groups=n)
    assert _loop_counts(spans) == (0, 0)
    assert torch.equal(out, X._eager_tokens(dec, prompt, STEPS, ctx, mask, None, False, n,
                                            noise, 1.0, 0.1))


@pytest.mark.cuda
def test_a_new_shape_recaptures_and_the_first_shape_again_matches(card):
    dec = _decoder(torch.bfloat16, "cuda")
    shapes = [(4, 3, STEPS), (6, 2, STEPS + 4), (4, 3, STEPS)]
    for i, (b0, n, steps) in enumerate(shapes):
        ctx, mask, seq = _inputs(b0=b0, n=n, steps=steps, device="cuda", seed=i)
        out, ref, counts, _ = _against_eager(dec, seq[:, :1], steps, ctx, mask, n, False, i)
        assert torch.equal(out, ref), i
        assert counts == (steps - 2, 1), i  # only the latest key's graphs are kept
        out, ref, counts, _ = _against_eager(dec, seq[:, :1], steps, ctx, mask, n, False, 9 + i)
        assert torch.equal(out, ref) and counts == (steps - 1, 0), i
    (key, graph), = [v for k, v in X._GRAPHS.items() if k is dec]
    assert key[0] == (4 * 3, 1)


@pytest.mark.cuda
def test_a_speaker_shaped_fp32_call_equals_the_eager_loop(card):
    """SpeakerSLMFT's best-of-50 of one clip (``make_speaker_generator``):
    decoder width 384 + 768, 4 layers, 12 heads of 64, 512 codes, absolute
    positions, L = 120, fp32."""
    dim, vocab, n, length = 1152, 512, 50, 120
    dec = _decoder(torch.float32, "cuda", dim=dim, depth=4, vocab=vocab, max_len=256)
    ctx, mask, seq = _inputs(b0=1, n=n, lc=length, dim=dim, steps=length, vocab=vocab,
                             device="cuda")
    mask[:] = True
    for greedy in (False, True):
        out, ref, counts, _ = _against_eager(dec, seq[:, :1], length - 1, ctx, mask, n,
                                             greedy, 5)
        assert torch.equal(out, ref) and counts == (length - 3, 1), greedy
