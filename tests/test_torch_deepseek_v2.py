"""DeepSeek-V2's decoder (``models/deepseek_v2.py``) against the plain fp32
reference (``tests/plain_deepseek_v2.py``) on seeded weights, at a small
size on one torch thread: 3 layers (1 dense + 2 expert layers), hidden 64,
4 heads, nope 16 / rope 8 / v 16, latent 32, 8 experts top-2 plus 2 shared,
vocab 128, with the published YaRN settings. The full forward, prefill plus
the cached (absorbed) decode at every position, absorbed against full MLA,
the sorted grouped expert layer against its loop, the YaRN tables and scale,
``generate_tokens`` on the context-free decoder under injected Gumbel noise
token for token, K5's plain version against dense attention. Marked
``cuda`` (skipped where no card is present): K5 against its plain version,
K6's expert layer against the sorted path it replaced at the cell's decode
and prefill shapes, the graphed token loop against the eager one, bitwise,
and the ``dsv2_lite`` cell's call at the published widths and depth with
every K5 and K6 launch of an eager call held against its plain version.
On the card, without the repo's conftest (it imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_deepseek_v2.py
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from dyadic_interaction_modeling_tpu_torch.engine.pt_engine import make_lm_generator
from dyadic_interaction_modeling_tpu_torch.kernels import LAUNCHES
from dyadic_interaction_modeling_tpu_torch.kernels.latent_decode import (
    latent_decode, latent_decode_plain)
from dyadic_interaction_modeling_tpu_torch.models import deepseek_v2 as D
from dyadic_interaction_modeling_tpu_torch.models import xtrans as X
from dyadic_interaction_modeling_tpu_torch.utils.profiling import recording

import plain_deepseek_v2 as R  # beside this file, on sys.path as pytest imports tests
from torch_card import card, counted, launches  # noqa: F401  (card: a fixture)

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED_ROPE = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                  "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                  "type": "yarn"}
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8,
             n_shared_experts=2, num_experts_per_tok=2, first_k_dense_replace=1,
             moe_layer_freq=1, kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, rms_norm_eps=1e-6, rope_theta=10000,
             rope_scaling=PUBLISHED_ROPE, norm_topk_prob=False, routed_scaling_factor=1,
             scoring_func="softmax", topk_method="greedy", max_position_embeddings=163840)
B, P, T = 3, 5, 6  # rows, prompt, sampled tokens


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _model(cfg=SMALL, seed=0, dtype=torch.float32, device="cpu"):
    """Seeded weights: N(0, 0.1^2) matrices and tables, norms 1 + N(0, 0.1^2),
    the router N(0, 1 / hidden) (unit-variance logits)."""
    m = D.DeepseekV2Decoder.empty(D.DeepseekV2Config.from_dict(cfg), device, dtype).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("norm.weight"):
                p.normal_(1.0, 0.1, generator=g)
            elif name.endswith("gate.weight"):
                p.normal_(0.0, cfg["hidden_size"] ** -0.5, generator=g)
            else:
                p.normal_(0.0, 0.1, generator=g)
    return m


def _weights(m):
    return {k: v.detach() for k, v in m.state_dict().items()}


def _tokens(b, s, seed=1, vocab=SMALL["vocab_size"], device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g).to(device)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_forward_matches_the_plain_reference():
    m = _model()
    tok = _tokens(B, P + T)
    with torch.no_grad():
        got = m(tok)
    want, margins = R.forward(_weights(m), SMALL, tok)
    assert _rel(got, want) < 1e-5
    assert margins.shape == (2, B, P + T) and bool((margins >= 0).all())


def test_prefill_and_cached_decode_match_the_full_forward_at_every_position():
    m = _model(seed=2)
    tok = _tokens(B, P + T, seed=3)
    want = R.forward(_weights(m), SMALL, tok)[0]
    cache = m.init_cache(B, P + T)
    with torch.no_grad():
        got = [m.prefill(tok[:, :P], cache)]
        for t in range(P, P + T):
            got.append(m.decode_step(tok[:, t: t + 1], cache, t))
    assert _rel(torch.stack(got, 1), want[:, P - 1:]) < 1e-5
    # the prefill in chunks of one row writes the same cache
    m.prefill_tokens = 1
    again = m.init_cache(B, P + T)
    with torch.no_grad():
        first = m.prefill(tok[:, :P], again)
    assert _rel(first, got[0]) < 1e-6
    assert all(_rel(again[k][:, :P], cache[k][:, :P]) < 1e-6 for k in cache)


def test_a_device_position_equals_the_int_position_bitwise():
    m = _model(seed=4)
    tok = _tokens(B, P + 2, seed=5)
    caches = [m.init_cache(B, P + 2) for _ in range(2)]
    with torch.no_grad():
        for c in caches:
            m.prefill(tok[:, :P], c)
        for t in range(P, P + 2):
            a = m.decode_step(tok[:, t: t + 1], caches[0], t)
            b = m.decode_step(tok[:, t: t + 1], caches[1], torch.tensor(t, dtype=torch.int32))
            assert torch.equal(a, b)
    assert all(torch.equal(caches[0][k], caches[1][k]) for k in caches[0])


def test_absorbed_mla_matches_the_full_form():
    m = _model(seed=6)
    attn, cfg = m.layers[1].self_attn, m.cfg
    x = torch.randn(B, P, cfg.hidden_size, generator=torch.Generator().manual_seed(7))
    freqs = m._freqs(torch.arange(P))
    cache = torch.zeros(B, P, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    with torch.no_grad():
        full = attn(x, freqs)
        step_cache = torch.zeros_like(cache)
        steps = [attn.step(x[:, t: t + 1], m._freqs(t), step_cache, t, None) for t in range(P)]
        attn(x, freqs, cache)
    assert _rel(torch.cat(steps, 1), full) < 1e-5
    assert _rel(step_cache, cache) < 1e-6


@pytest.mark.skipif(not hasattr(torch, "_grouped_mm"), reason="torch has no _grouped_mm")
def test_the_sorted_grouped_expert_layer_matches_the_loop():
    """Four experts of eight receive no row; the grouped GEMM (fp32 on the
    CPU) against the per-expert loop, and the layer against the reference."""
    m = _model(seed=8)
    moe = m.layers[1].mlp
    ex = moe.experts
    x = torch.randn(10, SMALL["hidden_size"], generator=torch.Generator().manual_seed(9))
    ids = torch.tensor([0, 3, 3, 5, 0, 5, 3, 0, 5, 3] * 2).sort().values
    ends = torch.searchsorted(ids, torch.arange(ex.n), right=True).to(torch.int32)
    xs = torch.cat([x, x])
    assert (torch.diff(ends, prepend=ends.new_zeros(1)) == 0).sum() == 5
    with torch.no_grad():
        grouped, looped = ex.grouped(xs, ends), ex.looped(xs, ends)
    assert _rel(grouped, looped) < 1e-6
    load = torch.zeros(ex.n, dtype=torch.int64)
    with torch.no_grad():
        y = moe(x[None], load)
    want, _ = R.moe(R.FP32, _weights(m), "layers.1.mlp.", SMALL, x[None])
    assert _rel(y, want) < 1e-5
    assert int(load.sum()) == 10 * SMALL["num_experts_per_tok"]


def test_yarn_tables_and_scale_follow_the_published_formulas():
    cfg = D.DeepseekV2Config.from_dict(dict(SMALL, qk_rope_head_dim=64,
                                            qk_nope_head_dim=128))
    m = 0.1 * 0.707 * math.log(40) + 1
    assert D.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert m * m == pytest.approx(1.5897, abs=1e-4) and D.rope_mscale(cfg) == 1.0
    cos, sin = R.rope_tables(dict(SMALL, qk_rope_head_dim=64), 700, "cpu")
    freqs = torch.arange(700, dtype=torch.float32)[:, None] * D.yarn_inv_freq(cfg)
    torch.testing.assert_close(torch.cat([freqs.cos(), freqs.cos()], -1), cos, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([freqs.sin(), freqs.sin()], -1), sin, rtol=0, atol=0)
    # the ramp: the first dims keep their frequency, the last are divided by 40
    inv = D.yarn_inv_freq(cfg)
    plain = 1.0 / 10000 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    assert torch.equal(inv[:10], plain[:10]) and torch.allclose(inv[-4:], plain[-4:] / 40)


def test_generation_matches_the_reference_step_by_step_under_injected_noise():
    """Greedy and sampled (top-k 4 of 128 under injected Gumbel noise): the
    reference re-runs its full forward at every step and samples as
    ``sample_tokens`` does."""
    m = _model(seed=10)
    prompt = _tokens(B, P, seed=11)
    frac = 4 / SMALL["vocab_size"]
    noise = -torch.log(-torch.log(torch.rand(T, B, SMALL["vocab_size"],
                                             generator=torch.Generator().manual_seed(12))))
    gen = make_lm_generator(m)
    W = _weights(m)
    for greedy in (True, False):
        got = gen(prompt, None, T, greedy=greedy, gumbel=None if greedy else noise,
                  filter_frac=frac)
        seq = prompt
        for i in range(T):
            lg = R.forward(W, SMALL, seq, logits_from=seq.shape[1] - 1)[0][:, 0]
            if greedy:
                tok = lg.argmax(-1)
            else:
                kth = lg.topk(4, dim=-1).values[:, -1:]
                tok = (lg.masked_fill(lg < kth, float("-inf")) + noise[i]).argmax(-1)
            seq = torch.cat([seq, tok[:, None]], 1)
        assert torch.equal(got, seq[:, P:]), greedy


def test_generate_spans_count_the_prefill_and_the_expert_load():
    m = _model(seed=13)
    prompt = _tokens(B, P, seed=14)
    with recording() as spans:
        make_lm_generator(m)(prompt, torch.Generator().manual_seed(1), T)
    names = [s.name for s in spans]
    assert names[0] == "generate" and names.count("token_step") == T
    (pre,) = [s for s in spans if s.name == "prefill"]
    assert pre.counts == {"tokens": B * P}
    # two expert layers: the prefill's forward and T - 1 decode steps each
    assert names.count("moe") == 2 * T
    (loop,) = [s.counts for s in spans if s.name == "token_loop"]
    assert loop["graphed"] == 0
    assert 1000 <= spans[0].counts["expert_load_pm"] <= 1000 * SMALL["n_routed_experts"]


def test_k5_plain_matches_dense_attention():
    g = torch.Generator().manual_seed(15)
    q, cache = torch.randn(2, 16, 576, generator=g), torch.randn(2, 40, 576, generator=g)
    scale = 0.07
    got = latent_decode(q, cache, 30, scale=scale)
    s = (q @ cache[:, :31].transpose(1, 2)) * scale
    want = torch.softmax(s, -1) @ cache[:, :31, :512]
    assert _rel(got, want) < 1e-6
    assert torch.equal(latent_decode(q, cache, torch.tensor(30, dtype=torch.int32),
                                     scale=scale), got)
    # on the CPU any widths run the plain version
    assert torch.equal(latent_decode(q[:, :8, :40], cache[..., :40], 3, scale=scale, dv=24),
                       latent_decode_plain(q[:, :8, :40], cache[..., :40], 3, scale=scale,
                                           dv=24))


def test_init_weights_draws_the_configurations_scales():
    """Matrices and the embedding at ``initializer_range`` (0.006 unless the
    configuration gives one), RMSNorm scales 1, the router at 1 / sqrt(hidden)."""
    assert D.DeepseekV2Config().initializer_range == 0.006
    cfg = dict(SMALL, hidden_size=256, initializer_range=0.02)
    m = D.DeepseekV2Decoder.empty(D.DeepseekV2Config.from_dict(cfg), "cpu")
    m.init_weights(torch.Generator().manual_seed(3))
    for name, p in m.named_parameters():
        if name.endswith("norm.weight"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            std = 256 ** -0.5 if name.endswith("mlp.gate.weight") else 0.02
            assert abs(float(p.detach().std()) / std - 1) < 0.1, name


def test_the_reference_and_the_benchmarks_copy_are_the_same_file():
    ours = (ROOT / "tests" / "plain_deepseek_v2.py").read_bytes()
    assert (ROOT / "portbench" / "reference" / "dsv2_lite.py").read_bytes() == ours
    assert b"dyadic_interaction_modeling_tpu" not in ours and b"jax" not in ours


# --- on the card ---------------------------------------------------------


@pytest.mark.cuda
def test_k5_matches_its_plain_version_on_the_card(card):
    g = torch.Generator(device="cuda").manual_seed(16)
    for rows, length, t in ((512, 768, 640), (4, 300, 299), (3, 200, 0)):
        q = torch.randn(rows, 16, 576, generator=g, device="cuda").bfloat16()
        cache = torch.randn(rows, length, 576, generator=g, device="cuda").bfloat16()
        want = latent_decode_plain(q, cache, t, scale=0.1)
        before = LAUNCHES["latent_decode"]
        for pos in (t, torch.tensor(t, dtype=torch.int32, device="cuda")):
            got = latent_decode(q, cache, pos, scale=0.1)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
        assert LAUNCHES["latent_decode"] == before + 2
    # on the card the kernel's widths alone
    for bad in (dict(q=q[:, :8].contiguous()), dict(dv=256)):
        args = {**dict(q=q, cache=cache, dv=512), **bad}
        with pytest.raises(ValueError, match="latent_decode"):
            latent_decode(args["q"], args["cache"], 3, scale=0.1, dv=args["dv"])


def _sorted_moe(moe, x, load):
    """The expert layer as the port ran it before K6, the plain version of
    the card's path: ``torch.topk`` of the fp32 softmax, the pairs sorted by
    expert (``argsort``, ``searchsorted``), the routed rows gathered, the
    experts' rows scattered back (``index_copy_``), weighted and summed in
    fp32 (N, k, H), cast, and the shared experts added. Returns y, its
    routed part, the experts and weights (sorted by expert) and the ends."""
    k, h = moe.top_k, x.shape[1]
    w, ids = torch.topk(F.linear(x.float(), moe.gate.weight.float()).softmax(dim=-1), k,
                        dim=-1, sorted=False)
    if k > 1 and moe.norm_topk:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    w = w * moe.scaling
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    experts = torch.arange(moe.experts.n, device=x.device)
    ends = torch.searchsorted(flat[order], experts, right=True)
    load.add_(torch.diff(ends, prepend=ends.new_zeros(1)))
    ys = moe.experts(x[order // k], ends.to(torch.int32))
    routed = torch.empty_like(ys).index_copy_(0, order, ys)
    routed = (routed.view(-1, k, h).float() * w[..., None]).sum(dim=1).to(x.dtype)
    ids, perm = ids.sort(dim=-1)
    return (routed + moe.shared_experts(x), routed, ids, w.gather(1, perm),
            ends.to(torch.int32), x[order // k])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 65536])
def test_k6_expert_layer_matches_the_sorted_path_on_the_card(card, n):
    """dsv2_lite's expert layer (hidden 2048, 64 experts top-6, 2 shared) at
    the cell's decode step (512 tokens) and one prefill chunk (65,536): the
    experts, their ends, ``expert_load`` and the routed rows identical to
    the sorted path's, the weights within fp32 rounding, y within bf16
    rounding of it (the fp32 sum's order differs: 1 ulp of the routed part
    and of y), and the same bits on a second run."""
    from dyadic_interaction_modeling_tpu_torch.kernels.moe_route import moe_dispatch

    cfg = D.DeepseekV2Config.from_dict(
        json.loads((ROOT / "portbench" / "configs" / "dsv2_lite.json").read_text()))
    with torch.device("cuda"):
        moe = D.MoE(cfg).to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(n)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            p.normal_(0.0, cfg.hidden_size ** -0.5 if name == "gate.weight" else 0.006,
                      generator=g)
        x = torch.randn(n, cfg.hidden_size, generator=g, device="cuda").bfloat16()
        load, want_load = (torch.full((cfg.n_routed_experts,), 7, dtype=torch.int64,
                                      device="cuda") for _ in range(2))
        want, routed, ids, w, ends, xs = _sorted_moe(moe, x, want_load)
        before = dict(LAUNCHES)
        got = moe(x, load)
        assert LAUNCHES["moe_dispatch"] - before["moe_dispatch"] == 1
        assert LAUNCHES["moe_combine"] - before["moe_combine"] == 1
        assert torch.equal(moe(x), got)
        kw, kids, kends, _, kxs = moe_dispatch(x, moe.gate.weight, moe.top_k, moe.norm_topk,
                                               moe.scaling)
    kids, perm = kids.long().sort(dim=-1)
    assert torch.equal(kids, ids) and torch.equal(kends, ends) and torch.equal(kxs, xs)
    assert torch.equal(load, want_load)
    torch.testing.assert_close(kw.gather(1, perm), w, rtol=1e-6, atol=0)
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2 ** -7 * (routed.float().abs() + want.float().abs())).all())


@pytest.mark.cuda
def test_the_graphed_loop_equals_the_eager_loop_bitwise(card):
    """Published attention widths (16 heads, 512 + 64, K5 on the path) at two
    layers and a small vocabulary, bf16."""
    cfg = dict(SMALL, hidden_size=512, num_attention_heads=16, kv_lora_rank=512,
               qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
               moe_intermediate_size=128, intermediate_size=256, num_hidden_layers=2,
               n_routed_experts=16, num_experts_per_tok=6, vocab_size=256)
    m = _model(cfg, seed=17, dtype=torch.bfloat16, device="cuda")
    prompt = _tokens(8, 12, seed=18, vocab=256, device="cuda")
    for greedy in (False, True):
        for call in range(2):
            ga = torch.Generator(device="cuda").manual_seed(call)
            gb = torch.Generator(device="cuda").manual_seed(call)
            before, moe_before = LAUNCHES["latent_decode"], LAUNCHES["moe_dispatch"]
            with recording() as spans:
                out = X.generate_tokens(m, prompt, 9, None, None, ga, greedy=greedy)
            ref = X._eager_tokens(m, prompt, 9, None, None, gb, greedy, 1, None, 1.0, 0.1)
            assert torch.equal(out, ref), (greedy, call)
            (loop,) = [s.counts for s in spans if s.name == "token_loop"]
            assert loop["graphed"] == (7 if call == 0 else 8)
            assert LAUNCHES["latent_decode"] - before == 2 * 2 * 8
            assert LAUNCHES["moe_dispatch"] - moe_before == 2 * (1 + 8)


K5_TOL = 1e-2  # relative error of a (row, head) output
K6_W_TOL = 1e-6  # relative error of a routing weight
K6_Y_ULPS = 1  # bf16 units in the last place of the combine's output


def _bf16_ulps(a, b):
    """The largest distance between two bf16 tensors in bf16 steps (+0 and
    -0 the same value)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs().max().float()


def _w_rel(got, want):
    """The largest relative error of the routing weights (all positive)."""
    return ((got - want).abs() / want).max()


def _k5_rel(got, want):
    """The largest relative L2 error over the (row, head) outputs."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max()


@pytest.mark.cuda
def test_the_dsv2_lite_call_on_the_card(card, record_property):
    """DeepSeek-V2-Lite at its published widths and depth
    (``portbench/configs/dsv2_lite.json``, bf16, seeded ``init_weights``)
    through ``make_lm_generator`` at the ``dsv2_lite`` cell's call: 512
    prompts of 512 ids prefilled in chunks of 65,536 tokens, 256 tokens
    sampled at top-k 50. A call that captures the graph, then one with its
    launches counted: K5 27 a decode step, K6's halves 26 a decode step and
    a prefill chunk, nothing else, all 255 decode steps replayed. Then the
    same call eagerly with every K5 and K6 launch held against its plain
    version on its own inputs: K5's relative error under ``K5_TOL``, which a
    wrong kernel that reads a tile of keys past t exceeds (one key short and
    the scale without YaRN's mscale^2 are printed beside it), the position
    on the card bitwise the int's; K6's experts, ends, positions, routed rows
    and ``expert_load``'s change exact, the weights within ``K6_W_TOL``
    (under a wrong kernel's that flips ``norm_topk_prob``), y within
    ``K6_Y_ULPS`` bf16 ulp (under a wrong kernel's that drops the last
    slot's weight); the eager tokens bitwise the graphed call's."""
    from unittest import mock

    from dyadic_interaction_modeling_tpu_torch.kernels.moe_route import (
        moe_combine, moe_combine_plain, moe_dispatch, moe_dispatch_plain)

    b, p, n_tok, prefill = 512, 512, 256, 65536
    cfg = D.DeepseekV2Config.from_dict(
        json.loads((ROOT / "portbench" / "configs" / "dsv2_lite.json").read_text()))
    model = D.DeepseekV2Decoder.empty(cfg, "cuda", torch.bfloat16,
                                      prefill_tokens=prefill).eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    model.init_weights(g)
    prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=g, device="cuda")
    gen = make_lm_generator(model)
    steps, layers = n_tok - 1, cfg.num_hidden_layers

    def call(seed):
        rng = torch.Generator(device="cuda").manual_seed(seed)
        return gen(prompt, rng, n_tok, filter_frac=50 / cfg.vocab_size)

    call(1)  # captures the graph
    with counted() as got, recording() as spans:
        graphed = call(2).clone()
    moe_layers = sum(cfg.is_moe(i) for i in range(layers))
    k6 = moe_layers * (steps + -(-b * p // prefill))
    assert got == launches(latent_decode=layers * steps, moe_dispatch=k6, moe_combine=k6)
    record_property("launches", got)
    (loop,) = [s.counts for s in spans if s.name == "token_loop"]
    assert loop["graphed"] == steps and loop["captured"] == 0
    assert bool(((graphed >= 0) & (graphed < cfg.vocab_size)).all())

    rs = cfg.rope_scaling
    mscale2 = D.yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    seen, dispatched, combined = [], [], []

    def k5_checked(q, cache, t, *, scale, dv):
        out = latent_decode(q, cache, t, scale=scale, dv=dv)
        want = latent_decode_plain(q, cache, t, scale=scale, dv=dv)
        faults = (latent_decode_plain(q, cache, t - 1, scale=scale, dv=dv),
                  latent_decode_plain(q, cache, t + 64, scale=scale, dv=dv),  # a tile of K5
                  latent_decode_plain(q, cache, t, scale=scale / mscale2, dv=dv))
        at = torch.tensor(t, dtype=torch.int32, device="cuda")
        same = torch.equal(latent_decode(q, cache, at, scale=scale, dv=dv), out)
        seen.append(torch.stack([_k5_rel(out, want), *(_k5_rel(f, want) for f in faults),
                                 torch.full((), float(same), device="cuda")]))
        return out

    def dispatch_checked(x, gate, k, norm_topk, scaling, load=None):
        want_load = None if load is None else load.clone()
        out = moe_dispatch(x, gate, k, norm_topk, scaling, load)
        want = moe_dispatch_plain(x, gate, k, norm_topk, scaling, want_load)
        other = moe_dispatch_plain(x, gate, k, not norm_topk, scaling)[0]
        same = [torch.equal(a, b) for a, b in zip(out[1:], want[1:])]  # ids, ends, pos, xs
        same.append(load is None or torch.equal(load, want_load))
        dispatched.append(torch.stack([torch.tensor(same, device="cuda").all().float(),
                                       _w_rel(out[0], want[0]), _w_rel(other, want[0])]))
        return out

    def combine_checked(ys, w, pos, shared=None):
        y = moe_combine(ys, w, pos, shared)
        dropped = w.clone()
        dropped[:, -1] = 0
        want = moe_combine_plain(ys, w, pos, shared)
        combined.append(torch.stack([_bf16_ulps(y, want),
                                     _bf16_ulps(moe_combine_plain(ys, dropped, pos, shared),
                                                want)]))
        return y

    X._GRAPHS.clear()  # the graph's cache and buffers make room for the eager call's
    torch.cuda.empty_cache()
    with mock.patch.object(D, "latent_decode", k5_checked), \
            mock.patch.object(D, "moe_dispatch", dispatch_checked), \
            mock.patch.object(D, "moe_combine", combine_checked), \
            mock.patch.object(X, "graph_engages", lambda *a: False):
        eager = call(2)
    assert len(seen) == layers * steps
    errs = torch.stack(seen).cpu()
    k5_err, short, past, unscaled = (float(e) for e in errs[:, :4].max(dim=0).values)
    print(f"K5 {k5_err:.2e}; wrong kernels: a tile past t {past:.2e}, one key short "
          f"{short:.2e}, the scale without YaRN's mscale^2 {unscaled:.2e}")
    assert k5_err < K5_TOL < past
    assert bool(errs[:, 4].all())
    assert len(dispatched) == len(combined) == k6
    d, c = torch.stack(dispatched).cpu(), torch.stack(combined).cpu()
    assert bool(d[:, 0].all())
    assert float(d[:, 1].max()) < K6_W_TOL < float(d[:, 2].min())
    assert float(c[:, 0].max()) <= K6_Y_ULPS < float(c[:, 1].min())
    assert torch.equal(eager, graphed)
