"""The work of ``dsv2_lite``'s cell, a generate call at a time, at the
traffic's shapes: model operations (prefill and decode), the bytes a call
needs, and the shapes K5 and the expert layers' grouped GEMMs run at.

A call prefills B prompts of P tokens in chunks of whole rows of at most
``prefill_tokens`` tokens (MLA in its full form: q and k 192 wide, v 128,
causal; the head at the last position only), then runs ``tokens - 1``
decode steps at positions P..P+tokens-2 (absorbed MLA: K5 over t + 1
latent rows of 576; every layer's weights read; the head on every row) and
samples the last token without a decode. Operations are 2 a multiply-add.
"""

from __future__ import annotations

from . import flops as F


def _sizes(cfg: dict) -> dict:
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    rank, inter, e = cfg["kv_lora_rank"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    n_moe = sum(1 for i in range(cfg["num_hidden_layers"])
                if i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0)
    attn_params = h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + vd) + nh * vd * h
    shared = 3 * h * inter * cfg["n_shared_experts"]
    return dict(h=h, nh=nh, nope=nope, rope=rope, vd=vd, rank=rank, inter=inter, e=e,
                k=cfg["num_experts_per_tok"], layers=cfg["num_hidden_layers"], n_moe=n_moe,
                n_dense=cfg["num_hidden_layers"] - n_moe, attn_params=attn_params,
                dense=3 * h * cfg["intermediate_size"], shared=shared,
                experts=3 * h * inter * e, gate=h * e, vocab=cfg["vocab_size"])


def expert_gemms(s: dict, pairs: int) -> list:
    """(pairs, d_in, d_out, experts) of the two grouped GEMMs of one expert
    layer over ``pairs`` (token, expert) rows."""
    return [(pairs, s["h"], 2 * s["inter"], s["e"]), (pairs, s["inter"], s["h"], s["e"])]


def generate(cfg: dict, tr: dict) -> dict:
    s = _sizes(cfg)
    b, p, n = tr["sequences"], tr["prompt"], tr["tokens"]
    es = 2  # bf16
    steps = n - 1
    # per token, every layer's linear work (the full form's kv_b on every token)
    tok_attn = 2.0 * s["attn_params"]
    tok_ffn = (s["n_dense"] * 2.0 * s["dense"]
               + s["n_moe"] * 2.0 * (s["gate"] + s["k"] * 3 * s["h"] * s["inter"] + s["shared"]))
    pairs_causal = p * (p + 1) / 2.0  # (query, key) pairs of one prompt
    prefill = (b * p * (s["layers"] * tok_attn + tok_ffn)
               + s["layers"] * b * s["nh"] * pairs_causal * 2.0 * (s["nope"] + s["rope"] + s["vd"])
               + F.linear(b, s["h"], s["vocab"]))
    # decode: absorbed MLA (q_proj, kv_a, W_UK and W_UV folded per head, o_proj),
    # K5 over t + 1 latent rows, the feedforwards, the head
    dk = s["rank"] + s["rope"]
    step_attn = 2.0 * (s["h"] * s["nh"] * (s["nope"] + s["rope"]) + s["h"] * dk
                       + s["nh"] * s["nope"] * s["rank"] + s["nh"] * s["rank"] * s["vd"]
                       + s["nh"] * s["vd"] * s["h"])
    keys = sum(p + i + 1 for i in range(steps))  # live keys summed over the steps
    decode = (b * steps * (s["layers"] * step_attn + tok_ffn + 2.0 * s["h"] * s["vocab"])
              + s["layers"] * b * keys * s["nh"] * 2.0 * (dk + s["rank"]))
    # bytes: every weight once a prefill chunk and once a decode step (every
    # expert is touched at B x k pairs), the latent rows each step reads and
    # writes (the prefill writes P a row), one fp32 logits row a token
    rows = max(1, tr["prefill_tokens"] // p)
    chunks = -(-b // rows)
    # the head whole, of the embedding the rows of the batch's tokens
    weights = es * (s["layers"] * s["attn_params"] + s["n_dense"] * s["dense"]
                    + s["n_moe"] * (s["experts"] + s["shared"] + s["gate"])
                    + s["h"] * s["vocab"] + b * s["h"])
    latent = es * dk * s["layers"] * b
    nbytes = (chunks * weights + latent * p
              + steps * (weights + latent) + latent * keys + 4 * b * s["vocab"] * n)
    k5 = [(s["layers"], b, p + i + 1, s["nh"], dk, s["rank"]) for i in range(steps)]
    moe = ([(s["n_moe"] * steps, *g) for g in expert_gemms(s, b * s["k"])]
           + [(s["n_moe"], *g) for r0 in range(0, b, rows)
              for g in expert_gemms(s, min(rows, b - r0) * p * s["k"])])
    return {"dtype": "bfloat16", "flops": prefill + decode, "bytes": nbytes,
            "token_steps": n, "k5": k5, "moe": moe}


def work(cfg: dict, tr: dict) -> dict:
    return generate(cfg, tr)
