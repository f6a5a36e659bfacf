"""The yardstick of multi-head latent attention (Moonlight-16B-A3B,
DeepSeek-V3's block): the operations and bytes of K3 at q/k and v head
dims that differ, and a prefill step's model FLOPs with MLA counted as it
is, computed from shapes.  Frozen beside :mod:`chipbench.counts`, which
holds the card's peaks and the roofline; ``chipbench/tests/
test_chipbench_counts_mla.py`` holds the numbers at the cell's shape.

* :func:`attention_flops`: 2 (dqk + dv) FLOPs per live causal (q, k) pair
  a head: q.k at dqk, p.v at dv;
* :func:`attention_bytes`: q and k read at dqk, v read and o written at
  dv, once each;
* :func:`model_flops`: 2 FLOPs per weight that one token multiplies by
  (the query, latent, expansion and output projections; the dense FFN or
  the router, the routed experts a token uses and the shared experts; the
  LM head), plus each layer's causal attention.
"""
from __future__ import annotations

def live_pairs(S: int) -> int:
    """The (q, k) pairs of a causal mask over S positions."""
    return S * (S + 1) // 2


def attention_flops(B: int, S: int, H: int, dqk: int, dv: int) -> int:
    return 2 * (dqk + dv) * B * H * live_pairs(S)


def attention_bytes(B: int, S: int, H: int, dqk: int, dv: int,
                    elem: int) -> int:
    return 2 * B * S * H * (dqk + dv) * elem


def mla_product_flops_per_token(m: dict) -> int:
    """One MLA layer's projections, 2 FLOPs a weight: W_q [d, H (dn + dr)],
    W_kva [d, r + dr], W_kvb [r, H (dn + dv)], W_o [H dv, d]."""
    d, H, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    return 2 * (d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv)
                + H * dv * d)


def model_flops(m: dict, B: int, S: int) -> int:
    """One prefill step's model FLOPs over B sequences of S tokens of an
    all-MLA MoE model (``layer_plan`` of "mla" layers)."""
    d, L = m["d_model"], m["n_layers"]
    dense = m["first_dense_layers"]
    ffn = dense * 3 * d * m["d_ff"] + (L - dense) * (
        d * m["n_experts"] + 3 * d * m["moe_d_ff"]
        * (m["experts_per_token"] + m["n_shared_experts"]))
    per_token = L * mla_product_flops_per_token(m) + 2 * ffn \
        + 2 * d * m["vocab_size"]
    core = L * attention_flops(B, S, m["n_heads"],
                               m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
                               m["v_head_dim"])
    return B * S * per_token + core
