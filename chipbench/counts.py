"""The benchmark's own yardstick: the card's published peaks and the
operations and bytes that a prefill's work needs, computed from shapes.

Frozen copies, so that a later change to the program's counters shows as
a difference in ``chipbench/tests/test_chipbench_counts.py`` and never
moves the yardstick:

* ``PEAK_FLOPS``, ``HBM_BW``: NVIDIA's H100 SXM5 data sheet (dense bf16 on
  the tensor cores; HBM3), at the card's full power limit of 700 W;
* :func:`attention_flops`, :func:`attention_bytes`: the flash-attention
  kernel's (K3) live (q, k) pairs and its inputs and output;
* :func:`scan_bytes`, :func:`scan_flops`: the RWKV-6 wkv scan's (K5);
* :func:`model_flops`: the matrix-product FLOPs of the parameters each
  token uses, plus its sequence mixing (the causal attention scores, or the
  wkv recurrence), written here from the configuration.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12     # FLOP/s, bf16 dense, H100 SXM5
HBM_BW = 3.35e12        # B/s, HBM3, H100 SXM5 80 GB


def attention_flops(B: int, Sq: int, Sk: int, H: int, hd: int, *,
                    causal: bool, window: int, q_offset: int = 0) -> int:
    """4 * hd FLOPs per live (q, k) pair (q.k and p.v), over the live pairs
    of the mask (q's rows at global positions q_offset ..)."""
    live = 0
    for i in range(q_offset, q_offset + Sq):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(Sk, i + 1) if causal else Sk
        live += max(0, hi - lo)
    return 4 * hd * B * H * live


def attention_bytes(B: int, Sq: int, Sk: int, H: int, K: int, hd: int,
                    elem: int) -> int:
    """q, k and v read once, o written once, ``elem`` bytes an element."""
    return (2 * B * Sq * H * hd + 2 * B * Sk * K * hd) * elem


def scan_bytes(B: int, S: int, H: int, hd: int) -> int:
    """f32 r, k, v, w read once, u read once, out and the final state
    written once."""
    return 4 * (5 * B * S * H * hd + H * hd + B * H * hd * hd)


def scan_flops(B: int, S: int, H: int, hd: int) -> int:
    """Per token and state element: r.S (2) and diag(w) S + k v^T (3)."""
    return 5 * B * S * H * hd * hd


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the card can take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def rwkv_lora(d: int) -> int:
    """The Finch LoRA width of the port's time mix."""
    return max(32, d // 16)


def product_flops_per_token(m: dict) -> int:
    """2 FLOPs per weight that one token multiplies by: the projections,
    the FFN (a MoE layer's router, its ``experts_per_token`` routed
    experts and its shared experts), and the LM head."""
    d, V = m["d_model"], m["vocab_size"]
    total = 0
    for i, kind in enumerate(_kinds(m)):
        if kind == "rwkv":
            lo, ff = rwkv_lora(d), m["d_ff"]
            total += 5 * d * d + 8 * d * lo   # r k v g o; mu, decay LoRAs
            total += 2 * d * ff + d * d       # channel mix
            continue
        H, K = m["n_heads"], m["n_kv_heads"]
        hd = m.get("head_dim") or d // H
        total += 2 * d * H * hd + 2 * d * K * hd
        if m.get("family") == "moe" and i >= m["first_dense_layers"]:
            E, ff = m["n_experts"], m["moe_d_ff"]
            total += d * E + 3 * d * ff * (m["experts_per_token"]
                                           + m["n_shared_experts"])
        else:
            total += 3 * d * m["d_ff"]
    total += d * V
    return 2 * total


def model_flops(m: dict, B: int, S: int) -> int:
    """One prefill step's model FLOPs over B sequences of S tokens."""
    total = B * S * product_flops_per_token(m)
    for kind in _kinds(m):
        if kind == "rwkv":
            hd = m["rwkv_head_dim"]
            total += scan_flops(B, S, m["d_model"] // hd, hd)
        else:
            H = m["n_heads"]
            hd = m.get("head_dim") or m["d_model"] // H
            window = m.get("window_size", 0) if kind in ("local", "swa") \
                else 0
            total += attention_flops(B, S, S, H, hd, causal=True,
                                     window=window)
    return total


def _kinds(m: dict) -> list[str]:
    out = []
    for pattern, repeat in m["layer_plan"]:
        out.extend(list(pattern) * repeat)
    if len(out) != m["n_layers"]:
        raise ValueError(f"layer_plan covers {len(out)} layers, "
                         f"n_layers is {m['n_layers']}")
    return out
