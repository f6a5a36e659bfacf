"""Plain float32 reference of Moonlight-16B-A3B (DeepSeek-V3's block) as
the benchmark's configuration states it (``configs/moonlight-16b-a3b.json``,
with its departures): RMSNorm; multi-head latent attention (the query
projected whole, its last ``qk_rope_head_dim`` dims rotated; a latent of
``kv_lora_rank`` under its own RMSNorm and one shared rotated key head,
expanded to every head's k and v; a causal softmax scaled by the q/k head
dim); a dense first layer; then layers whose router takes sigmoid scores,
chooses the top k of score + ``e_bias`` and weights the chosen experts by
their unbiased scores over their sum (+ 1e-20) times ``routed_scale``, with
routed experts at a capacity of slots a sequence (the earliest tokens keep
theirs) and shared experts; a final RMSNorm and the LM head.

Written from the model's published description (``DeepseekV3Attention``,
``DeepseekV3TopkRouter``), independent of the program: plain PyTorch, f32
with TF32 off, whole sequences at once, attention in blocks of
:data:`QBLOCK` query rows so that the scores of 8,192 positions fit beside
the weights.  Each layer's cache is what the model keeps: the normed
latent ``c_kv`` and the rotated ``k_pe``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import EXACT, at, f32_no_tf32, layers, rmsnorm
from .moe import capacity, mlp, rope

QBLOCK = 1024      # query rows of one block of attention scores


def mla(p, h, m: dict, cast):
    N, S, d = h.shape
    H, r = m["n_heads"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    theta = m["rope_theta"]
    q = (h @ cast.mat(p["wq"].reshape(d, H * (dn + dr)))) \
        .reshape(N, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], theta)], dim=-1)
    kva = h @ cast.mat(p["wkv_a"])                       # [N, S, r + dr]
    c = rmsnorm(kva[..., :r], p["kv_norm"]["scale"], m["kv_norm_eps"])
    k_pe = rope(kva[..., None, r:], theta)[:, :, 0]      # [N, S, dr]
    kv = (c @ cast.mat(p["wkv_b"].reshape(r, H * (dn + dv)))) \
        .reshape(N, S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(N, S, H, dr)],
                  dim=-1)
    v = kv[..., dn:]
    o = torch.empty(N, S, H, dv, device=h.device)
    pos = torch.arange(S, device=h.device)
    for a in range(0, S, QBLOCK):
        b = min(S, a + QBLOCK)
        s = torch.einsum("nqhe,nkhe->nhqk", q[:, a:b], k[:, :b]) \
            / math.sqrt(dn + dr)
        s = s.masked_fill(pos[a:b, None] < pos[None, :b], float("-inf"))
        o[:, a:b] = torch.einsum("nhqk,nkhe->nqhe", torch.softmax(s, -1),
                                 v[:, :b])
    out = o.reshape(N, S, H * dv) @ cast.mat(p["wo"].reshape(H * dv, d))
    return out, {"c_kv": c, "k_pe": k_pe}


def moe(p, h, m: dict, cast):
    N, S, d = h.shape
    E, k = m["n_experts"], m["experts_per_token"]
    scores = torch.sigmoid(h @ cast.mat(p["router"]))       # [N, S, E]
    # the bias chooses (the lower index first among equals) and never
    # weights
    _, idx = torch.sort(scores + p["e_bias"].float(), dim=-1,
                        descending=True, stable=True)
    idx = idx[..., :k]
    top = scores.gather(-1, idx)
    gates = top / (top.sum(-1, keepdim=True) + 1e-20) * m["routed_scale"]
    chosen = torch.zeros_like(scores, dtype=torch.bool) \
        .scatter_(-1, idx, True)
    gate = torch.zeros_like(scores).scatter_(-1, idx, gates)
    # each sequence routes alone: an expert keeps its first C tokens
    kept = chosen & (torch.cumsum(chosen.int(), dim=1) <= capacity(S, m))
    wg, wu, wd = (cast.mat(p[n]) for n in ("w_gate", "w_up", "w_down"))
    out = torch.zeros_like(h)
    for e in range(E):
        n_i, s_i = kept[..., e].nonzero(as_tuple=True)
        if n_i.numel():
            xe = h[n_i, s_i]
            ye = (F.silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e]
            out[n_i, s_i] += ye * gate[n_i, s_i, e][:, None]
    return out + mlp(p["shared"], h, cast)


def forward(tree, conf: dict, tokens, cast=EXACT):
    """tokens [N, S] -> (logits [N, S, vocab] f32, a cache dict per layer:
    the latent ``c_kv`` [N, S, kv_lora_rank] after its norm and ``k_pe``
    [N, S, qk_rope_head_dim] after RoPE)."""
    m = conf["model"]
    # DeepSeek-V3's router first keeps the best ``topk_group`` of
    # ``n_group`` expert groups; at one group (the published 1) that keeps
    # every expert, and neither this reference nor the program has it
    groups = (conf.get("n_group", 1), conf.get("topk_group", 1))
    if groups != (1, 1):
        raise ValueError(f"n_group, topk_group {groups}: only one expert "
                         "group (no group limit) is written")
    eps, d = m["norm_eps"], m["d_model"]
    with f32_no_tf32():
        x = cast.rows(tree["embed"]["tok"][tokens.long()]) * math.sqrt(d)
        caches = []
        for lp, r in layers(tree):
            p = at(lp, r)
            a, cache = mla(p["mla"], rmsnorm(x, p["ln1"]["scale"], eps), m,
                           cast)
            caches.append(cache)
            x = x + a
            h2 = rmsnorm(x, p["ln2"]["scale"], eps)
            x = x + (moe(p["ffn"], h2, m, cast) if "router" in p["ffn"]
                     else mlp(p["ffn"], h2, cast))
        x = rmsnorm(x, tree["final_norm"]["scale"], eps)
        logits = x @ cast.mat(tree["head"]["w"])
    return logits[..., :m["vocab_size"]], caches
