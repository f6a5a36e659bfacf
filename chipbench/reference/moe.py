"""Plain float32 reference of the DeepSeekMoE decoder as the benchmark's
configuration states it (``configs/deepseek-moe-16b.json``, with its
departures): RMSNorm, multi-head attention with RoPE on the two halves of a
head under a causal mask, a dense first layer, then layers of a softmax
router with top-k gates renormalised to 1, routed experts with a
capacity of slots a sequence (the earliest tokens keep theirs), and shared
experts; a final RMSNorm and the LM head.

Written from the model's published description, independent of the
program: plain PyTorch, f32 with TF32 off, whole sequences at once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import EXACT, at, f32_no_tf32, layers, rmsnorm


def capacity(tokens: int, m: dict) -> int:
    """Slots an expert has in a routing group (a sequence) of ``tokens``."""
    cap = int(tokens * m["experts_per_token"] / m["n_experts"]
              * m["capacity_factor"])
    return max(4, -(-cap // 4) * 4)


def rope(x, theta: float):
    """x [N, S, H, hd]: positions 0 .. S-1, the halves of a head rotated."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, m: dict, cast):
    N, S, d = h.shape
    H, K = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // H
    q = (h @ cast.mat(p["wq"].reshape(d, H * hd))).reshape(N, S, H, hd)
    k = (h @ cast.mat(p["wk"].reshape(d, K * hd))).reshape(N, S, K, hd)
    v = (h @ cast.mat(p["wv"].reshape(d, K * hd))).reshape(N, S, K, hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    kh = k.repeat_interleave(H // K, dim=2)
    vh = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("nqhe,nkhe->nhqk", q, kh) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("nhqk,nkhe->nqhe", torch.softmax(s, dim=-1), vh)
    out = o.reshape(N, S, H * hd) @ cast.mat(p["wo"].reshape(H * hd, d))
    return out, {"k": k, "v": v}


def mlp(p, h, cast):
    return (F.silu(h @ cast.mat(p["w_gate"])) * (h @ cast.mat(p["w_up"]))) \
        @ cast.mat(p["w_down"])


def moe(p, h, m: dict, cast):
    N, S, d = h.shape
    E, k = m["n_experts"], m["experts_per_token"]
    probs = torch.softmax(h @ cast.mat(p["router"]), dim=-1)   # [N, S, E]
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    gates = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, idx, True)
    gate = torch.zeros_like(probs).scatter_(-1, idx, gates)
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
    if "shared" in p:
        out = out + mlp(p["shared"], h, cast)
    return out


def forward(tree, conf: dict, tokens, cast=EXACT):
    """tokens [N, S] -> (logits [N, S, vocab] f32, a cache dict per layer:
    the k and v that attention read, [N, S, K, hd], k after RoPE)."""
    m = conf["model"]
    eps, d = m["norm_eps"], m["d_model"]
    with f32_no_tf32():
        x = cast.rows(tree["embed"]["tok"][tokens.long()]) * math.sqrt(d)
        caches = []
        for lp, r in layers(tree):
            p = at(lp, r)
            a, cache = attention(p["attn"], rmsnorm(x, p["ln1"]["scale"], eps),
                                 m, cast)
            caches.append(cache)
            x = x + a
            h2 = rmsnorm(x, p["ln2"]["scale"], eps)
            x = x + (moe(p["ffn"], h2, m, cast) if "router" in p["ffn"]
                     else mlp(p["ffn"], h2, cast))
        x = rmsnorm(x, tree["final_norm"]["scale"], eps)
        logits = x @ cast.mat(tree["head"]["w"])
    return logits[..., :m["vocab_size"]], caches
