"""Core neural layers (port of ``repro.models.layers``): RMSNorm, RoPE, GQA
attention (full / local / SWA, causal or bidirectional, prefill and decode),
gated MLP, embeddings and the LM head.

Each function takes its parameters as a :class:`~repro_torch.models.base.Params`
module laid out like the JAX package's param dict (``params.wq`` for
``params["wq"]``).  The JAX package's sharding constraints are no-ops on one
device and have no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .base import LOCAL, SWA, ModelConfig, P


def rmsnorm_struct(d: int):
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * params.scale.float()
    return out.to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [S] (shared across batch) or [B, S].
    Rotates the two halves of the head (not interleaved pairs)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq               # [.., S, half]
    if positions.dim() == 1:
        cos = torch.cos(ang)[None, :, None, :]
        sin = torch.sin(ang)[None, :, None, :]
    else:
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_struct(cfg: ModelConfig):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed")),
    }


def attn_mask(q_pos, k_pos, *, causal: bool, window: int):
    """The active-mask grid: [.., Sq, Sk] bool.  window<=0 means unlimited."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        m &= diff >= 0
    if window > 0:
        m &= diff < window
    return m


def _sdpa(q, k, v, mask, *, scale: float, cfg: ModelConfig):
    """Reference attention.  q:[B,Sq,H,hd] k,v:[B,Sk,K,hd] mask:[Sq,Sk].

    GQA repeats the kv heads.  ``attn_dtype`` picks the score dtype; the
    bf16 path keeps the JAX package's max / f32 exp / f32 row-sum /
    reciprocal order."""
    H, K = q.shape[2], k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    acc = torch.float32 if cfg.attn_dtype == "f32" else torch.bfloat16
    logits = torch.einsum("bqhe,bshe->bhqs", q.to(acc), k.to(acc)) \
        * torch.tensor(scale, dtype=acc, device=q.device)
    neg = torch.tensor(-3e38 if acc == torch.float32 else -3e4, dtype=acc,
                       device=q.device)
    logits = torch.where(mask[None, None, :, :], logits, neg)
    if acc == torch.float32:
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqs,bshe->bqhe", probs, v.to(acc))
        return out.to(q.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp((logits - m).float()).to(acc)
    rsum = 1.0 / torch.clamp_min(e.float().sum(dim=-1, keepdim=True), 1e-30)
    probs = e * rsum.to(acc)
    out = torch.einsum("bhqs,bshe->bqhe", probs, v.to(acc))
    return out.to(q.dtype)


def attention(params, x, *, cfg: ModelConfig, kind: str, positions,
              kv_cache=None, cache_pos: int | None = None):
    """Prefill when kv_cache is None; single-step decode otherwise.

    Decode: x is [B, 1, d]; kv_cache = dict(k=[B, Smax, K, hd], v=...) and
    cache_pos the position.  The new k/v are written into kv_cache in place
    (the JAX package returns an updated copy); returns (out, kv_cache).
    """
    S = x.shape[1]
    scale = cfg.hd ** -0.5
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(x.dtype))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    window = cfg.window_size if kind in (LOCAL, SWA) else 0

    if kv_cache is None:
        if cfg.attn_impl == "flash" and cfg.causal:
            out = kops.flash_attention(q, k, v, causal=True, window=window)
        elif cfg.attn_impl in ("reference", "flash"):
            pos1 = positions if positions.dim() == 1 else positions[0]
            mask = attn_mask(pos1, pos1, causal=cfg.causal, window=window)
            out = _sdpa(q, k, v, mask, scale=scale, cfg=cfg)
        else:
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r} is not ported yet "
                "(ROADMAP.md, Open items, item 12)")
        new_cache = {"k": k, "v": v}
    else:
        # Ring buffer: windowed layers size their cache to the window, so
        # the write index wraps; global layers' caches cover every position.
        Smax = kv_cache["k"].shape[1]
        widx = cache_pos % Smax
        kv_cache["k"][:, widx:widx + S] = k
        kv_cache["v"][:, widx:widx + S] = v
        n_valid = min(cache_pos + 1, Smax)
        mask = torch.arange(Smax, device=x.device) < n_valid
        mask = mask[None, :].expand(S, Smax)
        out = _sdpa(q, kv_cache["k"], kv_cache["v"], mask, scale=scale,
                    cfg=cfg)
        new_cache = kv_cache

    out = torch.einsum("bshk,hkd->bsd", out, params.wo.to(x.dtype))
    return out, new_cache


def attention_cache_struct(cfg: ModelConfig, batch: int, max_len: int):
    K, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": P((batch, max_len, K, hd),
               ("batch", "cache_seq", "kv_heads", "head_dim"), init="zeros"),
        "v": P((batch, max_len, K, hd),
               ("batch", "cache_seq", "kv_heads", "head_dim"), init="zeros"),
    }


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------

def mlp_struct(d: int, ff: int):
    return {
        "w_gate": P((d, ff), ("embed", "mlp")),
        "w_up": P((d, ff), ("embed", "mlp")),
        "w_down": P((ff, d), ("mlp", "embed")),
    }


def mlp(params, x):
    h = F.silu(x @ params.w_gate.to(x.dtype)) * (x @ params.w_up.to(x.dtype))
    return h @ params.w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / heads / frontends
# ---------------------------------------------------------------------------

def embed_struct(cfg: ModelConfig):
    s = {"tok": P((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"))}
    if cfg.frontend in ("audio_stub", "vision_stub"):
        s["frontend_proj"] = P((cfg.frontend_dim, cfg.d_model),
                               ("frontend", "embed"))
    return s


def embed(params, tokens, cfg: ModelConfig):
    """Token embedding scaled by sqrt(d_model) in the table's dtype, as the
    JAX package does (standard Llama does not scale)."""
    x = params.tok[tokens.long()]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def head_struct(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"w": P((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))}


def lm_logits(head_params, embed_params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        w = embed_params.tok.to(x.dtype).T
    else:
        w = head_params.w.to(x.dtype)
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


def cross_entropy(logits, labels, mask=None):
    """Mean CE over valid positions; logits [.., V], labels int [..].

    The JAX package contracts the logits with a one-hot of the labels, so
    that tensor-parallel logits need no vocab-axis gather; on one card a
    gather of the gold logit is the same number for finite logits, and at
    full width the one-hot would be another logits-sized f32 tensor."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
