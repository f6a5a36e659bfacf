"""Multi-head latent attention (MLA) of DeepSeek-V2/V3 and Moonlight, with
a latent cache.  The port's own layer: the JAX package has none.

With h the layer's normed input [B, S, d], H heads, the latent rank r and
the head dims dn (nope), dr (rope) and dv:

* query: q = h . W_q, [B, S, H, dn + dr]; its last dr dims rotated (RoPE);
* latent: [c | k_pe] = h . W_kva, [B, S, r + dr]; c <- RMSNorm(c) with its
  own scale and ``kv_norm_eps``; k_pe rotated, one head that every query
  head shares;
* expansion: [k_nope | v] = c . W_kvb, [B, S, H, dn + dv], and
  k = [k_nope | k_pe], [B, S, H, dn + dr];
* attention: softmax(q . k^T / sqrt(dn + dr), causal) . v, [B, S, H, dv],
  then times W_o.

The cache keeps c (after its norm) and k_pe (after RoPE): r + dr numbers a
token a layer, where attention over the expanded heads would keep
H (dn + dr + dv).  A decode step writes its token's latents and expands
the whole cache by W_kvb again (the form that absorbs W_kvb into the query
and the output is later work).  Prefill attention runs through K3 at its
(dn + dr, dv) head dims (``attn_impl="flash"``), else through the plain
attention of :mod:`.layers`.  No mesh form exists yet, and training
through MLA is not ported.
"""
from __future__ import annotations

import torch

from repro_torch import tracing

from .base import ModelConfig, P
from .layers import _attend, _sdpa, rmsnorm, rope


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    return (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim)


def mla_struct(cfg: ModelConfig):
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = _dims(cfg)
    return {
        "wq": P((d, H, dn + dr), ("embed", "heads", "head_dim")),
        "wkv_a": P((d, r + dr), ("embed", "kv_latent")),
        "kv_norm": {"scale": P((r,), ("kv_latent",), init="ones")},
        "wkv_b": P((r, H, dn + dv), ("kv_latent", "heads", "head_dim")),
        "wo": P((H, dv, d), ("heads", "head_dim", "embed")),
    }


def mla_cache_struct(cfg: ModelConfig, batch: int, max_len: int):
    r, _, dr, _ = _dims(cfg)
    return {
        "c_kv": P((batch, max_len, r), ("batch", "cache_seq", "kv_latent"),
                  init="zeros"),
        "k_pe": P((batch, max_len, dr), ("batch", "cache_seq", "head_dim"),
                  init="zeros"),
    }


def _expand(params, c, k_pe, cfg: ModelConfig):
    """Latents c [B, S, r] and k_pe [B, S, dr] -> k [B, S, H, dn + dr] and
    v [B, S, H, dv] (a view of the expansion)."""
    _, dn, dr, _ = _dims(cfg)
    kv = torch.einsum("bsr,rhk->bshk", c, params.wkv_b.to(c.dtype))
    B, S, H = kv.shape[:3]
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(B, S, H, dr)], -1)
    return k, kv[..., dn:]


def mla(params, x, *, cfg: ModelConfig, positions, cache=None,
        cache_pos: int | None = None, lay=None):
    """Prefill when ``cache`` is None, else one decode step at
    ``cache_pos`` (x [B, 1, d]; ``cache`` {"c_kv", "k_pe"} of
    :func:`mla_cache_struct`, written in place).  Returns (out [B, S, d],
    the cache: this call's latents in prefill, ``cache`` in decode)."""
    if lay is not None:
        raise NotImplementedError(
            "multi-head latent attention has no mesh form: run an MLA "
            "model on one device")
    r, dn, dr, _ = _dims(cfg)
    with tracing.span("mla.q"):
        q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(x.dtype))
        q = torch.cat([q[..., :dn], rope(q[..., dn:], positions,
                                         cfg.rope_theta)], -1)
    with tracing.span("mla.kv"):
        kva = x @ params.wkv_a.to(x.dtype)                  # [B, S, r + dr]
        c = rmsnorm(params.kv_norm, kva[..., :r], cfg.kv_norm_eps)
        k_pe = rope(kva[..., None, r:], positions, cfg.rope_theta)[:, :, 0]
        if cache is None:
            k, v = _expand(params, c, k_pe, cfg)
            new_cache = {"c_kv": c, "k_pe": k_pe}
        else:
            S, Smax = x.shape[1], cache["c_kv"].shape[1]
            cache["c_kv"][:, cache_pos:cache_pos + S] = c
            cache["k_pe"][:, cache_pos:cache_pos + S] = k_pe
            k, v = _expand(params, cache["c_kv"], cache["k_pe"], cfg)
            new_cache = cache
    with tracing.span("mla.attend"):
        if cache is None:
            out = _attend(q, k, v, cfg=cfg, window=0, positions=positions)
        else:
            mask = (torch.arange(Smax, device=x.device)
                    < cache_pos + S)[None, :].expand(S, Smax)
            out = _sdpa(q, k, v, mask, scale=(dn + dr) ** -0.5, cfg=cfg)
    with tracing.span("mla.out"):
        out = torch.einsum("bshk,hkd->bsd", out, params.wo.to(x.dtype))
    return out, new_cache
