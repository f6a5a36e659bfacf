"""Core neural layers (port of ``repro.models.layers``): RMSNorm, RoPE, GQA
attention (full / local / SWA, causal or bidirectional, prefill and decode),
gated MLP, embeddings and the LM head.

Each function takes its parameters as a :class:`~repro_torch.models.base.Params`
module laid out like the JAX package's param dict (``params.wq`` for
``params["wq"]``).  On a mesh the blocks take a
:class:`~repro_torch.sharding.layout.Layout` (``lay``) and compute on
this rank's shards with explicit collectives at the places of the JAX
package's sharding constraints (``shard_act``, the prefill kv pins;
``_attention_tp`` says why ``_score_constraint`` needs none); without one
(one device) those places are no-ops, as the constraints are in the JAX
package when ``cfg.batch_axes`` is empty.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.sharding import comm
from repro_torch.sharding.layout import (fetch, seq_combine, seq_gather,
                                         seq_rows, tp_sharded)

from .base import LOCAL, SWA, ModelConfig, P


def _w(params, name: str, lay, **kw):
    """Parameter ``name`` as this rank computes with it (see
    :func:`~repro_torch.sharding.layout.fetch`); itself off the mesh."""
    p = getattr(params, name)
    return p if lay is None else fetch(p, lay, **kw)


def rmsnorm_struct(d: int):
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float, lay=None):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * _w(params, "scale", lay).float()
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


def shard_act(x, lay=None):
    """Pin a sublayer's output to the residual stream's layout.  In the JAX
    package a constraint on the TP partial sum, so that GSPMD lowers the
    combine as a reduce-scatter (``act_shard="seq"``: the sequence split
    over 'model') rather than an all-reduce and a slice.  Here the
    combine itself: the partial sum [B/data, S, d] is reduce-scattered on
    the sequence, or all-reduced when the stream is not split.  No-op
    off the mesh."""
    if lay is None:
        return x
    return seq_combine(x, lay)


def _sdpa(q, k, v, mask, *, scale: float, cfg: ModelConfig, hd_group=None,
          seq_group=None):
    """Reference attention.  q:[B,Sq,H,hd] k,v:[B,Sk,K,hd] mask:[Sq,Sk].

    GQA repeats the kv heads.  ``attn_dtype`` picks the score dtype; the
    bf16 path keeps the JAX package's max / f32 exp / f32 row-sum /
    reciprocal order.

    Decode on a mesh splits the cache: ``hd_group`` — q, k and v are this
    rank's head_dim slices and the scores partial sums over that group;
    ``seq_group`` — k and v are this rank's cache positions (``mask`` its
    columns), so the softmax's max and row sum and the weighted sum are
    combined over that group."""
    H, K = q.shape[2], k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    acc = torch.float32 if cfg.attn_dtype == "f32" else torch.bfloat16
    logits = torch.einsum("bqhe,bshe->bhqs", q.to(acc), k.to(acc))
    if hd_group is not None:
        logits = comm.all_reduce(logits, hd_group)
    logits = logits * torch.tensor(scale, dtype=acc, device=q.device)
    neg = torch.tensor(-3e38 if acc == torch.float32 else -3e4, dtype=acc,
                       device=q.device)
    logits = torch.where(mask[None, None, :, :], logits, neg)
    if acc == torch.float32 and seq_group is None:
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqs,bshe->bqhe", probs, v.to(acc)).to(q.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    if seq_group is not None:
        m = comm.all_reduce(m, seq_group, op=dist.ReduceOp.MAX)
    if acc == torch.float32:
        e = torch.exp(logits - m)
        probs = e / comm.all_reduce(e.sum(dim=-1, keepdim=True), seq_group)
    else:
        e = torch.exp((logits - m).float()).to(acc)
        rsum = e.float().sum(dim=-1, keepdim=True)
        if seq_group is not None:
            rsum = comm.all_reduce(rsum, seq_group)
        probs = e * (1.0 / torch.clamp_min(rsum, 1e-30)).to(acc)
    out = torch.einsum("bhqs,bshe->bqhe", probs, v.to(acc))
    if seq_group is not None:
        out = comm.all_reduce(out, seq_group)
    return out.to(q.dtype)


def _chunked_sdpa(q, k, v, *, cfg: ModelConfig, window: int, causal: bool,
                  chunk: int = 512):
    """Divergence-aware chunked attention in plain PyTorch (the kernel's
    schedule): q is processed in chunks; for windowed layers each chunk
    attends only to its [start-window+1, start+chunk) KV band, so EMPTY
    tiles are never computed, and no O(S^2) tensor is materialized.  Under
    grad each chunk is checkpointed: the backward pass recomputes its
    scores instead of keeping them.  On a mesh it runs on the rank's own
    heads (the JAX package's one-per-layer heads-TP pin of q/k/v)."""
    import torch.utils.checkpoint as ckpt

    B, S, H, hd = q.shape
    K = k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # fallback: single chunk
    nq = S // chunk
    acc = torch.float32 if cfg.attn_dtype == "f32" else torch.bfloat16
    scale = torch.tensor(hd ** -0.5, dtype=acc, device=q.device)
    neg = torch.tensor(-3e38 if acc == torch.float32 else -3e4, dtype=acc,
                       device=q.device)
    band = None
    if window > 0:
        band = min(S, -(-(window + chunk - 1) // chunk) * chunk)

    def one(i: int):
        qs = i * chunk
        qc = q[:, qs:qs + chunk].to(acc)
        if band is not None:
            ks0 = min(max(qs + chunk - band, 0), S - band)
            kc = k[:, ks0:ks0 + band].to(acc)
            vc = v[:, ks0:ks0 + band].to(acc)
            kpos = ks0 + torch.arange(band, device=q.device)
        else:
            kc, vc = k.to(acc), v.to(acc)
            kpos = torch.arange(S, device=q.device)
        qpos = qs + torch.arange(chunk, device=q.device)
        diff = qpos[:, None] - kpos[None, :]
        live = torch.ones(diff.shape, dtype=torch.bool, device=q.device)
        if causal:
            live &= diff >= 0
        if window > 0:
            live &= diff < window
        s = torch.einsum("bqhe,bshe->bhqs", qc, kc) * scale
        s = torch.where(live[None, None], s, neg)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp((s - m).float()).to(acc)
        rs = 1.0 / torch.clamp_min(e.float().sum(-1, keepdim=True), 1e-30)
        p = e * rs.to(acc)
        return torch.einsum("bhqs,bshe->bqhe", p, vc).to(q.dtype)

    if torch.is_grad_enabled():
        outs = [ckpt.checkpoint(one, i, use_reentrant=False)
                for i in range(nq)]
    else:
        outs = [one(i) for i in range(nq)]
    return torch.cat(outs, dim=1)


def _attend(q, k, v, *, cfg: ModelConfig, window: int, positions,
            q_positions=None, chunked_ok: bool = True):
    """Prefill attention of q [B, Sq, H, hd] over k [B, S, K, hd] and v
    [B, S, K, hdv] (hdv is hd but in latent attention), scaled by
    hd ** -0.5: K3 (``attn_impl="flash"``, causal), the chunked schedule
    (``"chunked"``, when ``chunked_ok``) or the dense reference.
    ``q_positions`` (a rank's own query rows, contiguous) defaults to
    ``positions``; K3 takes their first position as its query-row offset."""
    whole = q_positions is None
    if cfg.attn_impl == "flash" and cfg.causal:
        offset = 0
        if not whole:
            offset = int(q_positions[0])
            n = q_positions.shape[0]
            assert torch.equal(q_positions, offset + torch.arange(
                n, dtype=q_positions.dtype, device=q_positions.device)), \
                "K3 takes a contiguous block of query rows"
        return kops.flash_attention(q, k, v, causal=True, window=window,
                                    q_offset=offset)
    if cfg.attn_impl == "chunked" and chunked_ok and whole:
        return _chunked_sdpa(q, k, v, cfg=cfg, window=window,
                             causal=cfg.causal)
    if cfg.attn_impl not in ("reference", "flash", "chunked"):
        raise ValueError(f"attn_impl={cfg.attn_impl!r}")
    pos1 = positions if positions.dim() == 1 else positions[0]
    qpos = pos1 if whole else q_positions
    mask = attn_mask(qpos, pos1, causal=cfg.causal, window=window)
    return _sdpa(q, k, v, mask, scale=q.shape[-1] ** -0.5, cfg=cfg)


def _gqa_block(H: int, K: int, tp: int, r: int) -> tuple[int, int]:
    """The kv heads [lo, hi) that q heads [r*H/tp, (r+1)*H/tp) read.
    Contiguous head blocks keep GQA local: rank r holds q heads
    r*H/tp ... and, when K divides by tp, kv heads r*K/tp ... ."""
    hl, g = H // tp, H // K
    assert H % tp == 0 and (hl % g == 0 or g % hl == 0), (H, K, tp)
    lo, hi = (r * hl) // g, ((r + 1) * hl - 1) // g + 1
    if K % tp == 0:
        assert (lo, hi) == (r * K // tp, (r + 1) * K // tp), (H, K, tp)
    return lo, hi


def _attention_tp(params, x, *, cfg: ModelConfig, kind: str, positions,
                  lay):
    """Prefill / training attention on a mesh.  x: this rank's residual
    rows.  Returns (out in the residual layout, this rank's cache shard).

    heads mode (q heads split over 'model', the rules' choice when they
    divide, and ``cfg.score_shard`` not "qseq"): the sequence is
    gathered, each rank projects its own q heads and the k/v that
    :func:`_kv_heads` says, attends (K3, chunked or dense) and multiplies
    by its rows of wo; the partial sums meet in ``shard_act``.  qseq mode
    (heads do not divide; the weights are split on head_dim or not at
    all): each rank gathers the whole attention weights, projects q, k
    and v of its own rows only, all-gathers k and v over 'model', and
    attends densely with its rows' queries (the chunked schedule falls
    back to dense here, as in the JAX package; K3 runs on the rank's
    rows at their offset); its output rows need no combine.

    The JAX package's ``_score_constraint`` (the O(S^2) scores pinned to
    the head axis, or to the query rows for qseq) has no counterpart:
    a rank computes only its own heads' or its own rows' scores, which is
    the layout the pin asks for, and no collective touches them."""
    window = cfg.window_size if kind in (LOCAL, SWA) else 0
    if tp_sharded(params.wq, 1) and cfg.score_shard != "qseq":
        h = seq_gather(x, lay)
        q = torch.einsum("bsd,dhk->bshk", h,
                         _w(params, "wq", lay).to(h.dtype))
        q = rope(q, positions, cfg.rope_theta)
        k, v, cache = _kv_heads(params, h, cfg, lay, positions)
        out = _attend(q, k, v, cfg=cfg, window=window, positions=positions)
        out = torch.einsum("bshk,hkd->bsd", out,
                           _w(params, "wo", lay).to(h.dtype))
        return shard_act(out, lay), cache
    wq, wk, wv, wo = (_w(params, n, lay, model=True)
                      for n in ("wq", "wk", "wv", "wo"))
    pos1 = positions if positions.dim() == 1 else positions[0]
    qpos = seq_rows(pos1, lay, dim=0)
    own = qpos if positions.dim() == 1 else seq_rows(positions, lay)
    k = rope(torch.einsum("bsd,dhk->bshk", x, wk.to(x.dtype)), own,
             cfg.rope_theta)
    v = torch.einsum("bsd,dhk->bshk", x, wv.to(x.dtype))
    k, v = seq_gather(k, lay), seq_gather(v, lay)
    q = rope(torch.einsum("bsd,dhk->bshk", x, wq.to(x.dtype)), own,
             cfg.rope_theta)
    out = _attend(q, k, v, cfg=cfg, window=window, positions=positions,
                  q_positions=qpos if lay.seq else None, chunked_ok=False)
    out = torch.einsum("bshk,hkd->bsd", out, wo.to(x.dtype))
    return out, _kv_pin(k, v, cfg, lay)


def _kv_heads(params, h, cfg: ModelConfig, lay, positions):
    """heads mode's k/v: (k, v of the kv heads [lo, hi) that this rank's
    q heads read (:func:`_gqa_block`), this rank's cache shard).  A rank
    projects only what it reads or keeps:

    * kv heads split over 'model' (they divide): its own kv heads, which
      are its block and its cache shard;
    * else, with head_dim dividing by the model axis: its head_dim slice
      of every kv head (its ``kv_shard="hd"`` cache shard), all-gathered
      over 'model' before RoPE (which pairs the two halves of a head),
      then its block sliced out: the JAX package's layout, where the kv
      pin shards the projection on head_dim;
    * else every kv head (the cache, unpinned, is every head)."""
    tp, r = lay.tp, lay.tp_rank
    wk, wv = _w(params, "wk", lay), _w(params, "wv", lay)
    lo, hi = _gqa_block(cfg.n_heads, cfg.n_kv_heads, tp, r)
    if tp_sharded(params.wk, 1) or tp == 1:
        k = rope(torch.einsum("bsd,dhk->bshk", h, wk.to(h.dtype)), positions,
                 cfg.rope_theta)
        v = torch.einsum("bsd,dhk->bshk", h, wv.to(h.dtype))
        return k, v, _kv_pin(k, v, cfg, lay)
    hd = wk.shape[2]
    if hd % tp == 0:
        a, b = r * hd // tp, (r + 1) * hd // tp
        k = comm.gather(torch.einsum("bsd,dhk->bshk", h,
                                     wk[:, :, a:b].to(h.dtype)), 3, lay.model)
        v = comm.gather(torch.einsum("bsd,dhk->bshk", h,
                                     wv[:, :, a:b].to(h.dtype)), 3, lay.model)
    else:
        k = torch.einsum("bsd,dhk->bshk", h, wk.to(h.dtype))
        v = torch.einsum("bsd,dhk->bshk", h, wv.to(h.dtype))
    k = rope(k, positions, cfg.rope_theta)
    return k[:, :, lo:hi], v[:, :, lo:hi], _kv_pin(k, v, cfg, lay)


def _kv_pin(k, v, cfg: ModelConfig, lay):
    """The prefill kv pin: the per-layer caches leave the layer sharded
    on the TP axis, kv heads (``kv_shard="heads"``) or head_dim
    (``"hd"``), so the serving artifact is not replicated.  A rank keeps
    its shard of k/v of every position of its batch rows; k/v that are
    already this rank's kv heads are that shard."""
    if k.shape[2] != cfg.n_kv_heads or cfg.kv_shard not in ("heads", "hd"):
        return {"k": k, "v": v}
    dim = 2 if cfg.kv_shard == "heads" else 3
    return {"k": comm.chunk(k, dim, lay.model),
            "v": comm.chunk(v, dim, lay.model)}


def attention(params, x, *, cfg: ModelConfig, kind: str, positions,
              kv_cache=None, cache_pos: int | None = None, lay=None):
    """Prefill when kv_cache is None; single-step decode otherwise.

    Decode: x is [B, 1, d]; kv_cache = dict(k=[B, Smax, K, hd], v=...) and
    cache_pos the position.  The new k/v are written into kv_cache in place
    (the JAX package returns an updated copy); returns (out, kv_cache).
    On a mesh x and kv_cache are this rank's (:func:`_decode_tp`).
    """
    if lay is not None and kv_cache is not None:
        return _decode_tp(params, x, cfg=cfg, positions=positions,
                          kv_cache=kv_cache, cache_pos=cache_pos, lay=lay)
    if lay is not None:
        return _attention_tp(params, x, cfg=cfg, kind=kind,
                             positions=positions, lay=lay)
    S = x.shape[1]
    scale = cfg.hd ** -0.5
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(x.dtype))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    window = cfg.window_size if kind in (LOCAL, SWA) else 0

    if kv_cache is None:
        out = _attend(q, k, v, cfg=cfg, window=window, positions=positions)
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


def _gather_to(t, dim: int, whole: int, lay):
    """``t`` whole along ``dim`` (``whole`` long): all-gathered over
    'model' when this rank holds a 1/tp slice of it."""
    if t.shape[dim] == whole:
        return t
    return comm.all_gather(t, dim, lay.model)


def _slice_of(t, dim: int, lay):
    """This rank's 1/tp slice of ``t`` along ``dim`` (over 'model')."""
    return comm.chunk(t, dim, lay.model)


def _decode_tp(params, x, *, cfg: ModelConfig, positions, kv_cache,
               cache_pos: int, lay):
    """Single-step decode on a mesh, the cache laid out as the JAX
    package's ``cache_pspecs`` lays it out.  x: this rank's batch rows
    [B, 1, d] (every row when the batch is not split); kv_cache: this
    rank's shard of the layer's cache.  The cache's kv heads are split
    over 'model' when they divide it (a rank attends with its q heads
    over its kv heads); otherwise its head_dim is: q is all-gathered
    (one token), the scores are partial sums over 'model', and the
    weighted sum is this rank's head_dim slice of every head.  With
    ``lay.cache_seq`` (batch 1) the cache's positions are split over
    'data' too, and the softmax is combined over it.  A rank projects
    the new token's k/v of its own cache slice (k all-gathered on
    head_dim before RoPE, which pairs the two halves of a head) and
    writes them where it holds that position.  ``wo``'s partial sums
    meet in ``shard_act``.  Returns (out [B, 1, d], kv_cache)."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ck, cv = kv_cache["k"], kv_cache["v"]
    by_heads, by_hd = ck.shape[2] != K, ck.shape[3] != hd
    wq, wk, wv = (_w(params, n, lay) for n in ("wq", "wk", "wv"))
    q = torch.einsum("bsd,dhk->bshk", x, wq.to(x.dtype))
    if by_heads:                 # its q heads read its kv heads
        assert tp_sharded(params.wq, 1) and tp_sharded(params.wk, 1)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(torch.einsum("bsd,dhk->bshk", x, wk.to(x.dtype)),
                 positions, cfg.rope_theta)
        v = torch.einsum("bsd,dhk->bshk", x, wv.to(x.dtype))
    else:                        # every q head, whole, then its slice
        q = _gather_to(q, 2, H, lay)
        q = rope(_gather_to(q, 3, hd, lay), positions, cfg.rope_theta)
        if by_hd and not tp_sharded(params.wk, 2):
            wk, wv = _slice_of(wk, 2, lay), _slice_of(wv, 2, lay)
        k = torch.einsum("bsd,dhk->bshk", x, wk.to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", x, wv.to(x.dtype))
        k = rope(_gather_to(_gather_to(k, 2, K, lay), 3, hd, lay),
                 positions, cfg.rope_theta)
        if by_hd:
            q, k = _slice_of(q, 3, lay), _slice_of(k, 3, lay)
        else:
            v = _gather_to(_gather_to(v, 2, K, lay), 3, hd, lay)

    # the ring buffer, its positions split over 'data' with cache_seq
    n_loc = ck.shape[1]
    seq = lay.mesh.get_group("data") if lay.cache_seq else None
    n_all = n_loc * (comm.size(seq) if seq is not None else 1)
    first = n_loc * (comm.rank(seq) if seq is not None else 0)
    widx = cache_pos % n_all - first
    if 0 <= widx < n_loc:
        ck[:, widx:widx + 1] = k
        cv[:, widx:widx + 1] = v
    n_valid = min(cache_pos + 1, n_all)
    mask = (torch.arange(n_loc, device=x.device) + first < n_valid)[None, :]
    out = _sdpa(q, ck, cv, mask, scale=hd ** -0.5, cfg=cfg,
                hd_group=lay.model if by_hd else None, seq_group=seq)

    # out: its heads (by_heads), its head_dim slice of every head (by_hd)
    # or every head whole; wo takes it in wo's own layout
    wo = _w(params, "wo", lay)
    heads_wo, hd_wo = tp_sharded(params.wo, 0), tp_sharded(params.wo, 1)
    if not (by_heads and heads_wo or by_hd and hd_wo):
        out = _gather_to(_gather_to(out, 2, H, lay), 3, hd, lay)
        if heads_wo:
            out = _slice_of(out, 2, lay)
        elif hd_wo:
            out = _slice_of(out, 3, lay)
    out = torch.einsum("bshk,hkd->bsd", out, wo.to(x.dtype))
    if heads_wo or hd_wo:        # partial sums over 'model'
        out = shard_act(out, lay)
    return out, kv_cache


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


def mlp_partial(params, h, lay=None):
    """The gated MLP of rows ``h`` that hold every position.  On a mesh
    w_gate / w_up are column-parallel and w_down row-parallel on 'mlp':
    the result is this rank's partial sum over 'model'."""
    h1 = F.silu(h @ _w(params, "w_gate", lay).to(h.dtype)) \
        * (h @ _w(params, "w_up", lay).to(h.dtype))
    return h1 @ _w(params, "w_down", lay).to(h.dtype)


def mlp(params, x, lay=None):
    """Gated-SiLU MLP.  On a mesh a TP block: the sequence gathered, the
    products on this rank's ff columns, the partial sums pinned back to
    the residual layout (``shard_act``)."""
    if lay is None:
        return mlp_partial(params, x)
    return shard_act(mlp_partial(params, seq_gather(x, lay), lay), lay)


# ---------------------------------------------------------------------------
# embeddings / heads / frontends
# ---------------------------------------------------------------------------

def embed_struct(cfg: ModelConfig):
    s = {"tok": P((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"))}
    if cfg.frontend in ("audio_stub", "vision_stub"):
        s["frontend_proj"] = P((cfg.frontend_dim, cfg.d_model),
                               ("frontend", "embed"))
    return s


def lookup(params, tokens, lay=None):
    """Rows of the token table for ``tokens`` (every position).  On a mesh
    with the vocab split over 'model' each rank looks up the tokens of its
    own vocab block and zeros the rest: a partial sum over 'model' that
    has one nonzero term per row, so its combine is exact.  Returns
    (rows, partial)."""
    tok = _w(params, "tok", lay)
    if lay is None or not tp_sharded(params.tok, 0):
        return tok[tokens.long()], False
    n = tok.shape[0]
    idx = tokens.long() - lay.tp_rank * n
    hit = (idx >= 0) & (idx < n)
    rows = tok[idx.clamp(0, n - 1)].masked_fill(~hit[..., None], 0)
    return rows, True


def embed(params, tokens, cfg: ModelConfig, lay=None):
    """Token embedding scaled by sqrt(d_model) in the table's dtype, as the
    JAX package does (standard Llama does not scale).  On a mesh the
    embedding comes out in the residual layout: the vocab-parallel partial
    rows combined by ``shard_act`` (this is where the JAX package's
    gather meets a vocab-sharded table), or this rank's rows looked up
    from a whole table."""
    if lay is None:
        x = params.tok[tokens.long()]
    elif tp_sharded(params.tok, 0):
        x = shard_act(lookup(params, tokens, lay)[0], lay)
    else:
        x = lookup(params, seq_rows(tokens, lay), lay)[0]
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def head_struct(cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {}
    return {"w": P((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))}


def lm_logits(head_params, embed_params, x, cfg: ModelConfig, lay=None):
    """Logits [.., V].  On a mesh: this rank's residual rows gathered to
    every position, times its vocab columns (vocab-parallel when the vocab
    is split over 'model'); the padded vocab is kept, and
    :func:`cross_entropy` leaves the padding out."""
    if lay is not None:
        x = seq_gather(x, lay)
        if cfg.tie_embeddings:
            return x @ _w(embed_params, "tok", lay).to(x.dtype).T
        return x @ _w(head_params, "w", lay).to(x.dtype)
    if cfg.tie_embeddings:
        w = embed_params.tok.to(x.dtype).T
    else:
        w = head_params.w.to(x.dtype)
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


def vocab_sharded(head_params, embed_params, cfg: ModelConfig) -> bool:
    """Whether the logits' vocab is split over 'model' on a mesh."""
    if cfg.tie_embeddings:
        return tp_sharded(embed_params.tok, 0)
    return tp_sharded(head_params.w, 1)


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


def cross_entropy_tp(logits, labels, mask, cfg: ModelConfig, lay,
                     sharded: bool):
    """This rank's share of the mean CE on a mesh: the shares of all ranks
    sum to the global mean.  ``logits`` [B/data, S, V/model] (``sharded``)
    or [B/data, S, V]: the log-sum-exp and the gold logit are summed over
    'model' (vocab-parallel CE: no logits gather, as the JAX package's
    one-hot contraction); columns past the vocab (padding) are left out.
    The count of valid positions is summed over 'data'."""
    logits = logits.float()
    n = logits.shape[-1]
    lo = lay.tp_rank * n if sharded else 0
    if lo + n > cfg.vocab_size:
        col = torch.arange(n, device=logits.device) + lo
        logits = logits.masked_fill(col >= cfg.vocab_size, float("-inf"))
    m = logits.detach().amax(dim=-1, keepdim=True)
    if sharded:
        m = comm.all_reduce(m, lay.model, op=dist.ReduceOp.MAX)
    s = torch.exp(logits - m).sum(-1)
    idx = labels.long() - lo
    hit = (idx >= 0) & (idx < n)
    gold = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    gold = gold.masked_fill(~hit, 0)
    if sharded:
        s, gold = comm.psum(s, lay.model), comm.psum(gold, lay.model)
    nll = torch.log(s) + m[..., 0] - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    count = mask.sum().detach()
    if lay.batch:
        count = comm.all_reduce(count, lay.data)
    share = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    return share / (lay.tp * (1 if lay.batch else lay.dp))
