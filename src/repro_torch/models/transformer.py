"""Model assembly (port of ``repro.models.transformer``): layer plans ->
param structure, the model as ``nn.Module``s, forward (prefill and
training), the training loss and decode.

The param tree keeps the JAX package's layout: ``segments[i][str(j)]``
holds the stacked ``[repeat, ...]`` params of pattern position ``j``.
:class:`Transformer` wraps it as modules, one :class:`Params` block per
layer (a view of its slice, not a copy), and the Python loop over layers
takes the place of ``lax.scan``.  Dense GLOBAL / LOCAL / SWA, RECURRENT
(RG-LRU) and RWKV-6 layers are ported, each with a dense or (in an ``moe``
segment) a mixture-of-experts FFN, behind a token embedding or an audio or
vision frontend stub; MLA (latent attention, :mod:`.mla`) is the port's
own kind, on one device only.

A param tree of DTensors (a sharded model: ``init_params(mesh=, specs=)``,
as ``launch/train.py``'s ``build_train_state(mesh=)`` draws it) makes a
sharded
:class:`Transformer`: its modules hold this rank's local shards, and
forward, the loss and the backward pass run on a
:class:`~repro_torch.sharding.layout.Layout` (``sharding/layout.py`` says
how the collectives and gradients go).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint as ckpt
from torch import nn

from repro_torch import tracing
from repro_torch.sharding import comm
from repro_torch.sharding.layout import Layout, fetch, mark, seq_rows

from .base import (GLOBAL, MLA, RECURRENT, RWKV, ModelConfig, P, Params,
                   tree_leaves, tree_map)
from .layers import (attention, attention_cache_struct, attention_struct,
                     cross_entropy, cross_entropy_tp, embed, embed_struct,
                     head_struct, lm_logits, lookup, mlp, mlp_struct,
                     rmsnorm, rmsnorm_struct, vocab_sharded)
from .mla import mla, mla_cache_struct, mla_struct
from .moe import moe, moe_struct
from .recurrent import (rglru, rglru_state_struct, rglru_struct,
                        rwkv6_channel_mix, rwkv6_state_struct, rwkv6_struct,
                        rwkv6_time_mix)

# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def _stack(struct, r: int):
    """Add a leading stacked-layers axis to every P leaf."""
    return tree_map(lambda p: P((r,) + p.shape, ("layers",) + p.axes,
                                init=p.init, scale=p.scale, dtype=p.dtype),
                    struct)


def _segments(cfg: ModelConfig) -> list[dict]:
    """Expand the layer plan into segments with per-position layer kinds and
    moe-ness.  first_dense_layers (DeepSeek) forces dense FFN at the start."""
    segs = []
    layer_idx = 0
    for pattern, repeat in cfg.layer_plan:
        if (cfg.family == "moe" and cfg.first_dense_layers > layer_idx
                and repeat > 1):
            n_dense = min(repeat, -(-(cfg.first_dense_layers - layer_idx)
                                    // len(pattern)))
            segs.append({"pattern": pattern, "repeat": n_dense,
                         "moe": False})
            layer_idx += n_dense * len(pattern)
            if repeat - n_dense:
                segs.append({"pattern": pattern, "repeat": repeat - n_dense,
                             "moe": True})
                layer_idx += (repeat - n_dense) * len(pattern)
        else:
            is_moe = cfg.family == "moe" and layer_idx >= cfg.first_dense_layers
            segs.append({"pattern": pattern, "repeat": repeat, "moe": is_moe})
            layer_idx += repeat * len(pattern)
    return segs


def _layer_struct(cfg: ModelConfig, kind: str, is_moe: bool):
    d = cfg.d_model
    if kind == RWKV:
        s = rwkv6_struct(cfg)
        return {"ln1": rmsnorm_struct(d), "tm": s["tm"],
                "ln2": rmsnorm_struct(d), "cm": s["cm"]}
    core = ({"rglru": rglru_struct(cfg)} if kind == RECURRENT
            else {"mla": mla_struct(cfg)} if kind == MLA
            else {"attn": attention_struct(cfg)})
    ffn = moe_struct(cfg) if is_moe else mlp_struct(d, cfg.d_ff)
    return {"ln1": rmsnorm_struct(d), **core,
            "ln2": rmsnorm_struct(d), "ffn": ffn}


def model_struct(cfg: ModelConfig):
    seg_structs = []
    for seg in _segments(cfg):
        per_pos = {str(j): _layer_struct(cfg, kind, seg["moe"])
                   for j, kind in enumerate(seg["pattern"])}
        seg_structs.append(_stack(per_pos, seg["repeat"]))
    return {
        "embed": embed_struct(cfg),
        "segments": seg_structs,
        "final_norm": rmsnorm_struct(cfg.d_model),
        "head": head_struct(cfg),
    }


def cache_struct(cfg: ModelConfig, batch: int, max_len: int, *,
                 tp_layout: bool = False):
    """Decode-state structure mirroring the segment layout.  ``tp_layout``:
    the RWKV-6 states laid out as a mesh keeps them
    (:func:`~repro_torch.models.recurrent.rwkv6_state_struct`)."""
    out = []
    for seg in _segments(cfg):
        per_pos = {}
        for j, kind in enumerate(seg["pattern"]):
            if kind == RWKV:
                per_pos[str(j)] = rwkv6_state_struct(cfg, batch, tp_layout)
            elif kind == RECURRENT:
                per_pos[str(j)] = rglru_state_struct(cfg, batch)
            elif kind == MLA:
                # the latents c_kv and k_pe of every position
                per_pos[str(j)] = mla_cache_struct(cfg, batch, max_len)
            else:
                # local/swa layers only need a window-sized cache
                n = max_len if kind == GLOBAL else min(
                    max_len, max(cfg.window_size, 1))
                per_pos[str(j)] = attention_cache_struct(cfg, batch, n)
        out.append(_stack(per_pos, seg["repeat"]))
    return out


class Transformer(nn.Module):
    """The model's parameters as modules: ``embed``, ``segments[i][r]``
    (one :class:`Params` block per layer, keyed by pattern position),
    ``final_norm`` and ``head``.  ``tree`` is the param tree they wrap, in
    the JAX package's stacked layout: each module parameter shares its
    storage with a leaf (or a layer's slice of one), so an in-place update
    of the tree is what the modules compute with.

    The parameters are frozen; :meth:`trainable` makes them require grad,
    once, for training.

    A tree of DTensors makes a sharded model on their ``DeviceMesh``
    (``self.mesh``; ``None`` for a model on one device): the modules hold
    views of this rank's local shards, each marked with the tensor
    dimension that each mesh dimension splits.  ``defer_data_grads``
    (ZeRO-1) leaves a data-replicated weight's gradient as this rank's
    part (:class:`~repro_torch.sharding.layout.Layout`)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.tree = params
        self.grads = None
        self.defer_data_grads = False
        first = tree_leaves(params)[0]
        self.mesh = getattr(first, "device_mesh", None)
        self.embed = local_params(params["embed"])
        self.segments = nn.ModuleList(
            nn.ModuleList(local_params(seg_params, layer=r)
                          for r in range(seg["repeat"]))
            for seg, seg_params in zip(_segments(cfg), params["segments"]))
        self.final_norm = local_params(params["final_norm"])
        self.head = local_params(params["head"])

    def trainable(self) -> dict:
        """Make every parameter require grad, and give it a gradient in the
        tree's stacked layout: ``self.grads``, a tree of zeros laid out as
        ``self.tree``, whose leaves (or their layer slices) are the module
        parameters' ``.grad``.  A backward pass adds into them in place;
        zero them before the next.  A parameter that the loss never reads
        keeps a zero gradient.  Returns ``self.grads``."""
        if self.grads is None:
            self.grads = tree_map(_zeros_like_local, self.tree)

            def bind(module, grads, r=None):
                for name, g in grads.items():
                    if isinstance(g, dict):
                        bind(getattr(module, name), g, r)
                        continue
                    p = getattr(module, name)
                    p.requires_grad_(True)
                    if self.mesh is not None:    # a view of the local shard
                        g = g.to_local()
                    p.grad = g if r is None else g[r]

            for name in ("embed", "final_norm", "head"):
                bind(getattr(self, name), self.grads[name])
            for layers, seg_grads in zip(self.segments,
                                         self.grads["segments"]):
                for r, lp in enumerate(layers):
                    bind(lp, seg_grads, r)
        return self.grads


def _zeros_like_local(t):
    """Zeros laid out as ``t``; for a DTensor, made from zeros of its local
    shard, read without a dispatch (``to_local`` is a view op, whose
    output a dry run's ``MemTracker`` would count as new bytes).
    ``zeros_like`` of the DTensor itself dispatches the global shape,
    which torch 2.11's ``MemTracker`` counts as that many bytes on the
    rank (torch 2.13's counts the shard): a dry run's peak held the whole
    gradient of each sharded weight there, 30 GB for each of
    mixtral-8x7b's two expert stacks."""
    if not hasattr(t, "device_mesh"):
        return torch.zeros_like(t)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(torch.zeros_like(t._local_tensor),
                              t.device_mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _placement_dims(t) -> tuple:
    """The tensor dimension each mesh dimension of a DTensor shards."""
    return tuple(p.dim if p.is_shard() else None for p in t.placements)


def local_params(tree: dict, layer: int | None = None) -> Params:
    """A :class:`Params` over a param tree (``layer``: that slice of each
    stacked leaf).  For a tree of DTensors it holds views of this rank's
    local shards, each marked with the tensor dimension that each mesh
    dimension splits (a layer's slice drops the stacked layers dim, which
    is never sharded)."""
    def local(t):
        t = t.to_local() if hasattr(t, "device_mesh") else t
        return t if layer is None else t[layer]

    module = Params(tree_map(local, tree))
    _mark(module, tree, layer is not None)
    return module


def _mark(module, tree, stacked: bool):
    for name, t in tree.items():
        if isinstance(t, dict):
            _mark(getattr(module, name), t, stacked)
        elif hasattr(t, "device_mesh"):
            dims = _placement_dims(t)
            if stacked:
                assert 0 not in dims, (name, dims)
                dims = tuple(None if d is None else d - 1 for d in dims)
            mark(getattr(module, name), dims)


def layout(params: Transformer, cfg: ModelConfig, seq_len: int):
    """The :class:`Layout` of a forward of ``seq_len`` positions on the
    model's mesh (``None`` on one device): the batch split over the data
    axes ('data', or 'pod' x 'data') when ``cfg.batch_axes`` says so,
    the residual stream's sequence split over 'model' when
    ``cfg.act_shard == "seq"`` and it divides."""
    if params.mesh is None:
        return None
    mesh = params.mesh
    assert tuple(mesh.mesh_dim_names) in (("data", "model"),
                                          ("pod", "data", "model")), \
        mesh.mesh_dim_names
    tp = mesh["model"].size()
    return Layout(mesh, batch=bool(cfg.batch_axes),
                  seq=(cfg.act_shard == "seq" and seq_len > 1
                       and seq_len % tp == 0),
                  defer_data_grads=params.defer_data_grads)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params: Transformer, cfg: ModelConfig, batch: dict, lay=None):
    """The input embedding of ``batch``, scaled by sqrt(d_model) in its
    dtype.  The modality frontends are stubs: ``frames`` (audio) are
    projected alone, and take the frames' dtype, so f32 frames run a bf16
    model's layers in f32 as in the JAX package; ``patches`` (vision) are
    projected, cast to the table's dtype and put ahead of the tokens.

    On a mesh the result is in the residual layout: the token embedding
    as :func:`~repro_torch.models.layers.embed` makes it, a frontend's
    every position on each rank, then its rows."""
    if cfg.frontend == "token":
        return embed(params.embed, batch["tokens"], cfg, lay)
    e = params.embed
    proj = e.frontend_proj if lay is None else fetch(e.frontend_proj, lay)
    if cfg.frontend == "audio_stub":
        frames = batch["frames"]
        x = frames @ proj.to(frames.dtype)
    else:
        tok, partial = lookup(e, batch["tokens"], lay)
        if partial:
            tok = comm.psum(tok, lay.model)
        patches = batch["patches"]
        patch = patches @ proj.to(patches.dtype)
        x = torch.cat([patch.to(tok.dtype), tok], dim=1)
    if lay is not None:
        x = seq_rows(x, lay)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def _apply_layer(lp, x, *, cfg: ModelConfig, kind: str, is_moe: bool,
                 positions, cache=None, cache_pos=None, lay=None):
    """One residual block.  Returns (x, new_cache, aux).

    On a mesh every block is tensor-parallel and returns its output in the
    residual layout (the JAX package's ``shard_act`` pins on the sublayer
    outputs and on the sum are the combines inside them; ``cfg.tp_impl``
    "shard_map" is the same path, see :mod:`.shardmap_tp`); the RG-LRU and
    RWKV-6 states are the rank's channels."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(lp.ln1, x, cfg.norm_eps, lay)
    if kind == RWKV:
        with tracing.span("time_mix"):
            out, tm_state = rwkv6_time_mix(
                lp.tm, h, cfg=cfg,
                state=None if cache is None else {
                    "shift": cache["tm_shift"], "wkv": cache["wkv"]},
                lay=lay)
        x = x + out
        h2 = rmsnorm(lp.ln2, x, cfg.norm_eps, lay)
        with tracing.span("channel_mix"):
            out2, cm_state = rwkv6_channel_mix(
                lp.cm, h2,
                state=None if cache is None else {"shift": cache["cm_shift"]},
                lay=lay)
        return x + out2, {"tm_shift": tm_state["shift"],
                          "wkv": tm_state["wkv"],
                          "cm_shift": cm_state["shift"]}, aux
    if kind == RECURRENT:
        with tracing.span("rglru"):
            out, new_cache = rglru(lp.rglru, h, cfg=cfg, state=cache,
                                   lay=lay)
    elif kind == MLA:
        with tracing.span("mla"):
            out, new_cache = mla(lp.mla, h, cfg=cfg, positions=positions,
                                 cache=cache, cache_pos=cache_pos, lay=lay)
    else:
        with tracing.span("attention"):
            out, new_cache = attention(lp.attn, h, cfg=cfg, kind=kind,
                                       positions=positions, kv_cache=cache,
                                       cache_pos=cache_pos, lay=lay)
    x = x + out
    h2 = rmsnorm(lp.ln2, x, cfg.norm_eps, lay)
    if is_moe:
        with tracing.span("moe"):
            out2, aux = moe(lp.ffn, h2, cfg, lay)
    else:
        with tracing.span("mlp"):
            out2 = mlp(lp.ffn, h2, lay)
    return x + out2, new_cache, aux


def _save_dots(ctx, func, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of products with no batch
    dims (JAX's ``dots_with_no_batch_dims_saveable``; an einsum without
    batch dims runs as a ``bmm`` of batch 1), recompute the rest."""
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.addmm.default) or (
            func is aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig):
    """Activation checkpointing of one layer-pattern repeat: ``"full"``
    keeps only its input and recomputes the rest in the backward pass,
    ``"dots"`` keeps the products' outputs too."""
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    return fn


def _seq_len(cfg: ModelConfig, batch: dict) -> int:
    if cfg.frontend == "audio_stub":
        return batch["frames"].shape[1]
    n = batch["tokens"].shape[1]
    return n + (batch["patches"].shape[1] if cfg.frontend == "vision_stub"
                else 0)


def _forward(params: Transformer, cfg: ModelConfig, batch: dict, lay,
             return_cache: bool):
    """:func:`forward` on local tensors: on a mesh the logits are this
    rank's [B/data, S, V/model] and the caches its shards."""
    S = _seq_len(cfg, batch)
    with tracing.span("embed"):
        x = _embed(params, cfg, batch, lay)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    caches = [] if return_cache else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    for seg, layers in zip(_segments(cfg), params.segments):
        def body(x, lp, pattern=seg["pattern"], is_moe=seg["moe"]):
            new_caches = {}
            aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
            for j, kind in enumerate(pattern):
                x, c, aux = _apply_layer(getattr(lp, str(j)), x, cfg=cfg,
                                         kind=kind, is_moe=is_moe,
                                         positions=positions, lay=lay)
                new_caches[str(j)] = c
                aux_sum = aux_sum + aux
            return x, new_caches, aux_sum

        body = _remat_wrap(body, cfg)
        per_pos = {str(j): [] for j in range(len(seg["pattern"]))}
        for lp in layers:
            x, cs, aux = body(x, lp)
            aux_total = aux_total + aux
            if return_cache:
                for j, c in cs.items():
                    per_pos[j].append(c)
        if return_cache:
            with tracing.span("cache_stack"):
                caches.append({j: {name: torch.stack([c[name] for c in cs])
                                   for name in cs[0]}
                               for j, cs in per_pos.items()})

    with tracing.span("head"):
        x = rmsnorm(params.final_norm, x, cfg.norm_eps, lay)
        logits = lm_logits(params.head, params.embed, x, cfg, lay)
    return logits, aux_total, caches


def _as_dtensor(local, lay: Layout, cfg: ModelConfig, shard_dims: dict):
    """Wrap a rank's output shard as a DTensor: the batch dim (``shard_dims
    ["batch"]``) on the data axes when the batch is split, and the first of
    ``shard_dims["model"]`` whose local size is short of ``full`` on
    'model'."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [Shard(shard_dims["batch"]) if lay.batch else Replicate()
          for _ in lay.data_dims] + [Replicate()]
    for dim, full in shard_dims["model"]:
        if local.shape[dim] * lay.tp == full and lay.tp > 1:
            pl[-1] = Shard(dim)
            break
    return DTensor.from_local(local, lay.mesh, pl, run_check=False)


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            return_cache: bool = False):
    """Full-sequence forward (prefill and training).  ``batch`` holds
    ``tokens``, or ``frames`` (audio_stub), or ``tokens`` and ``patches``
    (vision_stub: the logits cover the patches, then the tokens).  Each
    repeat of a segment's layer pattern is checkpointed as ``cfg.remat``
    says.

    Returns (logits, aux_loss, caches); caches is None unless requested, and
    is then stacked per segment like the JAX package's scan output.

    On a mesh ``batch`` holds this rank's batch rows (its
    ``batch_pspec`` slice), and the logits and caches come back as
    DTensors: logits [B, S, padded vocab] split on the batch over 'data'
    and on the vocab over 'model' (when the rules split it); attention
    caches [L, B, S, K, hd] on the batch and on kv heads or head_dim as
    the kv pin leaves them; recurrent states on the batch and on their
    channels over 'model', the RWKV-6 ones laid out as
    ``cache_struct(tp_layout=True)`` lays them out.
    """
    lay = layout(params, cfg, _seq_len(cfg, batch))
    logits, aux, caches = _forward(params, cfg, batch, lay, return_cache)
    if lay is None:
        return logits, aux, caches
    logits = _as_dtensor(logits, lay, cfg, {
        "batch": 0, "model": [(2, cfg.padded_vocab)]})
    if caches is not None:
        caches = [{j: {name: _as_dtensor(t, lay, cfg, {
            "batch": 1, "model": _cache_model_dims(name, cfg)})
            for name, t in c.items()}
            for j, c in seg.items()} for seg in caches]
    return logits, aux, caches


def _cache_model_dims(name: str, cfg: ModelConfig) -> list:
    """The (dim, whole size) pairs of a stacked cache leaf [L, B, ...] that
    'model' may split: kv heads or head_dim of k / v; the channels of the
    RG-LRU and RWKV-6 states."""
    if name in ("k", "v"):
        return [(3, cfg.n_kv_heads), (4, cfg.hd)]
    w = cfg.lru_width or cfg.d_model
    return {"conv": [(3, w)], "h": [(2, w)], "tm_shift": [(3, cfg.d_model)],
            "cm_shift": [(3, cfg.d_model)], "wkv": [(3, cfg.d_model)]}[name]


def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict):
    """Scalar loss for one batch; labels/masks per family.  Returns
    (ce + 0.01 * aux, {"ce", "aux"}).

    On a mesh (``batch`` this rank's rows) the value is the global loss and
    the gradient that of this rank's share of it (the vocab-parallel CE
    share, and 0.01 * aux over the ranks): a backward pass of every rank
    leaves each weight's global gradient in its shards."""
    lay = layout(params, cfg, _seq_len(cfg, batch))
    logits, aux, _ = _forward(params, cfg, batch, lay, False)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.frontend == "vision_stub":
        # logits cover [patches; tokens] — score text positions only
        n_txt = labels.shape[1]
        logits = logits[:, -n_txt:]
    if cfg.is_decoder and cfg.frontend == "token":
        logits = logits[:, :-1]
        labels = labels[:, 1:]
        mask = None if mask is None else mask[:, 1:]
    if lay is None:
        ce = cross_entropy(logits, labels, mask)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}
    ce_share = cross_entropy_tp(logits, labels, mask, cfg, lay,
                                vocab_sharded(params.head, params.embed, cfg))
    share = ce_share + 0.01 * aux / lay.world
    ce = comm.all_reduce(comm.all_reduce(ce_share.detach(), lay.data),
                         lay.model)
    total = ce + 0.01 * aux.detach()
    # the value is total on every rank bit for bit (share - share is 0
    # exactly; share + (total - share) rounds by share, a rank's own), the
    # gradient that of this rank's share
    return share - share.detach() + total, {"ce": ce, "aux": aux.detach()}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params: Transformer, cfg: ModelConfig, caches, tokens,
                cache_pos: int):
    """One token step.  tokens: [B, 1] int; caches as from cache_struct
    (stacked per segment), updated in place; cache_pos: the position.
    Attention writes its ring buffer in place; a recurrent or RWKV layer
    returns new state tensors, which are copied into the stacked cache.
    The MoE layers' aux loss is dropped, as the JAX package's decode step
    drops it.

    Returns (logits [B, 1, V], caches).

    On a mesh ``tokens`` are this rank's batch rows (every row when the
    batch is not split) and ``caches`` DTensors laid out by
    ``cache_pspecs`` over ``cache_struct(tp_layout=True)``: the batch over
    the data axes, or (batch 1) the positions over 'data'; kv heads or
    head_dim over 'model' (:func:`~repro_torch.models.layers._decode_tp`);
    the recurrent states' channels over 'model'.  A MoE layer routes
    this rank's rows as one group, so its capacity is that of the rank's
    rows.  The logits come back as a DTensor, [B, 1, padded vocab], as
    :func:`forward`'s.
    """
    lay = layout(params, cfg, 1)
    if lay is not None:
        k = next((c["k"] for seg in caches for c in seg.values()
                  if "k" in c), None)
        pl = None if k is None else \
            k.placements[k.device_mesh.mesh_dim_names.index("data")]
        lay = dataclasses.replace(
            lay, cache_seq=pl is not None and pl.is_shard() and pl.dim == 2)
    x = embed(params.embed, tokens, cfg, lay)
    positions = torch.full((1,), cache_pos, dtype=torch.int32,
                           device=x.device)
    for seg, layers, seg_cache in zip(_segments(cfg), params.segments,
                                      caches):
        for r, lp in enumerate(layers):
            for j, kind in enumerate(seg["pattern"]):
                layer_cache = {name: _local(t)[r]
                               for name, t in seg_cache[str(j)].items()}
                x, new_cache, _ = _apply_layer(
                    getattr(lp, str(j)), x, cfg=cfg, kind=kind,
                    is_moe=seg["moe"], positions=positions, cache=layer_cache,
                    cache_pos=cache_pos, lay=lay)
                for name, t in new_cache.items():
                    if t is not layer_cache[name]:
                        layer_cache[name].copy_(t)

    x = rmsnorm(params.final_norm, x, cfg.norm_eps, lay)
    logits = lm_logits(params.head, params.embed, x, cfg, lay)
    if lay is not None:
        logits = _as_dtensor(logits, lay, cfg, {
            "batch": 0, "model": [(2, cfg.padded_vocab)]})
    return logits, caches


def _local(t):
    """A DTensor's local shard (a view of its storage), a tensor itself."""
    return t.to_local() if hasattr(t, "device_mesh") else t
