"""Cell builders (port of ``repro.launch.steps``): (arch x shape x mesh) ->
an eager step function, its abstract arguments and their layouts.  Used
by the dry run (``launch/dryrun.py``), the roofline table and the drivers;
also the prefill step and the mesh-to-config glue
(``_auto_score_shard``, ``_auto_kv_shard``, ``_mesh_batch_axes``).

A :class:`Cell` holds what the JAX package's holds: ``fn``, ``args`` and
``in_shardings`` / ``out_shardings``.  ``fn`` is an eager function of
real tensors: on the card the same ``fn`` trains, prefills or decodes.
``args`` are meta tensors of the global shapes (the JAX package's
``ShapeDtypeStruct``s), and ``in_shardings`` the rules' ``PartitionSpec``
trees of the state arguments (parameters, optimizer state, caches), which
``fn`` takes as DTensors so laid out.  The batch is ``None`` there: ``fn``
takes the global batch, as every rank of the train loop draws it, and
keeps its own rows by the batch specs (so a microbatch is a slice of the
global batch, as in the JAX package).  ``mesh=None`` is one device:
plain tensors, no layouts.  ``arch`` is a registered name or a
``ModelConfig`` (a smoke or cut one).

:func:`lower_cell` is the counterpart of ``jit(...).lower``: the step run
once on the meta device on this rank's shards, with its cost counted
(``launch/hlo_static.py``) and its memory tracked.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch import tracing
from repro_torch.configs import SHAPES, Shape, get_config
from repro_torch.models import (ModelConfig, Transformer, cache_struct,
                                decode_step, forward, loss_fn, model_struct)
from repro_torch.models.base import (PartitionSpec, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw_init_struct, adamw_update
from repro_torch.sharding import (cache_pspecs, comm, local_batch,
                                  param_pspecs)
from repro_torch.sharding.specs import data_axes, mesh_shape


def _auto_score_shard(cfg: ModelConfig, mesh) -> str:
    tp = mesh_shape(mesh).get("model", 1)
    return "heads" if cfg.n_heads % tp == 0 else "qseq"


def _auto_kv_shard(cfg: ModelConfig, mesh) -> str:
    tp = mesh_shape(mesh).get("model", 1)
    if cfg.n_kv_heads % tp == 0:
        return "heads"
    if cfg.hd % tp == 0:
        return "hd"
    return "none"


def _mesh_batch_axes(mesh, batch: int) -> tuple:
    dax = data_axes(mesh)
    n = 1
    for a in dax:
        n *= mesh_shape(mesh)[a]
    return tuple(dax) if (dax and batch % n == 0) else ()


def mesh_config(cfg: ModelConfig, mesh, batch: int, *,
                score_shard: str | None = None) -> ModelConfig:
    """``cfg`` with the knobs a cell sets from its mesh: ``score_shard``,
    ``batch_axes``, ``act_shard="seq"`` and ``kv_shard``."""
    return cfg.replace(
        score_shard=score_shard if score_shard is not None
        else _auto_score_shard(cfg, mesh),
        batch_axes=_mesh_batch_axes(mesh, batch),
        act_shard="seq", kv_shard=_auto_kv_shard(cfg, mesh))


def prefill_config(arch: str, *, smoke: bool = False,
                   attn_impl: str | None = None, mesh=None,
                   batch: int | None = None) -> ModelConfig:
    """The config ``prefill_cell`` runs: bf16 score materialization, and
    ``attn_impl`` when given; on a mesh (with the global ``batch``) also
    the knobs :func:`mesh_config` sets.  The caller casts the params to
    bf16."""
    cfg = get_config(arch, smoke=smoke)
    if mesh is not None:
        cfg = mesh_config(cfg, mesh, batch)
    cfg = cfg.replace(attn_dtype="bf16")
    if attn_impl is not None:
        cfg = cfg.replace(attn_impl=attn_impl)
    return cfg


def prefill(params: Transformer, cfg: ModelConfig, batch: dict):
    """Returns (logits [B, S, V], per-segment stacked caches: k/v for
    attention layers, c_kv/k_pe for latent attention, conv/h for RG-LRU,
    tm_shift/wkv/cm_shift for RWKV).
    On a mesh ``batch`` is this rank's rows and both come back as
    DTensors (see :func:`~repro_torch.models.transformer.forward`)."""
    with tracing.span("prefill"), torch.inference_mode():
        logits, _, caches = forward(params, cfg, batch,
                                    return_cache=cfg.is_decoder)
    return logits, caches


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _local(t):
    return t.to_local() if hasattr(t, "device_mesh") else t


def _like(local, t):
    """``local`` as a DTensor laid out as ``t`` (a DTensor), or itself."""
    if not hasattr(t, "device_mesh"):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _map_local(fn, tree, *more):
    """``fn`` over the leaves of ``tree`` (and of ``more``, laid out as
    ``tree``) on their local tensors; a DTensor result keeps the first
    tree's leaf's layout."""
    rest = [tree_leaves(t) for t in more]
    return tree_unflatten(tree, [
        _like(fn(_local(x), *(_local(r[i]) for r in rest)), x)
        for i, x in enumerate(tree_leaves(tree))])


def cast_tree(tree, dtype):
    """Every floating leaf of ``tree`` cast to ``dtype`` (a new tensor;
    a DTensor keeps its layout), the others as they are."""
    return _map_local(lambda x: x.to(dtype) if x.is_floating_point() else x,
                      tree)


def abstract(struct, dtype=torch.float32):
    """Meta tensors of a structure tree's shapes (a leaf's own dtype, or
    ``dtype``): the port's ``ShapeDtypeStruct``s."""
    return tree_map(lambda p: torch.empty(
        p.shape, dtype=getattr(torch, p.dtype) if p.dtype else dtype,
        device="meta"), struct)


# ---------------------------------------------------------------------------
# input specs (meta stand-ins for every model input)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta((B, 1), i32)}
    if cfg.frontend == "audio_stub":
        return {"frames": meta((B, S, cfg.frontend_dim), f32),
                "labels": meta((B, S), i32)}
    if cfg.frontend == "vision_stub":
        n_txt = S - cfg.n_patches
        return {"tokens": meta((B, n_txt), i32),
                "patches": meta((B, cfg.n_patches, cfg.frontend_dim), f32),
                "labels": meta((B, n_txt), i32),
                "loss_mask": meta((B, n_txt), f32)}
    return {"tokens": meta((B, S), i32), "labels": meta((B, S), i32),
            "loss_mask": meta((B, S), f32)}


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    fn: Callable           # eager, of real tensors
    args: tuple            # meta tensors of the global shapes
    in_shardings: tuple    # PartitionSpec trees of the state; None: whole
    out_shardings: Any
    donate_argnums: tuple = ()
    cfg: ModelConfig | None = None


def _shape(shape: str | Shape) -> Shape:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _config(arch: str | ModelConfig) -> ModelConfig:
    """A registered arch's config, or the given one (a smoke or cut
    config)."""
    return arch if isinstance(arch, ModelConfig) else get_config(arch)


def _rows(batch: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's rows of a global batch (all of it on one device)."""
    return batch if mesh is None else local_batch(batch, cfg, mesh)


def _model_of(params, cfg: ModelConfig, memo: dict, trainable: bool):
    """The :class:`Transformer` over ``params``, built on the first call
    with this tree and kept for the next."""
    if memo.get("params") is not params:
        memo["params"] = params
        memo["model"] = Transformer(cfg, params)
        if trainable:
            memo["model"].trainable()
    return memo["model"]


def _data_dims(mesh) -> list[int]:
    return [i for i, n in enumerate(mesh.mesh_dim_names)
            if n in ("pod", "data")]


def _to_fsdp(g, master):
    """ZeRO-1's reduce-scatter: a compute gradient (this rank's part,
    replicated layout over the data axes) summed over them into
    ``master``'s layout: reduce-scattered over each data axis that shards
    the master, all-reduced over one that replicates it."""
    x = g
    for i in _data_dims(master.device_mesh):
        p = master.placements[i]
        group = master.device_mesh.get_group(i)
        x = comm.reduce_scatter(x, p.dim, group) if p.is_shard() \
            else comm.all_reduce(x, group)
    return x


def _from_fsdp(w, master):
    """ZeRO-1's all-gather: a master shard (cast) back to the compute
    params' layout, replicated over the data axes."""
    x = w
    for i in reversed(_data_dims(master.device_mesh)):
        p = master.placements[i]
        if p.is_shard():
            x = comm.all_gather(x, p.dim, master.device_mesh.get_group(i))
    return x


def train_cell(arch: str | ModelConfig, shape: str | Shape, mesh, *,
               remat: str = "full", fsdp: bool = True,
               rule_overrides: dict | None = None,
               score_shard: str | None = None,
               microbatches: int = 1,
               attn_dtype: str = "bf16",
               attn_impl: str | None = None,
               rwkv_impl: str = "scan",
               param_mode: str = "fsdp",
               opt: AdamWConfig = AdamWConfig()) -> Cell:
    """param_mode:
    * "fsdp"  — f32 params FSDP x TP sharded; the step casts them to
      bf16 compute params (``loss_fn(cast_tree(p, bf16))``), whose
      weights are all-gathered on every use (again each microbatch);
      the gradients are summed in f32 over the microbatches;
    * "zero1" — bf16 compute params TP-sharded but REPLICATED across data;
      f32 master + moments stay FSDP x TP sharded in the optimizer state.
      Forward/backward do no weight collective over data (a weight's
      gradient stays this rank's part, summed over the microbatches in
      bf16); one reduce-scatter of the accumulated grads (bf16 on the
      wire) + one all-gather of the updated bf16 params per step.

    ``fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    updates ``params`` and ``opt_state`` in place (the JAX package
    donates them).  ``rwkv_impl`` is set on the config as the JAX package
    sets it; on a mesh the RG-LRU and RWKV-6 layers run their
    tensor-parallel forms (``models/recurrent.py``).
    The JAX package's ``tp_impl`` is not taken: its two values are one
    path here (``models/shardmap_tp.py``); nor is its ``rwkv_unroll``, a
    ``lax.scan`` unroll that eager PyTorch has no counterpart of."""
    shape = _shape(shape)
    cfg = _config(arch).replace(remat=remat)
    if mesh is not None:
        cfg = mesh_config(cfg, mesh, shape.global_batch,
                          score_shard=score_shard)
    cfg = cfg.replace(attn_dtype=attn_dtype, rwkv_impl=rwkv_impl)
    if attn_impl is not None:
        cfg = cfg.replace(attn_impl=attn_impl)
    struct = model_struct(cfg)
    ostruct = adamw_init_struct(struct)
    zero1 = param_mode == "zero1"
    assert param_mode in ("fsdp", "zero1"), param_mode
    ins = input_specs(cfg, shape)
    if mesh is None:
        pspec = opt_spec = None
    else:
        fsdp_spec = param_pspecs(struct, cfg, mesh, fsdp=True,
                                 overrides=rule_overrides)
        tp_spec = param_pspecs(struct, cfg, mesh, fsdp=False,
                               overrides=rule_overrides)
        pspec = tp_spec if zero1 else (
            fsdp_spec if fsdp else tp_spec)
        opt_spec = {"m": fsdp_spec if zero1 else pspec,
                    "v": fsdp_spec if zero1 else pspec,
                    "step": PartitionSpec()}
        if zero1:
            opt_spec["master"] = fsdp_spec
    if zero1:
        ostruct = dict(ostruct, master=struct)
    memo: dict = {}

    def microbatch(batch, i):
        B = next(iter(batch.values())).shape[0]
        n = B // microbatches
        return _rows({k: v[i * n:(i + 1) * n] for k, v in batch.items()},
                     cfg, mesh)

    def step(params, opt_state, batch):
        if zero1:                          # params already bf16
            model = _model_of(params, cfg, memo, True)
            model.defer_data_grads = mesh is not None
        else:
            fresh = memo.get("master") is not params
            if fresh:
                memo["master"] = params
                memo["compute"] = cast_tree(params, torch.bfloat16)
            model = _model_of(memo["compute"], cfg, memo, True)
            if not fresh:
                with torch.no_grad():
                    for c, p in zip(tree_leaves(model.tree),
                                    tree_leaves(params), strict=True):
                        _local(c).copy_(_local(p))
        gdt = torch.bfloat16 if zero1 else torch.float32
        grads = model.grads
        gsum = None
        lsum = torch.zeros((), dtype=torch.float32)
        # each gradient zeroed on its local shard: a DTensor's own zero_
        # also dispatches an empty tensor of the global shape, which torch
        # 2.11's MemTracker counts whole on the rank (a dry run's peak then
        # held a whole expert stack of mixtral-8x7b, 30 GB)
        for g in tree_leaves(grads):
            _local(g).zero_()
        for i in range(microbatches):
            if not zero1 and i:
                for g in tree_leaves(grads):
                    _local(g).zero_()
            loss, metrics = loss_fn(model, cfg, microbatch(batch, i))
            loss.backward()
            if not zero1:
                part = cast_tree(grads, gdt)
                gsum = part if gsum is None else _map_local(
                    torch.add, gsum, part)
            lsum = lsum.to(loss.device) + loss.detach()
        if zero1:
            gsum = grads
        if microbatches > 1:
            gsum = _map_local(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics = lsum, {k: v.detach() for k, v in
                                   metrics.items()}
        if not zero1:
            _, opt_state, gnorm = adamw_update(params, gsum, opt_state, opt)
            return params, opt_state, dict(metrics, loss=loss,
                                           grad_norm=gnorm)
        master = opt_state["master"]
        if mesh is not None:            # ONE reduce-scatter, bf16 wire
            gsum = tree_unflatten(master, [
                _like(_to_fsdp(_local(g), m).float(), m)
                for g, m in zip(tree_leaves(gsum), tree_leaves(master))])
        else:
            gsum = cast_tree(gsum, torch.float32)
        mstate = {"m": opt_state["m"], "v": opt_state["v"],
                  "step": opt_state["step"]}
        _, mstate, gnorm = adamw_update(master, gsum, mstate, opt)
        with torch.no_grad():           # ONE all-gather of the bf16 params
            for c, m in zip(tree_leaves(params), tree_leaves(master),
                            strict=True):
                w = _local(m).to(torch.bfloat16)
                _local(c).copy_(w if mesh is None else _from_fsdp(w, m))
        opt_state.update(mstate)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    pdt = torch.bfloat16 if zero1 else torch.float32
    return Cell(name=f"{cfg.name}:{shape.name}", fn=step,
                args=(abstract(struct, pdt), abstract(ostruct), ins),
                in_shardings=(pspec, opt_spec, None),
                out_shardings=(pspec, opt_spec, None),
                donate_argnums=(0, 1), cfg=cfg)


def prefill_cell(arch: str | ModelConfig, shape: str | Shape, mesh, *,
                 fsdp: bool = True,
                 rule_overrides: dict | None = None,
                 score_shard: str | None = None,
                 attn_impl: str | None = None,
                 rwkv_impl: str = "scan") -> Cell:
    """``fn(params, batch) -> (logits, caches)``: bf16 params and scores;
    encoders have no decode step, so their prefill is feature extraction
    (no caches)."""
    shape = _shape(shape)
    cfg = _config(arch)
    if mesh is not None:
        cfg = mesh_config(cfg, mesh, shape.global_batch,
                          score_shard=score_shard)
    cfg = cfg.replace(attn_dtype="bf16", rwkv_impl=rwkv_impl)
    if attn_impl is not None:
        cfg = cfg.replace(attn_impl=attn_impl)
    struct = model_struct(cfg)
    pspec = None if mesh is None else param_pspecs(
        struct, cfg, mesh, fsdp=fsdp, overrides=rule_overrides)
    memo: dict = {}

    def step(params, batch):
        model = _model_of(params, cfg, memo, False)
        return prefill(model, cfg, _rows(batch, cfg, mesh))

    return Cell(name=f"{cfg.name}:{shape.name}", fn=step,
                args=(abstract(struct, torch.bfloat16),
                      input_specs(cfg, shape)),
                in_shardings=(pspec, None), out_shardings=None, cfg=cfg)


def decode_cell(arch: str | ModelConfig, shape: str | Shape, mesh, *,
                fsdp: bool = True,
                rule_overrides: dict | None = None,
                cache_overrides: dict | None = None) -> Cell:
    """``fn(params, caches, tokens, pos) -> (logits, caches)``: one token
    of every sequence at position ``pos`` (an int, or a 0-dim integer
    tensor on the host: the ring buffer's write index is the host's),
    the caches updated in place.  On a mesh the caches are
    ``cache_struct(tp_layout=True)``'s (the RWKV-6 wkv state value-major,
    so that a head split over 'model' has no copy on two ranks), laid
    out by ``cache_pspecs``."""
    shape = _shape(shape)
    B = shape.global_batch
    cfg = _config(arch)
    if mesh is not None:
        cfg = cfg.replace(batch_axes=_mesh_batch_axes(mesh, B))
    struct = model_struct(cfg)
    cstruct = cache_struct(cfg, B, shape.seq_len, tp_layout=mesh is not None)
    pspec = cspec = None
    if mesh is not None:
        pspec = param_pspecs(struct, cfg, mesh, fsdp=fsdp,
                             overrides=rule_overrides)
        cspec = cache_pspecs(cstruct, cfg, mesh, B, overrides=cache_overrides)
    memo: dict = {}

    def step(params, caches, tokens, pos):
        model = _model_of(params, cfg, memo, False)
        rows = _rows({"tokens": tokens}, cfg, mesh)["tokens"]
        with torch.inference_mode():
            return decode_step(model, cfg, caches, rows, int(pos))

    return Cell(name=f"{cfg.name}:{shape.name}", fn=step,
                args=(abstract(struct, torch.bfloat16),
                      [abstract(cs, torch.bfloat16) for cs in cstruct],
                      input_specs(cfg, shape)["tokens"],
                      torch.zeros((), dtype=torch.int32)),
                in_shardings=(pspec, cspec, None, None),
                out_shardings=(None, cspec), donate_argnums=(1,), cfg=cfg)


def build_cell(arch: str | ModelConfig, shape: str | Shape, mesh,
               **kw) -> Cell:
    kind = _shape(shape).kind
    if kind == "train":
        return train_cell(arch, shape, mesh, **kw)
    if kind == "prefill":
        return prefill_cell(arch, shape, mesh, **kw)
    return decode_cell(arch, shape, mesh, **kw)


# ---------------------------------------------------------------------------
# lowering: one run on the meta device
# ---------------------------------------------------------------------------

def rank_args(cell: Cell, mesh) -> tuple:
    """The cell's arguments as this rank holds them: each state tree's
    leaves DTensors of this rank's shards (meta tensors as the cell's
    ``args`` are; a scalar, the optimizer's step, a plain tensor, as
    ``adamw_init`` makes it), the others whole."""
    from repro_torch.sharding import distribute

    out = []
    for a, spec in zip(cell.args, cell.in_shardings):
        if spec is None or mesh is None:
            out.append(a)
            continue
        leaves = [distribute(t, mesh, s) if t.dim() else t for t, s in
                  zip(tree_leaves(a), tree_leaves(spec), strict=True)]
        out.append(tree_unflatten(a, leaves))
    return tuple(out)


@dataclass
class Lowered:
    """A step run once, counted: what it cost (``launch/hlo_static.py``'s
    :class:`~repro_torch.launch.hlo_static.StaticCost`) and this rank's
    memory, in bytes: its arguments (their local shards), its outputs,
    the peak of live tensors during the step (arguments included;
    ``MemTracker``) and that peak less the arguments (the JAX package's
    ``temp``).  ``cell`` is the cell it ran, if any."""
    cost: Any
    memory: dict
    seconds: float
    cell: Cell | None = None


def lower_fn(fn, args: tuple, track=()) -> Lowered:
    """Run ``fn(*args)`` once, counting its FLOPs, op bytes and
    collectives and tracking its live bytes (on the meta device, nothing
    is computed: the counts are the shapes').  The tensors among
    ``args`` and in ``track`` (held elsewhere, as a model's) are the
    arguments."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch.hlo_static import CostMode

    t0 = time.time()
    given = [t for t in tree_leaves(list(args)) + list(track)
             if torch.is_tensor(t)]
    held = [_local(t) for t in given]
    arg_bytes = sum(t.numel() * t.element_size() for t in held)
    mt = MemTracker()
    mt.track_external(*held)
    counter = CostMode()
    with mt, counter:
        out = fn(*args)
    peak = max((v.get("Total", 0) for v in
                mt.get_tracker_snapshot("peak").values()), default=0)
    peak = max(peak, arg_bytes)
    ids = {id(t) for t in given}          # an output that is an argument
    out_bytes = sum(_local(t).numel() * _local(t).element_size()
                    for t in tree_leaves(list(out) if isinstance(
                        out, tuple) else [out])
                    if torch.is_tensor(t) and id(t) not in ids)
    return Lowered(cost=counter.cost, memory={
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "peak_bytes": peak, "temp_bytes": peak - arg_bytes},
        seconds=time.time() - t0)


def lower_cell(cell: Cell, mesh) -> Lowered:
    """The counterpart of the JAX package's ``lower``: ``cell.fn`` run
    once on meta tensors of this rank's shards (:func:`rank_args`, in a
    world whose ranks may be fake: ``launch/dryrun.py``), counted by
    :func:`lower_fn`."""
    low = lower_fn(cell.fn, rank_args(cell, mesh))
    low.cell = cell
    return low
