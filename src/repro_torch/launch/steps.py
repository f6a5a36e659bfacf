"""The prefill step and the mesh-to-config glue (port of
``repro.launch.steps``: ``_auto_score_shard``, ``_auto_kv_shard``,
``_mesh_batch_axes`` and ``prefill_cell``'s config and step).  The cells,
their lowering and the dry run are not ported (ROADMAP.md, item 12)."""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.models import ModelConfig, Transformer, forward
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
    attention layers, conv/h for RG-LRU, tm_shift/wkv/cm_shift for RWKV).
    On a mesh ``batch`` is this rank's rows and both come back as
    DTensors (see :func:`~repro_torch.models.transformer.forward`)."""
    with torch.inference_mode():
        logits, _, caches = forward(params, cfg, batch,
                                    return_cache=cfg.is_decoder)
    return logits, caches
