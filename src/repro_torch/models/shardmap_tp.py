"""Explicit-collective TP blocks (port of ``repro.models.shardmap_tp``).

The JAX package writes these two combines with ``shard_map`` to bypass
GSPMD, which lowered the row-parallel TP combine as ``all-reduce +
dynamic-slice`` (2x wire bytes) instead of a reduce-scatter (1x):

    all_gather(x, seq axis) -> local matmuls -> psum_scatter(out, seq axis)

which is Megatron sequence parallelism with the reduce-scatter
guaranteed.  The port has no GSPMD to bypass: its only mesh path is
already this schedule, written with the autograd collectives of
:mod:`repro_torch.sharding.comm` (``layers.mlp``, ``layers.shard_act``).
So these two keep the JAX package's API and run that same path, and the
two values of ``cfg.tp_impl`` ("gspmd", "shard_map") are one path in the
port.
"""
from __future__ import annotations

import torch

from .base import ModelConfig
from .layers import mlp, shard_act


def mlp_tp(params, x, cfg: ModelConfig, lay):
    """Gated-SiLU MLP with explicit AG/RS.  x: this rank's rows [B/data,
    S/model, d] (``act_shard="seq"``); returns its rows of the output."""
    assert lay.seq, "mlp_tp needs the sequence split over 'model'"
    return mlp(params, x, lay)


def o_proj_tp(out_heads, wo, cfg: ModelConfig, lay):
    """Attention out-projection with explicit RS.  out_heads: [B/data, S,
    H/model, hd], this rank's heads at every position; wo: its rows
    [H/model, hd, d].  Returns its rows [B/data, S/model, d]."""
    assert lay.seq, "o_proj_tp needs the sequence split over 'model'"
    return shard_act(
        torch.einsum("bshk,hkd->bsd", out_heads, wo.to(out_heads.dtype)), lay)
