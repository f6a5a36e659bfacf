"""The prefill step (port of ``repro.launch.steps.prefill_cell``'s step,
without the mesh: one card holds the whole model)."""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.models import ModelConfig, Transformer, forward


def prefill_config(arch: str, *, smoke: bool = False,
                   attn_impl: str | None = None) -> ModelConfig:
    """The config ``prefill_cell`` runs: bf16 score materialization, and
    ``attn_impl`` when given.  The caller casts the params to bf16."""
    cfg = get_config(arch, smoke=smoke).replace(attn_dtype="bf16")
    if attn_impl is not None:
        cfg = cfg.replace(attn_impl=attn_impl)
    return cfg


def prefill(params: Transformer, cfg: ModelConfig, batch: dict):
    """Returns (logits [B, S, V], per-segment stacked caches: k/v for
    attention layers, conv/h for RG-LRU, tm_shift/wkv/cm_shift for RWKV)."""
    with torch.inference_mode():
        logits, _, caches = forward(params, cfg, batch,
                                    return_cache=cfg.is_decoder)
    return logits, caches
