"""Model assembly (port of ``repro.models.transformer``): layer plans ->
param structure, the model as ``nn.Module``s, forward (prefill) and decode.

The param tree keeps the JAX package's layout: ``segments[i][str(j)]``
holds the stacked ``[repeat, ...]`` params of pattern position ``j``.
:class:`Transformer` wraps it as modules, one :class:`Params` block per
layer (a view of its slice, not a copy), and the Python loop over layers
takes the place of ``lax.scan``.  Dense GLOBAL / LOCAL / SWA, RECURRENT
(RG-LRU) and RWKV-6 layers are ported, each with a dense or (in an ``moe``
segment) a mixture-of-experts FFN.
"""
from __future__ import annotations

import torch
from torch import nn

from .base import GLOBAL, RECURRENT, RWKV, ModelConfig, P, Params, tree_map
from .layers import (attention, attention_cache_struct, attention_struct,
                     embed, embed_struct, head_struct, lm_logits, mlp,
                     mlp_struct, rmsnorm, rmsnorm_struct)
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


def cache_struct(cfg: ModelConfig, batch: int, max_len: int):
    """Decode-state structure mirroring the segment layout."""
    out = []
    for seg in _segments(cfg):
        per_pos = {}
        for j, kind in enumerate(seg["pattern"]):
            if kind == RWKV:
                per_pos[str(j)] = rwkv6_state_struct(cfg, batch)
            elif kind == RECURRENT:
                per_pos[str(j)] = rglru_state_struct(cfg, batch)
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
    ``final_norm`` and ``head``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.embed = Params(params["embed"])
        self.segments = nn.ModuleList(
            nn.ModuleList(Params(tree_map(lambda t, r=r: t[r], seg_params))
                          for r in range(seg["repeat"]))
            for seg, seg_params in zip(_segments(cfg), params["segments"]))
        self.final_norm = Params(params["final_norm"])
        self.head = Params(params["head"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_layer(lp, x, *, cfg: ModelConfig, kind: str, is_moe: bool,
                 positions, cache=None, cache_pos=None):
    """One residual block.  Returns (x, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(lp.ln1, x, cfg.norm_eps)
    if kind == RWKV:
        out, tm_state = rwkv6_time_mix(
            lp.tm, h, cfg=cfg,
            state=None if cache is None else {"shift": cache["tm_shift"],
                                              "wkv": cache["wkv"]})
        x = x + out
        h2 = rmsnorm(lp.ln2, x, cfg.norm_eps)
        out2, cm_state = rwkv6_channel_mix(
            lp.cm, h2,
            state=None if cache is None else {"shift": cache["cm_shift"]})
        return x + out2, {"tm_shift": tm_state["shift"],
                          "wkv": tm_state["wkv"],
                          "cm_shift": cm_state["shift"]}, aux
    if kind == RECURRENT:
        out, new_cache = rglru(lp.rglru, h, cfg=cfg, state=cache)
    else:
        out, new_cache = attention(lp.attn, h, cfg=cfg, kind=kind,
                                   positions=positions, kv_cache=cache,
                                   cache_pos=cache_pos)
    x = x + out
    h2 = rmsnorm(lp.ln2, x, cfg.norm_eps)
    if is_moe:
        out2, aux = moe(lp.ffn, h2, cfg)
    else:
        out2 = mlp(lp.ffn, h2)
    return x + out2, new_cache, aux


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            return_cache: bool = False):
    """Full-sequence forward (prefill).

    Returns (logits, aux_loss, caches); caches is None unless requested, and
    is then stacked per segment like the JAX package's scan output.
    """
    x = embed(params.embed, batch["tokens"], cfg)
    S = x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    caches = [] if return_cache else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    for seg, layers in zip(_segments(cfg), params.segments):
        per_pos = {str(j): [] for j in range(len(seg["pattern"]))}
        for lp in layers:
            for j, kind in enumerate(seg["pattern"]):
                x, c, aux = _apply_layer(getattr(lp, str(j)), x, cfg=cfg,
                                         kind=kind, is_moe=seg["moe"],
                                         positions=positions)
                aux_total = aux_total + aux
                if return_cache:
                    per_pos[str(j)].append(c)
        if return_cache:
            caches.append({j: {name: torch.stack([c[name] for c in cs])
                               for name in cs[0]}
                           for j, cs in per_pos.items()})

    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = lm_logits(params.head, params.embed, x, cfg)
    return logits, aux_total, caches


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
    """
    x = embed(params.embed, tokens, cfg)
    positions = torch.full((1,), cache_pos, dtype=torch.int32,
                           device=x.device)
    for seg, layers, seg_cache in zip(_segments(cfg), params.segments,
                                      caches):
        for r, lp in enumerate(layers):
            for j, kind in enumerate(seg["pattern"]):
                layer_cache = {name: t[r]
                               for name, t in seg_cache[str(j)].items()}
                x, new_cache, _ = _apply_layer(
                    getattr(lp, str(j)), x, cfg=cfg, kind=kind,
                    is_moe=seg["moe"], positions=positions, cache=layer_cache,
                    cache_pos=cache_pos)
                for name, t in new_cache.items():
                    if t is not layer_cache[name]:
                        layer_cache[name].copy_(t)

    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = lm_logits(params.head, params.embed, x, cfg)
    return logits, caches
