"""Mixture-of-Experts with grouped sort-based dispatch (port of
``repro.models.moe``).

Tokens diverge into expert paths and reconverge at the combine:

* each expert's [capacity, d] buffer is a path executed as one dense block;
* the scatter indices (``dest``) record which tokens rejoin where;
* capacity-dropped tokens are removed from the combine and rejoin the
  residual stream only.

Dispatch is grouped (group = sequence; the whole batch is one group in
decode): routing, sort, scatter and combine are local to a group.  The JAX
package vmaps the group functions and pins the group axis to the data
axes; on one card the groups run in a loop and the expert products take
all groups at once.  Supports Mixtral-style top-k over E experts and
DeepSeek-style shared + fine-grained routed experts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import ModelConfig, P
from .layers import mlp, mlp_struct


def moe_struct(cfg: ModelConfig):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    s = {
        "router": P((d, E), ("embed", "experts"), scale=0.02),
        "w_gate": P((E, d, ff), ("experts", "embed", "mlp")),
        "w_up": P((E, d, ff), ("experts", "embed", "mlp")),
        "w_down": P((E, ff, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_struct(d, (cfg.moe_d_ff or cfg.d_ff)
                                 * cfg.n_shared_experts)
    return s


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    E, k = cfg.n_experts, cfg.experts_per_token
    cap = int(tokens_per_group * k / E * cfg.capacity_factor)
    return max(4, -(-cap // 4) * 4)


def _top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, and among equal
    values the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(xt, gates, eidx, C: int, E: int, k: int):
    """One group: xt [T, d]; gates/eidx [T, k].  Returns the expert-path
    buffer [E*C, d], each slot's destination row ``dest`` [T*k] (``E*C``
    for a dropped slot), its source token [T*k] and its gate [T*k] (0 for
    a dropped slot), in sorted-slot order."""
    T, d = xt.shape
    flat_e = eidx.reshape(-1)                            # [T*k]
    order = torch.argsort(flat_e, stable=True)           # local sort
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=xt.device) - offsets[sorted_e]
    kept = rank < C                                      # drop overflow
    dest = torch.where(kept, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    src_token = order // k
    # one spare row takes the dropped slots' writes, then is cut off
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[src_token]
    slot_gate = (gates.reshape(-1)[order] * kept).to(xt.dtype)
    return buf[:E * C], dest, src_token, slot_gate


def _combine_group(ex_out, dest, src_token, slot_gate, T: int):
    """ex_out [E*C, d] -> [T, d].  A dropped slot's gate is 0, so its
    clamped gather contributes nothing.

    Each token's k slots are summed in their sorted order (ascending
    expert), the order in which the JAX package's scatter-add adds them,
    and with no atomics: an ``index_add_`` on the card adds a token's
    contributions in whatever order its atomics land, so a prefill's
    logits would differ from run to run."""
    rows = ex_out[dest.clamp(max=ex_out.shape[0] - 1)]
    contrib = rows * slot_gate[:, None]
    per_token = contrib[torch.argsort(src_token, stable=True)] \
        .reshape(T, -1, contrib.shape[-1])                # [T, k, d]
    out = per_token[:, 0]
    for j in range(1, per_token.shape[1]):
        out = out + per_token[:, j]
    return out


def route(params, xg, cfg: ModelConfig):
    """Router softmax and top-k of groups xg [G, T, d]: returns (gates_all
    [G, T, E] f32, gates [G, T, k] renormalized, eidx [G, T, k])."""
    logits = (xg @ params.router.to(xg.dtype)).float()
    gates_all = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(gates_all, cfg.experts_per_token)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates_all, gates, eidx


def dispatch(params, x, cfg: ModelConfig):
    """Routing and dispatch of x [B, S, d]: the groups' expert-path inputs
    [G, E, C, d], each group's (dest, src_token, slot_gate), the router's
    (gates_all, eidx) and C."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    xg = x if S > 1 else x.reshape(1, B, d)              # [G, T, d]
    C = _capacity(xg.shape[1], cfg)
    gates_all, gates, eidx = route(params, xg, cfg)
    groups = [_dispatch_group(xt, g, e, C, E, k)
              for xt, g, e in zip(xg, gates, eidx)]
    ex_in = torch.stack([g[0] for g in groups]).reshape(len(groups), E, C, d)
    return ex_in, [g[1:] for g in groups], gates_all, eidx, C


def moe(params, x, cfg: ModelConfig):
    """x: [B, S, d] -> ([B, S, d], aux).  Groups are sequences (S > 1) or
    the whole batch as one group (decode)."""
    B, S, d = x.shape
    E = cfg.n_experts
    ex_in, slots, gates_all, eidx, C = dispatch(params, x, cfg)
    G, T = ex_in.shape[0], (S if S > 1 else B)

    w_gate = params.w_gate.to(x.dtype)
    w_up = params.w_up.to(x.dtype)
    w_down = params.w_down.to(x.dtype)
    h = F.silu(torch.einsum("gecd,edf->gecf", ex_in, w_gate)) \
        * torch.einsum("gecd,edf->gecf", ex_in, w_up)
    ex_out = torch.einsum("gecf,efd->gecd", h, w_down).reshape(G, E * C, d)

    out = torch.stack([_combine_group(eo, *slot, T)
                       for eo, slot in zip(ex_out, slots)])
    out = out.reshape(B, S, d)

    if cfg.n_shared_experts:
        out = out + mlp(params.shared, x.reshape(B * S, d)).reshape(B, S, d)

    aux = load_balance_loss(gates_all.reshape(-1, E),
                            eidx.reshape(-1, cfg.experts_per_token), E)
    return out, aux


def load_balance_loss(gates_all, eidx, E: int):
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    onehot = F.one_hot(eidx[:, 0], E).float()
    f = onehot.mean(0)
    p = gates_all.mean(0)
    return E * torch.sum(f * p)
