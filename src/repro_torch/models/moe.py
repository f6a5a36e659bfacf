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
axes (``shard_g``); here one pass takes every group at once (one sort of
the key group*E + expert, one gather into the expert-path buffers, k
gathers in the combine), so the operations a layer launches do not grow
with the number of groups.  On a mesh the groups are this rank's batch
rows, so ``shard_g``'s layout holds by construction: each rank routes its
rows' every position, runs its experts (expert-parallel on 'model' when
they divide, else its ff columns of every expert), and the partial sums
meet in ``shard_act``.  Supports Mixtral-style top-k over E experts and
DeepSeek-style shared + fine-grained routed experts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.sharding import comm
from repro_torch.sharding.layout import seq_gather, tp_sharded

from .base import ModelConfig, P
from .layers import _w, mlp_partial, mlp_struct, shard_act


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


class Slots(NamedTuple):
    """The routed slots of every group: ``dest`` (the slot's row of its
    group's [E*C] expert-path buffer, ``E*C`` when dropped), ``src_token``
    (its token in the group) and ``slot_gate`` (its gate, 0 when dropped),
    each [G, T*k] in sorted-slot order (by expert, stable), as the JAX
    package's ``_dispatch_group`` gives them a group; and ``by_token``
    [G, T, k], each token's k positions in that order, ascending: the
    order of ascending expert in which the combine adds its slots."""
    dest: torch.Tensor
    src_token: torch.Tensor
    slot_gate: torch.Tensor
    by_token: torch.Tensor


def _dispatch(xg, gates, eidx, C: int, E: int):
    """Every group at once: xg [G, T, d]; gates/eidx [G, T, k].  Returns
    the expert-path inputs [G, E, C, d] and the :class:`Slots`.

    One stable sort of the key ``g*E + e`` over all G*T*k slots orders
    each group's slots as a stable sort of the group's own experts does;
    each group holds T*k of them, so the global position less the global
    offset of the slot's key is its rank in its group's expert."""
    G, T, d = xg.shape
    k = eidx.shape[-1]
    n = T * k
    dev = xg.device
    key = (eidx + torch.arange(0, G * E, E, device=dev)[:, None, None]) \
        .reshape(-1)                                     # [G*T*k]
    sorted_key, order = torch.sort(key, stable=True)
    counts = torch.zeros(G * E, dtype=key.dtype, device=dev) \
        .scatter_add_(0, key, torch.ones_like(key))     # bincount
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(G * n, device=dev)
    rank = pos - offsets[sorted_key]
    kept = rank < C                                      # drop overflow
    dest = torch.where(kept, sorted_key % E * C + rank, E * C)
    token = order // k                                   # row of [G*T]
    slot_gate = (gates.reshape(-1)[order] * kept).to(xg.dtype)
    # each buffer row's token; empty rows read a zero row, and the dropped
    # slots write a spare entry that is cut off
    row_src = torch.full((G * E * C + 1,), G * T, dtype=order.dtype,
                         device=dev).scatter_(
        0, torch.where(kept, sorted_key * C + rank, G * E * C), token)
    ex_in = F.pad(xg.reshape(G * T, d), (0, 0, 0, 1))[row_src[:G * E * C]]
    # each token's positions, ascending: the inverse of the sort by a
    # scatter, a slot's place among its token's k, and a scatter to it
    inv = torch.empty_like(pos).scatter_(0, order, pos % n).view(G * T, k)
    place = (inv[:, :, None] > inv[:, None, :]).sum(-1)
    by_token = torch.empty_like(inv).scatter_(1, place, inv)
    slots = Slots(dest.view(G, n), (token % T).view(G, n),
                  slot_gate.view(G, n), by_token.view(G, T, k))
    return ex_in.view(G, E, C, d), slots


def _combine(ex_out, slots: Slots):
    """ex_out [G, E*C, d] -> [G, T, d].  A dropped slot's gate is 0, so
    its clamped gather (its group's last row) contributes nothing.

    Each token's k slots are summed in their sorted order (ascending
    expert), the order in which the JAX package's scatter-add adds them:
    k gathers of one row a token, each times its gate, added one after
    another, with no atomics (an ``index_add_`` on the card adds a token's
    contributions in whatever order its atomics land, so a prefill's
    logits would differ from run to run)."""
    G, EC, d = ex_out.shape
    T, k = slots.by_token.shape[1:]
    at = slots.by_token.view(G, T * k)
    # [k, G*T]: the j-th slot of every token, contiguous, so that each
    # gather takes whole rows at once
    rows = (slots.dest.gather(1, at).clamp_(max=EC - 1)
            + torch.arange(0, G * EC, EC, device=ex_out.device)[:, None]) \
        .view(G * T, k).t().contiguous()
    gate = slots.slot_gate.gather(1, at).view(G * T, k).t().contiguous()
    flat = ex_out.reshape(G * EC, d)
    out = flat[rows[0]] * gate[0, :, None]
    for j in range(1, k):
        out = out + flat[rows[j]] * gate[j, :, None]
    return out.view(G, T, d)


def route(params, xg, cfg: ModelConfig, lay=None):
    """Router softmax and top-k of groups xg [G, T, d]: returns (gates_all
    [G, T, E] f32, gates [G, T, k] renormalized, eidx [G, T, k])."""
    logits = (xg @ _w(params, "router", lay, model=True).to(xg.dtype)).float()
    gates_all = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(gates_all, cfg.experts_per_token)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates_all, gates, eidx


def dispatch(params, x, cfg: ModelConfig, lay=None):
    """Routing and dispatch of x [B, S, d]: the groups' expert-path inputs
    [G, E, C, d], their :class:`Slots`, the router's (gates_all, eidx) and
    C."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    xg = x if S > 1 else x.reshape(1, B, d)              # [G, T, d]
    G, T = xg.shape[:2]
    C = _capacity(T, cfg)
    with tracing.span("moe.route"):
        gates_all, gates, eidx = route(params, xg, cfg, lay)
    with tracing.span("moe.dispatch"):
        ex_in, slots = _dispatch(xg, gates, eidx, C, E)
        tracing.count("moe.slots", G * T * k)
        if tracing.counting():
            tracing.count("moe.dropped", (slots.dest == E * C).sum())
    return ex_in, slots, gates_all, eidx, C


def moe(params, x, cfg: ModelConfig, lay=None):
    """x: [B, S, d] -> ([B, S, d], aux).  Groups are sequences (S > 1) or
    the whole batch as one group (decode).  On a mesh x is this rank's
    residual rows and the output comes back in that layout."""
    if lay is not None:
        x = seq_gather(x, lay)
    B, S, d = x.shape
    E = cfg.n_experts
    ex_in, slots, gates_all, eidx, C = dispatch(params, x, cfg, lay)
    G = ex_in.shape[0]

    ep = lay is not None and tp_sharded(params.w_gate, 0)
    with tracing.span("moe.experts"):
        if ep:                # this rank's experts only
            n = E // lay.tp
            lo = lay.tp_rank * n
            ex_in = ex_in[:, lo:lo + n]
        w_gate = _w(params, "w_gate", lay).to(x.dtype)
        w_up = _w(params, "w_up", lay).to(x.dtype)
        w_down = _w(params, "w_down", lay).to(x.dtype)
        h = F.silu(torch.einsum("gecd,edf->gecf", ex_in, w_gate)) \
            * torch.einsum("gecd,edf->gecf", ex_in, w_up)
        ex_out = torch.einsum("gecf,efd->gecd", h, w_down)
        if ep:                # the other ranks' experts add nothing here
            ex_out = torch.cat([
                ex_out.new_zeros((G, lo, C, d)), ex_out,
                ex_out.new_zeros((G, E - lo - n, C, d))], dim=1)
        ex_out = ex_out.reshape(G, E * C, d)

    with tracing.span("moe.combine"):
        out = _combine(ex_out, slots).reshape(B, S, d)

    if cfg.n_shared_experts:
        with tracing.span("moe.shared"):
            out = out + mlp_partial(params.shared, x.reshape(B * S, d),
                                    lay).reshape(B, S, d)
    if lay is not None:
        out = shard_act(out, lay)

    aux = load_balance_loss(gates_all.reshape(-1, E),
                            eidx.reshape(-1, cfg.experts_per_token), E, lay)
    return out, aux


def load_balance_loss(gates_all, eidx, E: int, lay=None):
    """Switch-style auxiliary loss: E * sum_e f_e * p_e.  On a mesh with
    the batch split, f and p are the means over the global batch."""
    onehot = F.one_hot(eidx[:, 0], E).float()
    f = onehot.mean(0)
    p = gates_all.mean(0)
    if lay is not None and lay.batch:
        f = comm.psum(f, lay.data) / lay.dp
        p = comm.psum(p, lay.data) / lay.dp
    return E * torch.sum(f * p)
