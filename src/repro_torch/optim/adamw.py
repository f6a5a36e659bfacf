"""AdamW (port of ``repro.optim.adamw``), written as the JAX package writes
it rather than taken from ``torch.optim.AdamW``: a global-norm clip
``min(1, clip / (gnorm + 1e-9))``, bias correction as
``(m / c1) / (sqrt(v / c2) + eps)``, decay as ``p - lr * (upd + wd * p)``,
``m`` and ``v`` kept in each parameter's dtype, and every leaf updated,
one whose gradient is ``None`` as if it were zeros (``torch.optim`` skips
it, and rounds its correction and decay in another order).

The trees are nested dicts and lists of tensors in the JAX package's
layout, or of DTensors (a sharded model): the moments then take their
parameters' placements (ZeRO-3, as the JAX package's ``opt_spec``), the
update runs on each rank's local shards, and the clipping norm is the
global norm over every shard, each element counted once.  The update runs in place: the parameter, ``m`` and ``v`` tensors
are overwritten, so a model whose modules share the parameters' storage
sees the new values; the returned trees are the given ones.  Nothing
reads a value back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.base import P, tree_leaves, tree_map
from repro_torch.sharding import comm


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params):
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=_local(tree_leaves(params)[0]).device),
    }


def adamw_init_struct(struct):
    """Structure tree of the optimizer state (for specs and the dry run):
    the moments shaped, laid out and typed as their parameters, and the
    int32 step."""
    def zeros(p: P) -> P:
        return P(p.shape, p.axes, init="zeros", dtype=p.dtype)
    return {"m": tree_map(zeros, struct), "v": tree_map(zeros, struct),
            "step": P((), (), init="zeros", dtype="int32")}


def _local(t):
    """A DTensor's local shard (sharing its storage), a tensor itself."""
    return t.to_local() if hasattr(t, "device_mesh") else t


def _owned(t) -> bool:
    """Whether this rank counts a DTensor shard in a sum over the mesh:
    the replica at coordinate 0 of every mesh dimension that replicates
    it."""
    coord = t.device_mesh.get_coordinate()
    return all(coord[i] == 0 for i, p in enumerate(t.placements)
               if not p.is_shard())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32; ``None`` leaves
    count as zeros.  For DTensor leaves each rank sums the shards it owns
    and the sums are all-reduced over the mesh."""
    leaves = [g for g in tree_leaves(tree) if g is not None]
    mesh = getattr(leaves[0], "device_mesh", None)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    sq = sum(torch.sum(torch.square(g.to_local().float()))
             for g in leaves if _owned(g))
    if not torch.is_tensor(sq):
        sq = torch.zeros((), device=leaves[0].to_local().device)
    for i in range(mesh.ndim):
        sq = comm.all_reduce(sq, mesh.get_group(i))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr=None):
    """Returns (new_params, new_state, grad_norm); see the module's
    docstring for what is updated in place."""
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    c1 = 1.0 - cfg.b1 ** step.float()
    c2 = 1.0 - cfg.b2 ** step.float()

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"]),
                          strict=True):
        p, m, v = _local(p), _local(m), _local(v)
        g = None if g is None else _local(g)
        g = (torch.zeros_like(p, dtype=torch.float32) if g is None
             else g.float() * scale)
        pf = p.float()
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        u = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        p.copy_(pf - lr * (u + cfg.weight_decay * pf))
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return params, state, gnorm
