"""Elastic scaling (port of ``repro.runtime.elastic``): rebuild the mesh
after node loss / scale-up and reshard state onto it.

The recovery path after a failure is:

1. the training driver catches the failure (timeout / unreachable rank),
2. the survivors start a new process group among themselves
   (``torch.distributed.init_process_group`` over the surviving ranks; the
   JAX package ``device_put``s onto the surviving devices of one runtime,
   and a torch world cannot lose a member and go on),
3. ``survivors_mesh`` builds the largest well-formed mesh over their ranks
   (keeping the model axis intact — TP groups must stay whole, so recovery
   drops whole data-parallel rows),
4. params and optimizer state are restored from the last committed
   checkpoint with ``restore_checkpoint(..., shardings=new_specs,
   mesh=new_mesh)`` (the checkpoint layout is mesh-agnostic), or — if
   state is still live — ``reshard_tree`` places it on the new mesh,
5. the data pipeline re-slices the SAME global batch order by rank count,
   so sample order is preserved across the re-shape.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models.base import tree_leaves, tree_unflatten
from repro_torch.sharding import comm
from repro_torch.sharding.specs import distribute


def survivors_mesh(ranks, axis_names: tuple[str, ...],
                   model_axis_size: int, device=None):
    """Largest (data, model) ``DeviceMesh`` over the surviving ``ranks``
    (ranks of the running world); whole TP groups only."""
    from torch.distributed.device_mesh import DeviceMesh

    n = len(ranks)
    rows = n // model_axis_size
    if rows < 1:
        raise ValueError("not enough devices for one model-parallel group")
    grid = torch.tensor(list(ranks[: rows * model_axis_size])).reshape(
        rows, model_axis_size)
    return DeviceMesh(resolve(device).type, grid,
                      mesh_dim_names=tuple(axis_names))


def full_tensor(t) -> torch.Tensor:
    """The whole of a DTensor on every rank, gathered with the port's c10d
    collectives (DTensor's own ``full_tensor`` goes through the functional
    all-gather, which kills the process on CUDA tensors over gloo); a plain
    tensor as it is."""
    if not hasattr(t, "device_mesh"):
        return t
    mesh = t.device_mesh
    x = t.to_local()
    # gather the innermost mesh dimension first: a tensor dim split over
    # several mesh dims is split outermost first
    for i in reversed(range(mesh.ndim)):
        p = t.placements[i]
        if p.is_shard():
            x = comm.all_gather(x, p.dim, mesh.get_group(i))
    return x


def reshard_tree(tree, mesh, spec_tree):
    """Place a live tree on a (new) mesh with the given specs: each leaf
    whole (gathered if it is a DTensor), then this rank's shard."""
    leaves = [distribute(full_tensor(x), mesh, s)
              for x, s in zip(tree_leaves(tree), tree_leaves(spec_tree),
                              strict=True)]
    return tree_unflatten(tree, leaves)
