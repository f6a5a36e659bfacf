"""Layouts of the sharded model: where a rank's activations sit on a
``(data, model)`` or ``(pod, data, model)`` ``DeviceMesh``, and how a
rank fetches the weights it computes with.

The port computes on local tensors with explicit collectives (the
:mod:`~repro_torch.sharding.comm` layer), where the JAX package leaves
the collectives to GSPMD and guides it with sharding constraints.  The
residual stream of a rank is ``[B / data, S / model, d]`` (``act_shard=
"seq"``: Megatron sequence parallelism) or ``[B / data, S, d]``
(replicated over ``model``); a TP block gathers the sequence before its
column-parallel products and reduce-scatters its row-parallel partial sum
back (:func:`seq_gather`, :func:`seq_combine`).

Gradients follow one rule: a rank's loss is its share, so that the shares
summed over the ranks are the global loss; every collective's backward
is its adjoint; and an activation that several ranks hold alike is a
copy per rank, whose gradient is that rank's part.  Parts are summed
only by the adjoints and at the weights, which are one variable however
many ranks use them: a weight gathered over an axis gets its gradient
reduce-scattered over it, a weight replicated over an axis gets it
all-reduced, and a weight that a rank uses only as its own shard (the
TP-sharded dimension of a column- or row-parallel product) keeps its
local gradient.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.sharding import comm


@dataclass(frozen=True)
class Layout:
    """This forward's layout on ``mesh`` (axes ``("data", "model")``, or
    ``("pod", "data", "model")``): ``batch`` — the batch is split over the
    data axes, pod x data (``cfg.batch_axes``); ``seq`` — the residual
    stream's sequence is split over ``model``; ``cache_seq`` — a decode
    cache's positions are split over ``data`` (batch 1: ``cache_pspecs``'s
    sequence-parallel cache); ``defer_data_grads`` — a weight replicated
    over a data axis keeps this rank's part of its gradient, for the
    ZeRO-1 step to sum once (``launch/steps.py::train_cell``)."""
    mesh: object
    batch: bool
    seq: bool
    cache_seq: bool = False
    defer_data_grads: bool = False

    @property
    def data_dims(self) -> tuple[str, ...]:
        """The mesh dimensions that split the batch: ``pod`` and ``data``."""
        return tuple(a for a in ("pod", "data")
                     if a in self.mesh.mesh_dim_names)

    @property
    def data(self):
        """The batch's group: ``data``, or pod x data flattened."""
        dims = self.data_dims
        if len(dims) == 1:
            return self.mesh.get_group(dims[0])
        return self.mesh[dims]._flatten("_".join(dims)).get_group()

    @property
    def model(self):
        return self.mesh.get_group("model")

    @property
    def tp(self) -> int:
        return self.mesh["model"].size()

    @property
    def tp_rank(self) -> int:
        return self.mesh.get_local_rank("model")

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def world(self) -> int:
        return self.mesh.size()


def shard_of(p) -> tuple:
    """The tensor dimension that each mesh dimension shards in the local
    parameter ``p`` (``None``: replicated), as :func:`mark` recorded."""
    return p._mesh_shard


def mark(t: torch.Tensor, shard: tuple) -> torch.Tensor:
    """Record on a local parameter (or a layer's slice of one) which of its
    dimensions each mesh dimension shards."""
    t._mesh_shard = tuple(shard)
    return t


def fetch(p: torch.Tensor, lay: Layout, *, model: bool = False):
    """The weight this rank computes with: gathered over each data axis
    where it is sharded there (FSDP; the rules shard only over ``data``)
    and used as it is over one that replicates it (``pod``; its gradient
    all-reduced there unless ``lay.defer_data_grads``), and gathered
    over ``model`` too when ``model`` (a block that needs the whole
    weight); a dimension sharded over ``model`` and not gathered stays
    this rank's TP shard."""
    names = lay.mesh.mesh_dim_names
    x = p
    for name, dim in zip(names, shard_of(p)):
        if name == "model":
            continue
        group = lay.mesh.get_group(name)
        if dim is not None:
            x = comm.gather(x, dim, group)
        elif not lay.defer_data_grads:
            x = comm.bcast(x, group)
    m_dim = shard_of(p)[names.index("model")]
    if m_dim is None:
        return comm.bcast(x, lay.model)
    return comm.gather(x, m_dim, lay.model) if model else x


def tp_sharded(p, dim: int) -> bool:
    """Whether ``p``'s dimension ``dim`` is split over ``model`` (the last
    mesh dimension)."""
    return shard_of(p)[-1] == dim


def seq_gather(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """A TP block's input at every position: gathered over ``model`` on
    the sequence (``seq``), else this rank's copy as it is."""
    if lay.seq:
        return comm.gather(x, 1, lay.model)
    return x


def seq_combine(x: torch.Tensor, lay: Layout) -> torch.Tensor:
    """A TP block's partial sum over ``model`` [B, S, d] into the residual
    layout: reduce-scattered on the sequence (``seq``) or all-reduced."""
    if lay.seq:
        return comm.scatter(x, 1, lay.model)
    return comm.psum(x, lay.model)


def seq_rows(x: torch.Tensor, lay: Layout, dim: int = 1) -> torch.Tensor:
    """This rank's residual rows of a tensor every ``model`` rank holds
    whole (its gradient meets the other ranks' in the gather upstream)."""
    return comm.chunk(x, dim, lay.model) if lay.seq else x
