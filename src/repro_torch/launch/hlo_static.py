"""Per-rank cost of one run of a cell's step (the port's counterpart of
``repro.launch.hlo_static``).

The JAX package parses the optimized HLO text of a compiled cell: dots
with their loops' trip counts, the bytes at fusion boundaries, and each
collective's bytes.  The port has no HLO: a cell's step is eager PyTorch
and runs op by op.  So :class:`CostMode`, a ``TorchDispatchMode``, watches
one run of the step on a rank's shards (on the meta device, in a world of
fake ranks; ``launch/steps.py::lower_cell``) and counts what that rank
does:

* FLOPs, as ``torch.utils.flop_counter.FlopCounterMode`` counts them
  (matrix products, convolutions, attention);
* bytes into and out of each aten op, views excluded: the traffic of
  eager PyTorch, which fuses nothing (an argument an op overwrites is
  counted once, as its output);
* each c10d collective's kind, count and bytes by the JAX package's rule
  (``hlo_analysis.py:49-54``): the larger of the result and the operands,
  an all-reduce twice (its reduce-scatter and all-gather phases of a
  ring).  A collective over a group of one rank moves nothing and is not
  counted.

A loop in the step is Python, so it runs as many times as it says, and
its ops are counted each time: the trip counts that the HLO parser has to
recover are here by construction.  One loop is too long for that on the
meta device: the RWKV-6 token loop (``kernels/ref.py::rwkv6_scan_ref``),
S steps a layer, each step's ops dispatched on meta tensors (tens of
minutes a training cell).  There every step is the same work on the same
shapes, so the loop runs one step inside :func:`trip_count` (S), which
scales what :class:`CostMode` counts there (FLOPs, op bytes,
collectives) by S, the JAX package's treatment of a ``lax.scan`` body.
Shapes are this rank's, so every number is per rank.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# the c10d dispatcher ops of the port's collectives (``sharding/comm.py``)
# -> the JAX package's collective kinds
_C10D_KIND = {
    "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "allreduce_": "all-reduce",
    "alltoall_base_": "all-to-all",
}


@dataclass
class StaticCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes_by_kind: dict = field(default_factory=dict)
    coll_count_by_kind: dict = field(default_factory=dict)

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_bytes_by_kind.values()))


def _tensors(x) -> list:
    """The tensors in an argument or result (lists and tuples walked)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    t = getattr(t, "_local_tensor", t)         # a DTensor: its local shard
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The size of the group a c10d op runs over: its ``process_group``
    argument, which reaches a dispatch mode boxed as a ``ScriptObject``."""
    names = [a.name for a in func._schema.arguments]
    group = args[names.index("process_group")]
    if isinstance(group, torch.ScriptObject):
        group = torch.distributed.ProcessGroup.unbox(group)
    return group.size()


def _written(func) -> set[int]:
    """Positions of the arguments ``func`` writes in place."""
    return {i for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write}


# the product of the enclosing trip_count()s: what an op counts for
_TRIPS = [1]


@contextlib.contextmanager
def trip_count(n: int):
    """Count each op run inside ``n`` times (0: not at all): a loop body
    run once that stands for ``n`` runs of itself.  Nests."""
    _TRIPS.append(_TRIPS[-1] * n)
    try:
        yield
    finally:
        _TRIPS.pop()


class CostMode(TorchDispatchMode):
    """Counts one run's FLOPs, op bytes and collectives into ``self.cost``
    (a :class:`StaticCost`)."""

    def __init__(self):
        super().__init__()
        self.cost = StaticCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # a composite op (matmul, einsum under inference mode): count
            # the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "c10d":
            self._collective(func, name, args)
            return out
        if func.is_view or name.startswith("empty") or ns != "aten":
            return out
        c, n = self.cost, _TRIPS[-1]
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            c.flops += n * f(*args, **kwargs, out_val=out)
        written = _written(func)
        read = [t for i, a in enumerate(args) if i not in written
                for t in _tensors(a)]
        read += [t for a in kwargs.values() for t in _tensors(a)]
        c.hbm_bytes += n * sum(_nbytes(t) for t in read + _tensors(out))
        return out

    def _collective(self, func, name: str, args) -> None:
        kind = _C10D_KIND.get(name)
        if kind is None or _group_size(func, args) == 1:
            return
        if kind == "all-reduce":    # in place on its tensor list
            moved = sum(_nbytes(t) for t in _tensors(args[0]))
        else:                       # (output, input, ...)
            moved = max(_nbytes(args[0]), _nbytes(args[1]))
        if kind == "all-reduce":
            moved *= 2
        c, n = self.cost, _TRIPS[-1]
        c.coll_bytes_by_kind[kind] = (c.coll_bytes_by_kind.get(kind, 0)
                                      + n * moved)
        c.coll_count_by_kind[kind] = c.coll_count_by_kind.get(kind, 0) + n
