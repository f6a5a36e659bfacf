"""The port's collective layer: every collective of the sharded model,
optimizer, compression and checkpoint paths goes through here, on local
tensors and ``torch.distributed`` process groups.

* Raw collectives (:func:`all_gather`, :func:`reduce_scatter`,
  :func:`all_reduce`, :func:`all_to_all`) along any tensor dimension.
* Autograd pairs, each backward the adjoint of its forward:
  :func:`gather` (all-gather / reduce-scatter), :func:`scatter`
  (reduce-scatter / all-gather), :func:`psum` (all-reduce / all-reduce)
  and :func:`bcast` (identity / all-reduce: a replicated value used on
  every rank).  With these, a rank's loss share summed over the ranks is
  the global loss, and every gradient comes out summed where it must be.
* :data:`STATS` counts every collective and the bytes each rank puts
  into it.

The collectives are ``torch.distributed``'s own (c10d).  Ranks that share
one card talk over gloo, and on the card's PyTorch (2.11, CUDA 12.8) every
c10d collective used here takes CUDA tensors over gloo (gloo copies them
through host memory itself), while ``_functional_collectives``'
``all_gather_tensor`` on a CUDA tensor over gloo kills the process
(SIGSEGV), and with it DTensor's ``redistribute`` and ``full_tensor``.  So
nothing here goes through either, and nothing is staged through the host
by this layer.

A group of one rank is skipped (the collective is the identity), except
for :func:`all_reduce`, so that a world of one still runs its backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

class CommStats:
    """Counts of this process's collectives: calls and the bytes this rank
    puts into them, in all and by op."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.bytes = 0
        self.by_op: dict[str, list[int]] = {}

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "by_op": {k: list(v) for k, v in self.by_op.items()}}


STATS = CommStats()


def _call(op: str, fn, out: torch.Tensor, inp: torch.Tensor, group):
    """Run ``fn(out, inp, group)`` and count it."""
    n = inp.numel() * inp.element_size()
    STATS.calls += 1
    STATS.bytes += n
    calls_bytes = STATS.by_op.setdefault(op, [0, 0])
    calls_bytes[0] += 1
    calls_bytes[1] += n
    fn(out, inp, group)
    return out


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def _front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in rank order."""
    n = size(group)
    if n == 1:
        return x
    xf = _front(x, dim)
    out = torch.empty((n * xf.shape[0],) + xf.shape[1:], dtype=x.dtype,
                      device=x.device)
    _call("all_gather", lambda o, i, g: dist.all_gather_into_tensor(
        o, i, group=g), out, xf, group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the ranks, then keep this rank's chunk along ``dim``."""
    n = size(group)
    if n == 1:
        return x
    xf = _front(x, dim)
    assert xf.shape[0] % n == 0, (x.shape, dim, n)
    out = torch.empty((xf.shape[0] // n,) + xf.shape[1:], dtype=x.dtype,
                      device=x.device)
    _call("reduce_scatter", lambda o, i, g: dist.reduce_scatter_tensor(
        o, i, group=g), out, xf, group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` (run even on a group of one)."""
    out = x.contiguous().clone()

    def fn(o, i, g):
        if o.data_ptr() != i.data_ptr():
            o.copy_(i)
        dist.all_reduce(o, op=op, group=g)
    return _call("all_reduce", fn, out, out, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk ``i`` of dim 0 goes to rank ``i``; the result holds, at chunk
    ``j``, what rank ``j`` sent here."""
    if size(group) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    _call("all_to_all", lambda o, i, g: dist.all_to_all_single(
        o, i, group=g), out, x, group)
    return out


def chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of a tensor that every rank of ``group`` holds."""
    n = size(group)
    if n == 1:
        return x
    assert x.shape[dim] % n == 0, (x.shape, dim, n)
    return x.chunk(n, dim)[rank(group)]


# ---------------------------------------------------------------------------
# autograd pairs
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def gather(x, dim: int, group):
    """All-gather along ``dim``; the gradient is reduce-scattered."""
    return x if size(group) == 1 else _Gather.apply(x, dim, group)


def scatter(x, dim: int, group):
    """Reduce-scatter along ``dim``; the gradient is all-gathered."""
    return x if size(group) == 1 else _Scatter.apply(x, dim, group)


def psum(x, group):
    """All-reduce (sum); the gradient is all-reduced."""
    return x if size(group) == 1 else _Psum.apply(x, group)


def bcast(x, group):
    """A value replicated over ``group`` and used on every rank: the
    identity, whose gradient is all-reduced."""
    return x if size(group) == 1 else _Bcast.apply(x, group)
