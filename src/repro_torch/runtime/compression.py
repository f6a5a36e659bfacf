"""Gradient compression: int8 quantization with error feedback (port of
``repro.runtime.compression``).

* :func:`ef_compress_grads` — the error-feedback wrapper (Seide et al.):
  the quantization residual is carried to the next step, preserving
  convergence (the sum of applied updates telescopes to the true gradient
  sum).
* :func:`compressed_allreduce` — an all-reduce over a mesh axis that
  moves int8 on the wire instead of f32: phase 1 an all-to-all of int8
  chunks (and an all-gather of the f32 scales) and a local f32 sum,
  phase 2 an all-gather of the requantized partial sums.  Wire bytes
  = 2 * n/4 vs. 2n for a ring f32 all-reduce (~4x compression).
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.models.base import tree_leaves, tree_map, tree_unflatten
from repro_torch.sharding import comm


def quantize_int8(x: torch.Tensor, mesh=None) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Symmetric per-tensor int8; returns (q, scale).  ``torch.round``
    rounds half to even, as ``jnp.round`` does.  With a ``mesh``, ``x`` is
    a rank's shard of a tensor and the scale is the whole tensor's (the
    max over the mesh)."""
    amax = torch.max(torch.abs(x))
    if mesh is not None:
        for i in range(mesh.ndim):
            amax = comm.all_reduce(amax, mesh.get_group(i),
                                   op=dist.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_allreduce(x: torch.Tensor, mesh, axis: str = "data"):
    """All-reduce ``x`` (every rank's own, the sum on every rank) over the
    mesh axis ``axis`` with the int8 wire format.  ``x`` is flattened and
    zero-padded to a multiple of the axis size, as in the JAX package."""
    group = mesh.get_group(axis)
    n = comm.size(group)
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunk = flat.shape[0] // n
    q, s = quantize_int8(flat)
    # phase 1: each peer receives its chunk from everyone (int8 on the wire)
    recv = comm.all_to_all(q.reshape(n, chunk), group)        # [n, chunk]
    scales = comm.all_gather(s.reshape(1), 0, group)          # [n] f32
    partial = torch.sum(recv.float() * scales[:, None], dim=0)
    # phase 2: requantize the reduced chunk, all-gather int8
    q2, s2 = quantize_int8(partial)
    allq = comm.all_gather(q2, 0, group).reshape(n, chunk)    # int8
    alls = comm.all_gather(s2.reshape(1), 0, group)           # [n]
    out = (allq.float() * alls[:, None]).reshape(-1)
    return out[:flat.shape[0] - pad].reshape(x.shape)


def ef_compress_grads(grads, error_state):
    """Error feedback: returns (compressed_grads, new_error_state).

    compressed = deQ(Q(g + e));  e' = (g + e) - compressed.  A ``None``
    error state starts at zeros.  DTensor gradients are quantized shard by
    shard with the whole leaf's scale, so the result is the one of one
    device."""
    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        mesh = getattr(g, "device_mesh", None)
        if mesh is not None:
            from torch.distributed.tensor import DTensor
            c, r = one_local(g.to_local(), e.to_local(), mesh)
            wrap = functools.partial(DTensor.from_local, device_mesh=mesh,
                                     placements=g.placements,
                                     run_check=False, shape=g.shape,
                                     stride=g.stride())
            return wrap(c), wrap(r)
        return one_local(g, e, None)

    def one_local(g, e, mesh):
        corrected = g.to(torch.float32) + e
        deq = dequantize_int8(*quantize_int8(corrected, mesh))
        return deq.to(g.dtype), corrected - deq

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves(error_state), strict=True)]
    return (tree_unflatten(grads, [c for c, _ in pairs]),
            tree_unflatten(grads, [e for _, e in pairs]))
