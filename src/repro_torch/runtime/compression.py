"""Gradient compression: int8 quantization with error feedback (port of
``repro.runtime.compression``).

* :func:`ef_compress_grads` — the error-feedback wrapper (Seide et al.):
  the quantization residual is carried to the next step, preserving
  convergence (the sum of applied updates telescopes to the true gradient
  sum).
* :func:`compressed_allreduce`, the int8 collective over a mesh axis, is
  not ported yet: it comes with distribution (ROADMAP.md, item 11).
"""
from __future__ import annotations

import torch

from repro_torch.models.base import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8; returns (q, scale).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_allreduce(x, mesh=None, axis: str = "data"):
    raise NotImplementedError(
        "compressed_allreduce is not ported yet: it comes with "
        "distribution (ROADMAP.md, Open items, item 11)")


def ef_compress_grads(grads, error_state):
    """Error feedback: returns (compressed_grads, new_error_state).

    compressed = deQ(Q(g + e));  e' = (g + e) - compressed.  A ``None``
    error state starts at zeros."""
    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        corrected = g.to(torch.float32) + e
        deq = dequantize_int8(*quantize_int8(corrected))
        return deq.to(g.dtype), corrected - deq

    pairs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves(error_state), strict=True)]
    return (tree_unflatten(grads, [c for c, _ in pairs]),
            tree_unflatten(grads, [e for _, e in pairs]))
