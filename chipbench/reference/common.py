"""What the plain references share: f32 arithmetic with TF32 off, RMSNorm,
and the two ways of reading a weight, exact (:data:`EXACT`) or rounded to
fp8 e4m3 with a scale per output channel (:data:`FP8`, the lower
precision the correctness check's control computes in).

Plain PyTorch only: nothing here imports the program."""
from __future__ import annotations

import contextlib

import torch

_E4M3_MAX = 448.0


class Exact:
    """Weights read as they are, in f32."""

    def mat(self, w):
        """A weight [..., in, out] as x @ w reads it."""
        return w.float()

    def rows(self, w):
        """Rows of a table [..., d] (the token embedding)."""
        return w.float()


class Fp8(Exact):
    """Weights rounded to fp8 e4m3, each output channel (a column of a
    [in, out] product, a row of the embedding table) scaled to the
    format's largest value first."""

    def mat(self, w):
        return _fp8(w.float(), dim=-2)

    def rows(self, w):
        return _fp8(w.float(), dim=-1)


def _fp8(w, dim: int):
    scale = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / _E4M3_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


EXACT = Exact()
FP8 = Fp8()


@contextlib.contextmanager
def f32_no_tf32():
    """Float32 products in full float32: TF32 off for the duration."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def layers(tree):
    """(layer params, stacked index) for every layer of the tree's
    segments, in depth order: ``segments[i][pattern position][leaf][r]``."""
    for seg in tree["segments"]:
        repeat = next(iter(_leaves(seg))).shape[0]
        for r in range(repeat):
            for j in sorted(seg, key=int):
                yield seg[j], r


def _leaves(node):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k])
    else:
        yield node


def at(node, r: int):
    """Layer ``r`` of every stacked leaf under ``node``."""
    if isinstance(node, dict):
        return {k: at(v, r) for k, v in node.items()}
    return node[r]
