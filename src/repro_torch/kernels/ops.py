"""Wrappers around the port's kernels (port of ``repro.kernels.ops``).

Dispatch is by the tensor's device: a CPU tensor takes the kernel's plain
torch version; any other device launches the hand-written kernel or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

from . import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = _fa.DEFAULT_BQ, bk: int = _fa.DEFAULT_BK):
    """q: [B, S, H, hd]; k, v: [B, S, K, hd] (GQA).  Returns [B, S, H, hd]."""
    Sq, Sk = q.shape[1], k.shape[1]
    bq = min(bq, max(8, Sq))
    bk = min(bk, max(8, Sk))
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         bq=bq, bk=bk)
    out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   bq=bq, bk=bk)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
