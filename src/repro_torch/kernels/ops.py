"""Wrappers around the port's kernels (port of ``repro.kernels.ops``).

Dispatch is by the tensor's device: a CPU tensor takes the kernel's plain
torch version; any other device launches the hand-written kernel or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

from ..core import hanoi as _hanoi
from . import flash_attention as _fa
from . import hanoi_step as _hs
from . import rglru_scan as _rg
from . import rwkv6_scan as _rw


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int | None = None, bk: int | None = None):
    """q: [B, S, H, hd]; k, v: [B, S, K, hd] (GQA).  Returns [B, S, H, hd].
    Tiles default to the kernel's for this dtype and head dim
    (:func:`_fa.tiles`)."""
    bq, bk = _fa.tiles(q.shape[1], k.shape[1], q.shape[3], bq, bk,
                        dtype=q.dtype)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         bq=bq, bk=bk)
    out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   bq=bq, bk=bk)
    flash_attention.launches += 1
    return out


def rglru_scan(a, b, *, seg: int = _rg.DEFAULT_SEG):
    """a, b: [B, S, W] f32 recurrence coefficients -> h [B, S, W] f32.

    ``seg``, the time steps per segment, sets the split-over-time schedule
    that the kernel and its plain twin both follow (:mod:`.rglru_scan`)."""
    if a.device.type == "cpu":
        return _rg.rglru_scan_plain(a, b, seg=seg)
    h = _rg.rglru_scan_cuda(a, b, seg=seg)
    rglru_scan.launches += 1
    return h


def rwkv6_scan(r, k, v, w, u, *, seg: int = _rw.DEFAULT_SEG):
    """r,k,v,w: [B, S, H, hd] f32; u: [H, hd].  Returns (out, s_last) with
    out [B, S, H, hd], s_last [B, H, hd, hd].  ``seg``, the tokens per
    segment, sets the schedule that the kernel and its plain twin both
    follow (:mod:`.rwkv6_scan`)."""
    if r.device.type == "cpu":
        return _rw.rwkv6_scan_plain(r, k, v, w, u, seg=seg)
    out = _rw.rwkv6_scan_cuda(r, k, v, w, u, seg=seg)
    rwkv6_scan.launches += 1
    return out


def hanoi_run(programs, skips, regs, mems, lanes, cfg, *,
              majority_first: bool = True, active0: int | None = None):
    """Run a batch of simulated warps to their ends under Hanoi: programs
    [N, L, 8] int32, skips [N, L] bool, regs [N, W, NR], mems [N, M] and
    lanes [N, W] int32.  Returns the final ``HanoiState``
    (:mod:`repro_torch.core.hanoi`)."""
    if programs.device.type == "cpu":
        return _hanoi.hanoi_run_plain(programs, skips, regs, mems, lanes, cfg,
                                      majority_first=majority_first,
                                      active0=active0)
    st = _hs.hanoi_run_cuda(programs, skips, regs, mems, lanes, cfg,
                            majority_first=majority_first, active0=active0)
    hanoi_run.launches += 1
    return st


flash_attention.launches = 0
hanoi_run.launches = 0
rglru_scan.launches = 0
rwkv6_scan.launches = 0
