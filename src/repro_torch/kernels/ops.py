"""Wrappers around the port's kernels (port of ``repro.kernels.ops``).

Dispatch is by the tensor's device: a CPU tensor takes the kernel's plain
torch version; any other device launches the hand-written kernel or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, so a run
can show that its main path went through the kernel.  The counts are
exact when several threads launch (a service's workers).

No kernel has a backward pass, in the JAX package (no ``custom_vjp``) or
here, so the three model kernels refuse an input that requires grad while
grad mode is on, on either device: on the card a kernel's output would
carry no gradient, and ``jax.grad`` through the JAX kernels fails.
"""
from __future__ import annotations

import threading

import torch

from ..core import hanoi as _hanoi
from . import flash_attention as _fa
from . import hanoi_step as _hs
from . import rglru_scan as _rg
from . import rwkv6_scan as _rw
from . import sm_sched as _sm


def _no_autograd(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ops.{name} has no backward pass (nor has the JAX package's "
            f"kernel): train with the plain path (attn_impl='reference', "
            f"use_kernel=False), or call it under torch.no_grad()")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int | None = None, bk: int | None = None,
                    q_offset: int = 0):
    """q: [B, Sq, H, hd]; k: [B, Sk, K, hd] (GQA); v: [B, Sk, K, hdv]
    (hdv is hd but in latent attention).  Returns [B, Sq, H, hdv].  q's
    rows sit at global positions q_offset .. (a rank's own rows of a split
    sequence; keys at 0 .. Sk-1).  Tiles default to the kernel's for this
    dtype and these head dims (:func:`_fa.tiles`)."""
    _no_autograd("flash_attention", q, k, v)
    bq, bk = _fa.tiles(q.shape[1], k.shape[1], q.shape[3], bq, bk,
                        dtype=q.dtype, hdv=v.shape[3])
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         bq=bq, bk=bk, q_offset=q_offset)
    out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   bq=bq, bk=bk, q_offset=q_offset)
    _count(flash_attention)
    return out


def rglru_scan(a, b, *, seg: int = _rg.DEFAULT_SEG):
    """a, b: [B, S, W] f32 recurrence coefficients -> h [B, S, W] f32.

    ``seg``, the time steps per segment, sets the split-over-time schedule
    that the kernel and its plain twin both follow (:mod:`.rglru_scan`)."""
    _no_autograd("rglru_scan", a, b)
    if a.device.type == "cpu":
        return _rg.rglru_scan_plain(a, b, seg=seg)
    h = _rg.rglru_scan_cuda(a, b, seg=seg)
    _count(rglru_scan)
    return h


def rwkv6_scan(r, k, v, w, u, *, seg: int = _rw.DEFAULT_SEG):
    """r,k,v,w: [B, S, H, hd] f32; u: [H, hd].  Returns (out, s_last) with
    out [B, S, H, hd], s_last [B, H, hd, hd].  ``seg``, the tokens per
    segment, sets the schedule that the kernel and its plain twin both
    follow (:mod:`.rwkv6_scan`)."""
    _no_autograd("rwkv6_scan", r, k, v, w, u)
    if r.device.type == "cpu":
        return _rw.rwkv6_scan_plain(r, k, v, w, u, seg=seg)
    out = _rw.rwkv6_scan_cuda(r, k, v, w, u, seg=seg)
    _count(rwkv6_scan)
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
    _count(hanoi_run)
    return st


def sm_schedule(warp_map, trace_n, ops, trace_pc, trace_mask, lat, is_mem, *,
                out_cap: int, policy: str):
    """Issue-schedule a grid of SM cells over ``out_cap`` slots: warp_map,
    trace_n [C, N] int32, ops [U, L] (each trace row's opcode column),
    trace_pc / trace_mask [U, T] (K1's traces); ``lat`` / ``is_mem`` the
    per-opcode tables.  Returns a :class:`~.sm_sched.Schedule`."""
    if warp_map.device.type == "cpu":
        return _sm.sm_schedule_plain(warp_map, trace_n, ops, trace_pc,
                                     trace_mask, lat, is_mem,
                                     out_cap=out_cap, policy=policy)
    out = _sm.sm_schedule_cuda(warp_map, trace_n, ops, trace_pc, trace_mask,
                               lat, is_mem, out_cap=out_cap, policy=policy)
    _count(sm_schedule)
    return out


_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


flash_attention.launches = 0
hanoi_run.launches = 0
sm_schedule.launches = 0
rglru_scan.launches = 0
rwkv6_scan.launches = 0
