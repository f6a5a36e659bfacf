"""K2, the SM issue scheduler: the CUDA kernel's launcher and its plain twin.

Port of the device half of ``repro.engine.mechanisms.sm_jax``
(``_cell_scheduler``, a ``lax.scan`` over issue slots, vmapped over SM cells
by ``_compiled_grid_scheduler``).  One call schedules a whole grid of SM
cells: cell ``c``'s warp ``w`` replays the trace row ``warp_map[c, w]`` of
the Hanoi state K1 wrote (``trace_pc`` / ``trace_mask``, hash-consed rows
shared by identical warps) for its first ``trace_n[c, w]`` entries, and each
of ``out_cap`` slots issues one instruction of the cell under an issue
policy, with per-opcode latencies.  The result is the issue schedule
(``warp``, ``pc``, ``mask`` per slot; slots past a cell's total are
``(-1, -1, 0)``) and seven int32 counters per cell.

On the card ``csrc/sm_sched.cu`` computes it; :func:`sm_schedule_plain`
walks the same slots in torch, vectorized over cells, with a host loop over
slots.  Both follow the reference's int32 arithmetic, which wraps, and agree
bit for bit in every output, the fill included.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.isa import Op
from ..timing.policies import POLICY_NAMES, resolve_policy_name
from . import _build

N_OPS = max(int(op) for op in Op) + 1
_BIG = 2 ** 31 - 1
_M32 = 0xFFFFFFFF
_GTO, _RR = POLICY_NAMES.index("greedy_then_oldest"), \
    POLICY_NAMES.index("round_robin")
COUNTERS = ("issued", "cycle", "busy", "istall", "sstall", "mstall", "tinstr")


class Schedule(NamedTuple):
    """The issue schedule of a grid of ``C`` cells over ``out_cap`` slots."""

    warp: torch.Tensor     # i32[C, out_cap]  the issuing warp, -1 past total
    pc: torch.Tensor       # i32[C, out_cap]  its pc, -1 past total
    mask: torch.Tensor     # i32[C, out_cap]  its u32 mask's bits, 0 past total
    issued: torch.Tensor   # i32[C]  slots issued (the cell's total)
    cycle: torch.Tensor    # i32[C]  cycles
    busy: torch.Tensor     # i32[C]  cycles that issued
    istall: torch.Tensor   # i32[C]  issue stalls: more than one warp ready
    sstall: torch.Tensor   # i32[C]  scoreboard stall cycles
    mstall: torch.Tensor   # i32[C]  memory stall cycles
    tinstr: torch.Tensor   # i32[C]  thread instructions


def _check(warp_map, trace_n, ops, trace_pc, trace_mask, lat, is_mem,
           out_cap: int) -> None:
    C, N = warp_map.shape
    U, T = trace_pc.shape
    for name, t, shape in (("trace_n", trace_n, (C, N)),
                           ("ops", ops, (U, ops.shape[1])),
                           ("trace_mask", trace_mask, (U, T))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {shape}, got {tuple(t.shape)}")
    for name, t in (("warp_map", warp_map), ("trace_n", trace_n),
                    ("ops", ops), ("trace_pc", trace_pc),
                    ("trace_mask", trace_mask)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if min(C, N, U, T, ops.shape[1]) < 1:
        raise ValueError(f"empty grid: {C} cells of {N} warps, {U} trace "
                         f"rows of {T}, programs of {ops.shape[1]}")
    if len(lat) != N_OPS or len(is_mem) != N_OPS:
        raise ValueError(f"latency tables must have {N_OPS} entries")
    if out_cap < 32 or out_cap % 32:
        raise ValueError(f"out_cap {out_cap} must be a positive multiple of "
                         "32")


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32's 32 bits, as int32."""
    x = x.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _M32) >> 24).to(torch.int32)


def sm_schedule_plain(warp_map, trace_n, ops, trace_pc, trace_mask,
                      lat: Sequence[int], is_mem: Sequence[bool], *,
                      out_cap: int, policy: str) -> Schedule:
    """K2's plain twin on any device (the reference's ``schedule``, vmapped
    over cells, as a host loop over slots).  ``warp_map`` and ``trace_n``
    are [C, N] int32; ``ops`` [U, L] the opcode column of each trace row's
    program; ``trace_pc`` / ``trace_mask`` [U, T]; ``lat`` and ``is_mem``
    the per-opcode latency and blocks-on-memory tables.

    The loop carries only what the next slot reads; the per-slot outputs
    are stacked after it, and the counters that nothing in the loop reads
    (busy, the stalls, thread instructions) are summed from them there, in
    int64 and then wrapped to int32, which equals the reference's wrapping
    int32 running sums."""
    _check(warp_map, trace_n, ops, trace_pc, trace_mask, lat, is_mem,
           out_cap)
    pid = POLICY_NAMES.index(resolve_policy_name(policy))
    dev, I32, I64 = warp_map.device, torch.int32, torch.int64
    C, N = warp_map.shape
    L, T = ops.shape[1], trace_pc.shape[1]
    # each row's opcode latency and memory flag by pc; column L is the NOP
    # a pc outside the program reads, and opcodes are clipped first
    code = torch.cat([ops, torch.full_like(ops[:, :1], int(Op.NOP))], 1)
    code = code.clamp(0, N_OPS - 1).long()
    lat_of = torch.as_tensor(np.asarray(lat, np.int32), device=dev)[code]
    mem_of = torch.as_tensor(np.asarray(is_mem, bool), device=dev)[code]
    w_ids = torch.arange(N, dtype=I32, device=dev).expand(C, N)
    rows = warp_map.to(I64)

    def zeros(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    idx, t_ready, in_order = zeros(C, N), zeros(C, N), zeros(C, N)
    t_mem = zeros(C, N, dtype=torch.bool)
    cycle, issued, last, cursor = zeros(C), zeros(C), zeros(C), zeros(C)
    total = trace_n.sum(1).to(I32)            # int32 wraps, as jnp.sum's
    steps: dict[str, list] = {k: [] for k in ("active", "sel", "pc", "mask",
                                              "gap", "gap_mem", "contended")}
    for _ in range(min(out_cap, max(0, int(total.max())))):
        active = issued < total
        pending = idx < trace_n
        earliest = torch.where(pending, torch.maximum(in_order, t_ready),
                               _BIG)
        next_t = earliest.min(1).values
        stalled = active & (next_t > cycle)
        gap_mem = (pending & (earliest <= next_t[:, None]) & t_mem
                   & (t_ready >= in_order)).any(1)
        gap = torch.where(stalled, next_t - cycle, 0)
        cycle = torch.where(active, torch.maximum(cycle, next_t), cycle)
        last = torch.where(stalled, -1, last)
        ready = pending & (earliest <= cycle[:, None])
        if pid == _GTO:
            key = torch.where(w_ids == last[:, None], 0, w_ids + 1)
        elif pid == _RR:
            key = (w_ids - cursor[:, None]) % N
        else:
            key = w_ids
        # keys are injective: the first minimum is the only one, and with
        # no warp ready every key is _BIG and warp 0 is taken (jnp.argmin)
        sel = torch.where(ready, key, _BIG).argmin(1, keepdim=True)
        row = rows.gather(1, sel).squeeze(1)
        at = idx.gather(1, sel).squeeze(1).clamp(max=T - 1).long()
        pc = trace_pc[row, at]
        k = torch.where((pc >= 0) & (pc < L), pc, L).long()
        upd = active[:, None] & (w_ids == sel)
        t_ready = torch.where(upd, (cycle + lat_of[row, k])[:, None],
                              t_ready)
        t_mem = torch.where(upd, mem_of[row, k][:, None], t_mem)
        in_order = torch.where(upd, (cycle + 1)[:, None], in_order)
        idx = idx + upd
        sel = sel.squeeze(1).to(I32)
        if pid == _GTO:
            last = torch.where(active, sel, last)
        if pid == _RR:
            cursor = torch.where(active, (sel + 1) % N, cursor)
        act = active.to(I32)
        cycle = cycle + act
        issued = issued + act
        for name, v in (("active", active), ("sel", sel), ("pc", pc),
                        ("mask", trace_mask[row, at]), ("gap", gap),
                        ("gap_mem", gap_mem),
                        ("contended", ready.sum(1) > 1)):
            steps[name].append(v)
    out_w = torch.full((C, out_cap), -1, dtype=I32, device=dev)
    out_pc = torch.full((C, out_cap), -1, dtype=I32, device=dev)
    out_mask = zeros(C, out_cap)
    busy, istall, sstall, mstall, tinstr = (zeros(C) for _ in range(5))
    if steps["active"]:
        st = {k: torch.stack(v, 1) for k, v in steps.items()}
        act, n = st["active"], len(steps["active"])
        out_w[:, :n] = torch.where(act, st["sel"], -1)
        out_pc[:, :n] = torch.where(act, st["pc"], -1)
        out_mask[:, :n] = torch.where(act, st["mask"], 0)

        def wrapped_sum(x):
            return _wrap32((x.to(I64) * act).sum(1))
        busy = wrapped_sum(torch.ones_like(st["sel"]))
        istall = wrapped_sum(st["contended"])
        mstall = wrapped_sum(torch.where(st["gap_mem"], st["gap"], 0))
        sstall = wrapped_sum(torch.where(st["gap_mem"], 0, st["gap"]))
        tinstr = wrapped_sum(_popcount(st["mask"]))
    return Schedule(out_w, out_pc, out_mask, issued, cycle, busy, istall,
                    sstall, mstall, tinstr)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 sums to int32, two's complement (int32 sums wrap)."""
    x = x & _M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "warp_map", "trace_n", "ops", "trace_pc", "trace_mask", "out_warp",
        "out_pc", "out_mask", "counters", "scratch")]
        + [(n, ctypes.c_int) for n in ("C", "N", "U", "L", "T", "cap",
                                       "policy")]
        + [("lat", ctypes.c_int * 32), ("is_mem", ctypes.c_uint)])


def sm_schedule_cuda(warp_map, trace_n, ops, trace_pc, trace_mask,
                     lat: Sequence[int], is_mem: Sequence[bool], *,
                     out_cap: int, policy: str) -> Schedule:
    """Launch K2 on contiguous int32 CUDA tensors (the operands of
    :func:`sm_schedule_plain`).  Cells of up to 32 warps take one hardware
    warp each; wider cells a CTA each, with their state in a scratch
    buffer.  Raises on anything the kernel does not take; never falls
    back."""
    _check(warp_map, trace_n, ops, trace_pc, trace_mask, lat, is_mem,
           out_cap)
    ins = (warp_map, trace_n, ops, trace_pc, trace_mask)
    dev = warp_map.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError("sm_schedule_cuda needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in ins]}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("sm_schedule_cuda needs contiguous operands")
    pid = POLICY_NAMES.index(resolve_policy_name(policy))
    C, N = warp_map.shape
    (U, L), T = ops.shape, trace_pc.shape[1]
    outs = torch.empty((3, C, out_cap), dtype=torch.int32, device=dev)
    counters = torch.empty((len(COUNTERS), C), dtype=torch.int32, device=dev)
    scratch = (torch.empty((C, N, 4), dtype=torch.int32, device=dev)
               if N > 32 else None)
    lat32 = (ctypes.c_int * 32)(*(int(x) for x in lat))
    mem_bits = sum(1 << i for i, m in enumerate(is_mem) if m)
    params = _Params(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        counters.data_ptr(), None if scratch is None else scratch.data_ptr(),
        C, N, U, L, T, out_cap, pid, lat32, mem_bits)
    lib = _build.load("sm_sched")
    err = lib.sm_schedule(ctypes.byref(params),
                          ctypes.c_void_p(torch.cuda.current_stream(dev)
                                          .cuda_stream))
    if err:
        raise RuntimeError(f"sm_sched kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return Schedule(outs[0], outs[1], outs[2], *counters)


class NarrowLayout(NamedTuple):
    """How K2 lays out a grid of cells of up to 32 warps on the card."""

    cells: int      # cells (hardware warps) a CTA
    ctas: int
    staged: bool    # the opcode columns are staged in shared memory
    exact: bool     # waits may pass the packed word: two more minima a slot
    smem: int       # a CTA's shared memory bytes


def narrow_layout(C: int, N: int, L: int, lat: Sequence[int], *,
                  out_cap: int) -> NarrowLayout:
    """:func:`sm_schedule_cuda`'s layout for ``C`` cells of ``N`` <= 32
    warps, programs of ``L`` rows, the latency table ``lat`` and
    ``out_cap`` slots, on the current card.  It asks the built library, so
    it works only where the kernel builds."""
    if not 1 <= N <= 32:
        raise ValueError(f"the narrow layout takes 1 to 32 warps, got {N}")
    params = _Params(*([None] * 10), C, N, 1, L, 1, out_cap, 0,
                     (ctypes.c_int * 32)(*(int(x) for x in lat)), 0)
    out = (ctypes.c_int * 5)()
    lib = _build.load("sm_sched")
    err = lib.sm_narrow_layout(ctypes.byref(params), out)
    if err:
        raise RuntimeError(f"sm_narrow_layout failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return NarrowLayout(out[0], out[1], bool(out[2]), bool(out[3]), out[4])


def slot_chain_cycles(device, links: int = 1 << 16, *,
                      narrow_link: bool = False) -> float:
    """Clock cycles a link of the scheduling function's shortest dependent
    chain takes on the card: one warp-wide minimum and the issued warp's
    update (``slot_chain_kernel`` in ``csrc/sm_sched.cu`` says why one
    minimum is enough for cells of up to 32 warps); with ``narrow_link``,
    the chain of K2's narrow slot as it is built (``slot_link_kernel``:
    the packed words, the minimum, the decode and the update, without the
    slot's memory traffic and counters).  The mean over ``links`` links of
    one warp, after a first run that loads the kernel.  A measurement of
    the card for K2's bound and its losses; the scheduler does not use
    it."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _build.load("sm_sched")
    stream = ctypes.c_void_p(torch.cuda.current_stream(out.device)
                             .cuda_stream)
    for _ in range(2):
        err = lib.sm_slot_chain(links, int(narrow_link),
                                ctypes.c_void_p(out.data_ptr()), stream)
        if err:
            raise RuntimeError(f"slot_chain kernel launch failed: "
                               f"{_build.cuda_error_string(lib, err)}")
    return int(out[0]) / links


def _argtypes(lib):
    lib.sm_schedule.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.sm_schedule.restype = ctypes.c_int
    lib.sm_narrow_layout.argtypes = [ctypes.POINTER(_Params),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.sm_narrow_layout.restype = ctypes.c_int
    lib.sm_slot_chain.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.sm_slot_chain.restype = ctypes.c_int


_build.register("sm_sched", "sm_sched.cu", _argtypes)


def schedule_bytes(trace_n: torch.Tensor, out_cap: int) -> int:
    """Bytes a schedule must move: each warp's map entry, trace length and
    issued (pc, mask) entries read once, and every output slot and counter
    written once."""
    C, N = trace_n.shape
    return (8 * C * N + 8 * int(trace_n.to(torch.int64).sum())
            + 12 * C * out_cap + 4 * len(COUNTERS) * C)
