"""Hanoi as a batched state machine: the plain PyTorch step and its driver.

Port of ``repro.core.hanoi``.  The reference runs one simulated warp as a
``lax.while_loop`` over ``_step``, a 29-way ``lax.switch`` over opcodes,
vmapped over warps.  Here the state is a :class:`HanoiState` of tensors with
a leading warp dimension, and a whole batch runs in one of two ways:

* on the card, kernel K1 (``csrc/hanoi_step.cu``, through
  :func:`repro_torch.kernels.ops.hanoi_run`): one launch runs every warp of
  the batch to its end, one simulated warp to one hardware warp;
* on the CPU, :func:`_run_plain`: a host loop of :func:`_step_plain`, each
  step vectorized over the batch, until every warp has halted or spent its
  fuel.  It is the CPU oracle and K1's twin on the card; nothing on the main
  path calls it when a card is present.

Both follow the reference's semantics bit for bit, including its index
rules: a gather normalizes a negative index once (``i + n``) and clamps it
into range, a scatter normalizes once and drops what is still out of range,
and a register or predicate write whose index is out of range writes
nothing.  Masks are held as int64 in ``[0, 2**32)`` (torch's uint32 is
thin); the trace, the one large buffer (``max_steps`` entries per warp), keeps
each mask's 32 bits in an int32, as the reference's u32 trace does.  Results
become u32 numpy only at the boundary (:func:`state_trace`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .isa import MachineConfig, Op

# error bit flags
ERR_NO_FREE_BX = 1

M32 = 0xFFFFFFFF
_I64, _I32, _BOOL = torch.int64, torch.int32, torch.bool
_N_HANDLERS = len(Op)


class HanoiState(NamedTuple):
    """One simulated warp per row (the reference's fields, batched)."""

    # warp-split stack (SS VII: one entry per path; top = executing path)
    ws_pc: torch.Tensor      # i32[N, SD]
    ws_mask: torch.Tensor    # i64[N, SD]   u32 values
    ws_top: torch.Tensor     # i32[N]  (-1 = empty)
    # reconvergence stack (one entry per pending reconvergence point)
    rec_pc: torch.Tensor     # i32[N, SD]
    rec_bx: torch.Tensor     # i32[N, SD]
    rec_top: torch.Tensor    # i32[N]
    # Bx register file
    bx_val: torch.Tensor     # i64[N, NB]   u32 values
    bx_valid: torch.Tensor   # bool[N, NB]
    waiting: torch.Tensor    # i64[N]       u32 values
    finished: torch.Tensor   # i64[N]       u32 values
    # architectural state
    regs: torch.Tensor       # i32[N, W, NR]
    preds: torch.Tensor      # bool[N, W, NP]
    mem: torch.Tensor        # i32[N, M]
    lane_ids: torch.Tensor   # i32[N, W]
    # trace + bookkeeping
    trace_pc: torch.Tensor   # i32[N, T]  (-1 past trace_n)
    trace_mask: torch.Tensor  # i32[N, T]  the u32 mask's bits
    trace_n: torch.Tensor    # i32[N]
    steps: torch.Tensor      # i32[N]
    fuel: torch.Tensor       # i32[N]
    halted: torch.Tensor     # bool[N]
    error: torch.Tensor      # i32[N] bit flags


def check_cfg(cfg: MachineConfig) -> None:
    """The shapes K1 and this module take: a simulated warp fits one
    hardware warp."""
    if not 1 <= cfg.n_threads <= 32:
        raise ValueError(f"n_threads {cfg.n_threads} must be in 1..32: one "
                         "simulated warp runs on one hardware warp")
    if min(cfg.n_regs, cfg.n_preds, cfg.n_bx, cfg.mem_size,
           cfg.max_steps) < 1:
        raise ValueError(f"bad machine config {cfg}")


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values to int32, two's complement (the reference's int32
    arithmetic wraps)."""
    x = x & M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(_I32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An int32 tensor's bits as u32 values in an int64 tensor."""
    return x.to(_I64) & M32


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of u32 values held in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _norm(i: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(i < 0, i + n, i)


def _take(a: torch.Tensor, i: torch.Tensor, n: int) -> torch.Tensor:
    """``a[w, i[w]]`` with the reference's gather rule (normalize, clamp)."""
    j = _norm(i.to(_I64), n).clamp(0, n - 1)
    return a.gather(1, j.unsqueeze(1)).squeeze(1)


def _put(a: torch.Tensor, i: torch.Tensor, n: int, v: torch.Tensor,
         cond: torch.Tensor) -> torch.Tensor:
    """``a[w, i[w]] = v[w]`` where ``cond[w]``, with the reference's scatter
    rule (normalize once, drop what is still out of range)."""
    j = _norm(i.to(_I64), n)
    hit = cond.unsqueeze(1) & (torch.arange(n, device=a.device)
                               == j.unsqueeze(1))
    return torch.where(hit, v.to(a.dtype).unsqueeze(1), a)


def _first_lane(mask: torch.Tensor, W: int) -> torch.Tensor:
    """The lowest set lane of each mask; 0 for an empty mask (the
    reference's ``argmax`` of the lane vector)."""
    bits = (mask.unsqueeze(1) >> torch.arange(W, device=mask.device)) & 1
    return bits.argmax(1)


def _lane_reg(regs: torch.Tensor, r: torch.Tensor, NR: int) -> torch.Tensor:
    """``regs[w, :, r[w]]`` for ``r >= 0``, clamped into the file: [N, W]."""
    N, W, _ = regs.shape
    idx = r.to(_I64).clamp(0, NR - 1).view(N, 1, 1).expand(N, W, 1)
    return regs.gather(2, idx).squeeze(2)


def init_state(program_len: int, cfg: MachineConfig, *, n_warps: int = 1,
               init_regs=None, init_mem=None, lane_ids=None,
               active0: int | None = None, device=None) -> HanoiState:
    """The batch's state before its first step (the reference's
    ``init_state``, with ``n_warps`` rows).  ``init_regs`` [N, W, NR],
    ``init_mem`` [N, M] and ``lane_ids`` [N, W] may also be given for one
    warp and are then broadcast.  ``program_len`` is kept for the
    reference's signature; the state does not depend on it."""
    from ..device import resolve
    check_cfg(cfg)
    dev = resolve(device)
    N, W, SD, T = n_warps, cfg.n_threads, cfg.n_threads + 2, cfg.max_steps
    full = cfg.full_mask if active0 is None else int(active0) & M32

    def operand(x, shape, default):
        if x is None:
            return default
        return torch.as_tensor(x).to(dev, _I32) \
            .reshape(-1, *shape).expand(N, *shape).clone()

    zeros = dict(dtype=_I32, device=dev)
    ws_mask = torch.zeros((N, SD), dtype=_I64, device=dev)
    ws_mask[:, 0] = full
    return HanoiState(
        ws_pc=torch.zeros((N, SD), **zeros), ws_mask=ws_mask,
        ws_top=torch.zeros(N, **zeros),
        rec_pc=torch.zeros((N, SD), **zeros),
        rec_bx=torch.zeros((N, SD), **zeros),
        rec_top=torch.full((N,), -1, **zeros),
        bx_val=torch.zeros((N, cfg.n_bx), dtype=_I64, device=dev),
        bx_valid=torch.zeros((N, cfg.n_bx), dtype=_BOOL, device=dev),
        waiting=torch.zeros(N, dtype=_I64, device=dev),
        finished=torch.zeros(N, dtype=_I64, device=dev),
        regs=operand(init_regs, (W, cfg.n_regs),
                     torch.zeros((N, W, cfg.n_regs), **zeros)),
        preds=torch.zeros((N, W, cfg.n_preds), dtype=_BOOL, device=dev),
        mem=operand(init_mem, (cfg.mem_size,),
                    torch.zeros((N, cfg.mem_size), **zeros)),
        lane_ids=operand(lane_ids, (W,), torch.arange(W, **zeros)
                         .expand(N, W).clone()),
        trace_pc=torch.full((N, T), -1, **zeros),
        trace_mask=torch.zeros((N, T), **zeros),
        trace_n=torch.zeros(N, **zeros), steps=torch.zeros(N, **zeros),
        fuel=torch.full((N,), T, **zeros),
        halted=torch.zeros(N, dtype=_BOOL, device=dev),
        error=torch.zeros(N, **zeros))


# ---------------------------------------------------------------------------
# the scheduler step (plain PyTorch, vectorized over the batch)
# ---------------------------------------------------------------------------

def _cmp(a: torch.Tensor, b: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    c = code.clamp(0, 5).unsqueeze(1)
    return torch.where(c == 0, a == b, torch.where(
        c == 1, a != b, torch.where(c == 2, a < b, torch.where(
            c == 3, a <= b, torch.where(c == 4, a > b, a >= b)))))


def _pred_vec(preds: torch.Tensor, p: torch.Tensor, NP: int) -> torch.Tensor:
    """Predicate guard [N, W] for encoded field p (0 / +k / -k)."""
    idx = (p.to(_I64).abs() - 1).clamp(0, NP - 1)
    N, W, _ = preds.shape
    val = preds.gather(2, idx.view(N, 1, 1).expand(N, W, 1)).squeeze(2)
    p = p.unsqueeze(1)
    return torch.where(p == 0, True, torch.where(p > 0, val, ~val))


def _step_plain(s: HanoiState, program: torch.Tensor, skip: torch.Tensor,
                cfg: MachineConfig, majority_first: bool) -> HanoiState:
    """One scheduler slot of every warp that still runs (the reference's
    ``_step``); a warp that has halted or spent its fuel is left as is.

    ``program`` is [N, L, 8] int32, ``skip`` [N, L] bool.  The trace
    buffers are written in place (copying them would cost ``max_steps``
    entries a warp and step); every other field is returned anew.  Only the
    handlers of opcodes some warp executes in this slot are evaluated (one
    host read a step says which)."""
    N, L = program.shape[0], program.shape[1]
    W, NB, NR, NP, M = (cfg.n_threads, cfg.n_bx, cfg.n_regs, cfg.n_preds,
                        cfg.mem_size)
    SD, FULL = W + 2, cfg.full_mask
    dev = program.device
    rows = torch.arange(N, device=dev)
    lane_bits = torch.ones(W, dtype=_I64, device=dev) \
        << torch.arange(W, device=dev)
    run = ~s.halted & (s.fuel > 0)
    not_fin = s.finished ^ M32
    none = torch.zeros_like(run)

    # ---- 1) reconvergence check (SS VII-B) --------------------------------
    rtop = s.rec_top.clamp(min=0)
    rbx = _take(s.rec_bx, rtop, SD)
    live = _take(s.bx_val, rbx, NB) & not_fin
    reconv = (run & (s.rec_top >= 0) & _take(s.bx_valid, rbx, NB)
              & ((live & (s.waiting ^ M32)) == 0))

    # ---- 2) execute top-of-WS: decode ---------------------------------------
    ex = run & ~reconv
    top = s.ws_top.clamp(min=0)
    pc = _take(s.ws_pc, top, SD)
    amask = _take(s.ws_mask, top, SD)
    oob = (pc < 0) | (pc >= L)
    halt = ex & (s.ws_top < 0)
    iexit = ex & (s.ws_top >= 0) & oob
    instr = ex & (s.ws_top >= 0) & ~oob
    f = program[rows, pc.to(_I64).clamp(0, L - 1)]
    op = f[:, 0].clamp(0, _N_HANDLERS - 1)
    dst, s0, s1, s2, imm, p1, p2 = (f[:, i] for i in range(1, 8))
    onehot = instr.unsqueeze(1) & (
        op.unsqueeze(1) == torch.arange(_N_HANDLERS, device=dev))
    flags = torch.cat([onehot.any(0), torch.stack(
        [reconv.any(), iexit.any()])]).tolist()
    has, any_reconv, any_iexit = flags[:_N_HANDLERS], flags[-2], flags[-1]

    def is_(*ops):
        hit = none
        for o in ops:
            if has[int(o)]:
                hit = hit | onehot[:, int(o)]
        return hit

    guard = _pred_vec(s.preds, p1, NP) & _pred_vec(s.preds, p2, NP)
    execm = amask & (guard.to(_I64) * lane_bits).sum(1)
    ev = (execm.unsqueeze(1) & lane_bits) != 0                    # [N, W]
    has_ex = execm != 0
    pc1 = pc + 1                                 # pc < L: no wrap
    R0 = _lane_reg(s.regs, s0.clamp(min=0), NR)
    first_ex = _first_lane(torch.where(has_ex, execm, amask), W)
    reg_first = R0[rows, first_ex]
    rtop_pc = _take(s.rec_pc, rtop, SD)

    # ---- 3) the handlers of the opcodes present ----------------------------
    # each yields its warps' updates; a field's new value is selected below
    new_pc = pc1                       # ws_pc[top] for the warps in set_pc
    no_set = none                      # instr warps that leave ws_pc[top]
    top_mask, set_mask = amask, none   # ws_mask[top]
    pc_hi, m_hi, push = pc1, amask, none          # ws_[top + 1] (BRA)
    pops, swap_ok = none, none         # ws_top - 1; swap top and top - 1
    bx_idx, bx_new, bx_set = dst, amask, none     # one Bx write a warp
    ok_idx, ok_new, ok_set = dst, none, none      # one Bx-valid write
    rec_new_pc, rec_new_bx, rec_push = imm, dst, none
    wait_add = none                    # waiting |= amask
    err = none
    gone, exits = execm, none          # finished |= gone; Bx lose it
    if has[Op.BRA]:
        bra = is_(Op.BRA)
        taken, ft = execm, amask & (execm ^ M32)
        uniform = (taken == 0) | (ft == 0)
        maj_ft = (_popcount(ft) > _popcount(taken)) if majority_first \
            else none
        bra_div = bra & ~uniform
        new_pc = torch.where(bra & uniform & (taken != 0), imm, new_pc)
        new_pc = torch.where(bra_div, torch.where(maj_ft, imm, pc1), new_pc)
        top_mask = torch.where(maj_ft, taken, ft)
        set_mask = bra_div
        pc_hi = torch.where(maj_ft, pc1, imm)
        m_hi = torch.where(maj_ft, ft, taken)
        push = bra_div
    if has[Op.EXIT]:
        ex_op = is_(Op.EXIT)
        rem = amask & (execm ^ M32)
        done = ex_op & (rem == 0)
        no_set, pops = no_set | done, pops | done
        top_mask = torch.where(ex_op, rem, top_mask)
        set_mask = set_mask | (ex_op & (rem != 0))
        exits = ex_op
    if has[Op.BSSY]:
        bssy = is_(Op.BSSY) & has_ex
        bx_set, ok_set, ok_new = bssy, bssy, bssy
        rec_push = bssy
    if has[Op.BSYNC]:
        bsync = is_(Op.BSYNC)
        b_val = _take(s.bx_val, dst, NB)
        bs_skip = bsync & _take(skip, pc, L) & _take(s.bx_valid, dst, NB) \
            & ((b_val & not_fin) != amask)
        bs_wait = bsync & ~bs_skip & (s.rec_top >= 0) & (rbx == dst)
        bs_park = bsync & ~bs_skip & ~bs_wait
        bx_new = torch.where(bs_skip, b_val & (amask ^ M32), bx_new)
        bx_set = bx_set | bs_skip
        no_set = no_set | bs_wait | bs_park
        pops, wait_add = pops | bs_wait, wait_add | bs_wait
        swap_ok = swap_ok | bs_park
    if has[Op.BMOV_B2R]:
        b2r = is_(Op.BMOV_B2R) & has_ex
        ok_idx = torch.where(b2r, s0, ok_idx)
        ok_set = ok_set | b2r
    if has[Op.BMOV_R2B]:
        r2b = is_(Op.BMOV_R2B) & has_ex
        bx_new = torch.where(r2b, _u32(reg_first) & FULL & not_fin, bx_new)
        bx_set, ok_set = bx_set | r2b, ok_set | r2b
        ok_new = ok_new | r2b
    if has[Op.BREAK]:
        brk = is_(Op.BREAK)
        bx_new = torch.where(brk, _take(s.bx_val, dst, NB) & (execm ^ M32),
                             bx_new)
        bx_set = bx_set | brk
    if has[Op.WARPSYNC]:
        wsync = is_(Op.WARPSYNC)
        m_ws = torch.where(s0 == -1, _u32(imm), _u32(reg_first)) & FULL
        k = torch.arange(SD, device=dev)
        present = ((k.unsqueeze(0) <= s.rec_top.unsqueeze(1))
                   & (s.rec_pc == pc.unsqueeze(1))).any(1)
        free_any = (~s.bx_valid).any(1)
        free = (~s.bx_valid).to(_I32).argmax(1)
        ws_push = wsync & ~present & free_any
        ws_join = wsync & present & (s.rec_top >= 0) & (rtop_pc == pc)
        ws_park = wsync & present & ~ws_join
        err = wsync & ~present & ~free_any
        no_set = no_set | ws_push | ws_join | ws_park
        pops = pops | ws_push | ws_join
        wait_add = wait_add | ws_push | ws_join
        swap_ok = swap_ok | ws_park
        bx_idx = torch.where(ws_push, free, bx_idx)
        bx_new = torch.where(ws_push, m_ws & not_fin, bx_new)
        ok_idx = torch.where(ws_push, free, ok_idx)
        bx_set, ok_set = bx_set | ws_push, ok_set | ws_push
        ok_new = ok_new | ws_push
        rec_new_pc = torch.where(ws_push, pc, rec_new_pc)
        rec_new_bx = torch.where(ws_push, free, rec_new_bx)
        rec_push = rec_push | ws_push
    if has[Op.YIELD]:
        yld = is_(Op.YIELD)
        y_live = _take(s.bx_val, rbx, NB) & not_fin
        ma = _take(s.ws_mask, top, SD)
        mb = _take(s.ws_mask, top - 1, SD)
        swap_ok = swap_ok | (yld & (s.rec_top >= 0) & _take(s.bx_valid, rbx, NB)
                             & (((ma | mb) & (y_live ^ M32)) == 0))
    if has[Op.CALL]:
        new_pc = torch.where(is_(Op.CALL) & has_ex, imm, new_pc)
    if has[Op.RET]:
        new_pc = torch.where(is_(Op.RET) & has_ex, reg_first, new_pc)

    # ---- registers, predicates and memory -----------------------------------
    regs, preds, mem = s.regs, s.preds, s.mem
    alu_ops = [o for o in (Op.MOV, Op.MOVR, Op.IADD, Op.IADDI, Op.IMUL, Op.AND,
                           Op.OR, Op.XOR, Op.SHL, Op.SHR, Op.LANEID, Op.LDG,
                           Op.BMOV_B2R, Op.ATOMCAS, Op.ATOMEXCH, Op.ATOMADD)
               if has[o]]
    atomic_ops = [o for o in (Op.ATOMCAS, Op.ATOMEXCH, Op.ATOMADD)
                  if has[o]]
    mem_ops = atomic_ops + [o for o in (Op.LDG, Op.STG) if has[o]]
    if mem_ops:
        addr = torch.remainder(_i32(R0.to(_I64) + imm.to(_I64).unsqueeze(1))
                               .to(_I64), M)
    if has[Op.ISETP] or has[Op.STG] or alu_ops:
        R1 = _lane_reg(s.regs, s1.clamp(min=0), NR)
    if alu_ops:
        r0, r1 = R0.to(_I64), R1.to(_I64)
        imm_c = imm.to(_I64).unsqueeze(1)
        sh = imm_c & 31
        vals = {Op.MOV: lambda: imm.unsqueeze(1).expand(N, W),
                Op.MOVR: lambda: R0,
                Op.IADD: lambda: _i32(r0 + r1),
                Op.IADDI: lambda: _i32(r0 + imm_c),
                Op.IMUL: lambda: _i32(r0 * r1),
                Op.AND: lambda: R0 & R1, Op.OR: lambda: R0 | R1,
                Op.XOR: lambda: R0 ^ R1,
                Op.SHL: lambda: _i32((r0 & M32) << sh),
                Op.SHR: lambda: _i32((r0 & M32) >> sh),
                Op.LANEID: lambda: s.lane_ids,
                Op.LDG: lambda: s.mem.gather(1, addr),
                Op.BMOV_B2R: lambda: _i32(_take(s.bx_val, s0, NB))
                .unsqueeze(1).expand(N, W)}
        alu = R0
        atomic = is_(Op.ATOMCAS, Op.ATOMEXCH, Op.ATOMADD)
        for o in alu_ops:
            if o in vals:
                alu = torch.where(onehot[:, int(o)].unsqueeze(1), vals[o](),
                                  alu)
        if atomic_ops:
            # lane-serialized, in lane order; a lane's own register row is
            # untouched before its turn, so R0..R2 are the pre-slot values
            R2 = _lane_reg(s.regs, s2.clamp(min=0), NR)
            mem = mem.clone()
            old = torch.zeros((N, W), dtype=_I32, device=dev)
            for t in range(W):
                do = atomic & ev[:, t]
                a = addr[:, t]
                cur = mem[rows, a]
                b = R1[:, t]
                new = torch.where(op == int(Op.ATOMCAS),
                                  torch.where(cur == b, R2[:, t], cur),
                                  torch.where(op == int(Op.ATOMEXCH), b,
                                              _i32(cur.to(_I64) + b)))
                mem[rows, a] = torch.where(do, new, cur)
                old[:, t] = cur
            alu = torch.where(atomic.unsqueeze(1), old, alu)
        upd = is_(*alu_ops)
        if has[Op.BMOV_B2R]:
            upd = upd & ~(onehot[:, int(Op.BMOV_B2R)] & ~has_ex)
        widx = torch.where(atomic, dst.clamp(min=0), dst).to(_I64)
        wr = upd & (widx >= 0) & (widx < NR)
        hit = (wr.unsqueeze(1) & ev).unsqueeze(2) & (
            torch.arange(NR, device=dev) == widx.view(N, 1, 1))
        regs = torch.where(hit, alu.unsqueeze(2), regs)
    if has[Op.STG]:
        # lane order, last writer wins: a lane writes unless a later
        # executing lane of its warp stores to the same address
        stg = is_(Op.STG)
        later = torch.triu(torch.ones(W, W, dtype=_BOOL, device=dev), 1)
        same = (addr.unsqueeze(2) == addr.unsqueeze(1)) & ev.unsqueeze(1) \
            & later.unsqueeze(0)
        writer = stg.unsqueeze(1) & ev & ~same.any(2)
        ext = torch.cat([mem, torch.zeros((N, 1), dtype=_I32, device=dev)], 1)
        ext.scatter_(1, torch.where(writer, addr, M), R1)
        mem = ext[:, :M]
    if has[Op.ISETP]:
        b_cmp = torch.where((s1 == -1).unsqueeze(1),
                            imm.unsqueeze(1).expand(N, W), R1)
        res = _cmp(R0, b_cmp, s2)
        phit = (is_(Op.ISETP).unsqueeze(1) & ev).unsqueeze(2) & (
            torch.arange(NP, device=dev) == dst.view(N, 1, 1).to(_I64))
        preds = torch.where(phit, res.unsqueeze(2), preds)

    # ---- the WS stack: set the top, push above it, swap under it -----------
    set_pc = instr & ~no_set
    ws_pc = _put(s.ws_pc, top, SD, new_pc, set_pc)
    ws_mask = _put(s.ws_mask, top, SD, top_mask, set_mask)
    push_live = reconv & (live != 0)
    if any_reconv or has[Op.BRA]:
        above = s.ws_top + 1
        ws_pc = _put(ws_pc, above, SD, torch.where(
            reconv, _i32(rtop_pc.to(_I64) + 1), pc_hi), push_live | push)
        ws_mask = _put(ws_mask, above, SD, torch.where(reconv, live, m_hi),
                       push_live | push)
    if has[Op.BSYNC] or has[Op.WARPSYNC] or has[Op.YIELD]:
        swap = swap_ok & (s.ws_top >= 1)
        # read after the slot's own write at top (a YIELD's pc + 1)
        under = top - 1
        a, b = _take(ws_pc, top, SD), _take(ws_pc, under, SD)
        ma, mb = _take(ws_mask, top, SD), _take(ws_mask, under, SD)
        ws_pc = _put(_put(ws_pc, top, SD, b, swap), under, SD, a, swap)
        ws_mask = _put(_put(ws_mask, top, SD, mb, swap), under, SD, ma, swap)
    ws_top = (s.ws_top + (push_live | push).to(_I32)
              - (iexit | pops).to(_I32))

    # ---- the REC stack, the Bx file, waiting and finished -------------------
    rec_pc, rec_bx = s.rec_pc, s.rec_bx
    if has[Op.BSSY] or has[Op.WARPSYNC]:
        rec_at = s.rec_top + 1
        rec_pc = _put(rec_pc, rec_at, SD, rec_new_pc, rec_push)
        rec_bx = _put(rec_bx, rec_at, SD, rec_new_bx, rec_push)
    rec_top = s.rec_top + rec_push.to(_I32) - reconv.to(_I32)

    gone = torch.where(iexit, amask, gone)         # threads that exit now
    exits = exits | iexit
    bx_val = s.bx_val
    if has[Op.EXIT] or any_iexit:
        bx_val = torch.where(exits.unsqueeze(1) & s.bx_valid,
                             bx_val & (gone ^ M32).unsqueeze(1), bx_val)
    bx_val = _put(bx_val, bx_idx, NB, bx_new, bx_set)
    ok_idx = torch.where(reconv, rbx, ok_idx)
    bx_valid = _put(s.bx_valid, ok_idx, NB, ok_new, ok_set | reconv)
    waiting = torch.where(reconv, s.waiting & (live ^ M32), s.waiting)
    waiting = torch.where(wait_add, waiting | amask, waiting)
    finished = torch.where(exits, s.finished | gone, s.finished)

    # ---- trace (in place: the one buffer of max_steps a warp) --------------
    at = s.trace_n.to(_I64).clamp(max=s.trace_pc.shape[1] - 1)
    s.trace_pc[rows, at] = torch.where(instr, pc, s.trace_pc[rows, at])
    s.trace_mask[rows, at] = torch.where(instr, _i32(amask),
                                         s.trace_mask[rows, at])
    inc = instr.to(_I32)
    return HanoiState(
        ws_pc=ws_pc, ws_mask=ws_mask, ws_top=ws_top,
        rec_pc=rec_pc, rec_bx=rec_bx, rec_top=rec_top,
        bx_val=bx_val, bx_valid=bx_valid, waiting=waiting, finished=finished,
        regs=regs, preds=preds, mem=mem, lane_ids=s.lane_ids,
        trace_pc=s.trace_pc, trace_mask=s.trace_mask,
        trace_n=s.trace_n + inc, steps=s.steps + inc,
        fuel=s.fuel - run.to(_I32), halted=s.halted | halt,
        error=s.error | (err.to(_I32) * ERR_NO_FREE_BX))


def _run_plain(program: torch.Tensor, state: HanoiState, skip: torch.Tensor,
               cfg: MachineConfig, majority_first: bool) -> HanoiState:
    """Step every warp until each has halted or spent its fuel (the
    reference's ``_run``: the while loop, vmapped)."""
    s = state
    while bool((~s.halted & (s.fuel > 0)).any()):
        s = _step_plain(s, program, skip, cfg, majority_first)
    return s


def hanoi_run_plain(programs, skips, regs, mems, lanes, cfg: MachineConfig,
                    *, majority_first: bool = True,
                    active0: int | None = None) -> HanoiState:
    """K1's plain twin on the operands K1 takes (on any device): the
    initial state, then :func:`_run_plain`."""
    state = init_state(programs.shape[1], cfg, n_warps=programs.shape[0],
                       init_regs=regs, init_mem=mems, lane_ids=lanes,
                       active0=active0, device=programs.device)
    return _run_plain(programs, state, skips, cfg, majority_first)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _skip_vec(L: int, bsync_skip_pcs) -> np.ndarray:
    skip = np.zeros(L, bool)
    for pc in bsync_skip_pcs:
        skip[pc] = True
    return skip


def run_batch(programs, skips, cfg: MachineConfig, *, init_regs=None,
              init_mem=None, lane_ids=None, active0: int | None = None,
              majority_first: bool = True, device=None) -> HanoiState:
    """Run N warps, warp ``i`` on ``programs[i]`` ([N, L, 8], padded to
    one length) with oracle skips ``skips[i]`` ([N, L]), through
    :func:`repro_torch.kernels.ops.hanoi_run`: K1 on the card, the plain
    step on the CPU.  ``init_regs`` [N, W, NR], ``init_mem`` [N, M] and
    ``lane_ids`` [N, W] default to zeros and ``arange(W)``; each may also
    be given for one warp and is then broadcast."""
    from ..device import resolve
    from ..kernels import ops
    dev = resolve(device)
    progs = np.asarray(programs, np.int32)
    N, W = progs.shape[0], cfg.n_threads

    def operand(x, shape, default):
        x = default if x is None else np.asarray(x, np.int32)
        return torch.from_numpy(np.array(
            np.broadcast_to(x.reshape(-1, *shape), (N, *shape)))).to(dev)

    return ops.hanoi_run(
        operand(progs, progs.shape[1:], None),
        torch.from_numpy(np.array(
            np.broadcast_to(np.asarray(skips, bool), progs.shape[:2])))
        .to(dev),
        operand(init_regs, (W, cfg.n_regs),
                np.zeros((W, cfg.n_regs), np.int32)),
        operand(init_mem, (cfg.mem_size,), np.zeros(cfg.mem_size, np.int32)),
        operand(lane_ids, (W,), np.arange(W, dtype=np.int32)),
        cfg, majority_first=majority_first, active0=active0)


def run_hanoi(program: np.ndarray, cfg: MachineConfig = MachineConfig(),
              *, init_regs=None, init_mem=None, lane_ids=None,
              active0: int | None = None, bsync_skip_pcs=(),
              majority_first: bool = True, pad_to: int | None = None,
              device=None) -> HanoiState:
    """Single-warp run (the reference's ``run_hanoi_jax``): a batch of one.

    ``pad_to`` pads the program table with trailing EXITs (unreachable) to
    a fixed length, as the reference does to reuse its compiled program."""
    prog = np.asarray(program, dtype=np.int32)
    if pad_to is not None and prog.shape[0] < pad_to:
        pad = np.zeros((pad_to - prog.shape[0], prog.shape[1]), np.int32)
        pad[:, 0] = int(Op.EXIT)
        prog = np.concatenate([prog, pad], axis=0)
    return run_batch(prog[None], _skip_vec(prog.shape[0], bsync_skip_pcs)[None],
                     cfg, init_regs=init_regs, init_mem=init_mem,
                     lane_ids=lane_ids, active0=active0,
                     majority_first=majority_first, device=device)


def run_warps(program: np.ndarray, cfg: MachineConfig, init_regs: np.ndarray,
              init_mem: np.ndarray, lane_ids: np.ndarray | None = None, *,
              bsync_skip_pcs=(), majority_first: bool = True,
              device=None) -> HanoiState:
    """One program over many warps (the reference's ``run_warps_jax``):
    ``init_regs`` [n_warps, W, NR], ``init_mem`` [n_warps, M] (per-warp
    memories), ``lane_ids`` [n_warps, W]."""
    prog = np.asarray(program, dtype=np.int32)
    n = np.asarray(init_regs).shape[0]
    return run_batch(np.broadcast_to(prog, (n, *prog.shape)),
                     np.broadcast_to(_skip_vec(prog.shape[0], bsync_skip_pcs),
                                     (n, prog.shape[0])),
                     cfg, init_regs=init_regs, init_mem=init_mem,
                     lane_ids=lane_ids, majority_first=majority_first,
                     device=device)


def state_trace(st: HanoiState, i: int = 0) -> list[tuple[int, int]]:
    """Warp ``i``'s ``(pc, mask)`` trace, masks as u32."""
    n = int(st.trace_n[i])
    pcs = st.trace_pc[i, :n].cpu().numpy()
    masks = st.trace_mask[i, :n].cpu().numpy().view(np.uint32)
    return list(zip(pcs.tolist(), masks.tolist()))


def state_deadlocked(st: HanoiState, cfg: MachineConfig, i: int = 0) -> bool:
    return bool((int(st.finished[i]) & cfg.full_mask) != cfg.full_mask
                or int(st.fuel[i]) <= 0)
