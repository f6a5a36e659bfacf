"""Reference interpreters for SASS-lite warps.

Three machines, all operating on the same ``int32[L, 8]`` program tables:

* :func:`run_hanoi`       — the paper's Hanoi mechanism (SS VII): WS stack +
  REC stack + Bx registers + waiting/finished masks.
* :func:`run_simt_stack`  — the pre-Volta SIMT-Stack baseline (SS II) with
  compile-time IPDom reconvergence; BSSY/BSYNC/BREAK/BMOV/WARPSYNC/YIELD are
  treated as NOPs (they do not exist pre-Volta).
* Turing "oracle" mode    — ``run_hanoi(..., bsync_skip_pcs=...)``: Hanoi plus
  the runtime heuristic the paper attributes to real hardware (SS IX): at
  annotated BSYNCs the hardware may *ignore* the reconvergence instead of
  waiting.  Skipping threads are implicitly BREAK-ed out of the mask so late
  arrivals still sync among themselves (deadlock-free by construction).

This module is the executable semantics; the vectorized JAX engine in
``repro.core.hanoi`` is property-tested for exact equivalence against it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .isa import MachineConfig, Op
# The instruction-execution path (mask helpers, predicate resolution,
# architectural state + ALU) lives in repro.core.stepper and is shared by
# every numpy mechanism; the names are re-exported here because this module
# defined them historically.
from .stepper import (ArchState as _ArchState, _cmp, _pred_vec,  # noqa: F401
                      first_lane, lanes, mask_vec, popcount, vec_mask)


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------

@dataclass
class RunResult:
    regs: np.ndarray            # int32[W, NR] final register file
    preds: np.ndarray           # bool [W, NP]
    mem: np.ndarray             # int32[M]
    finished: int               # mask of threads that executed EXIT
    steps: int                  # scheduler slots consumed
    deadlocked: bool            # fuel exhausted or threads stuck waiting
    error: str | None           # structural error (Bx exhaustion, ...)
    trace: list[tuple[int, int]] = field(default_factory=list)  # (pc, mask)
    fuel_left: int = -1         # scheduler-slot budget remaining (-1: unknown)

    @property
    def out_of_fuel(self) -> bool:
        """True when the run stopped because the fuel budget expired (as
        opposed to a structural deadlock with fuel to spare).  The trace is
        truncated at the last fueled slot — identical across the numpy and
        JAX engines (property-tested)."""
        return self.fuel_left == 0

    def trace_tokens(self) -> np.ndarray:
        """Encode the control-flow trace as int64 tokens for Levenshtein."""
        return np.array([(pc << 32) | m for pc, m in self.trace],
                        dtype=np.int64)

    @property
    def sim_util(self) -> float:
        """SIMD-lane utilization over the trace (active threads / issued)."""
        if not self.trace:
            return 0.0
        w = max(1, max(popcount(m) for _, m in self.trace))
        # width inferred poorly from trace alone; caller usually recomputes
        return float(sum(popcount(m) for _, m in self.trace)) / (
            len(self.trace) * w)


def simd_utilization(trace: list[tuple[int, int]], w: int) -> float:
    if not trace:
        return 0.0
    return sum(popcount(m) for _, m in trace) / (len(trace) * w)


_I32 = np.int32


# --------------------------------------------------------------------------
# Hanoi (paper SS VII) + Turing-oracle heuristic (SS IX)
# --------------------------------------------------------------------------

def run_hanoi(program: np.ndarray,
              cfg: MachineConfig = MachineConfig(),
              *,
              init_regs=None, init_mem=None, lane_ids=None,
              active0: int | None = None,
              majority_first: bool = True,
              bsync_skip_pcs: frozenset[int] | tuple = (),
              record_trace: bool = True) -> RunResult:
    prog = np.asarray(program, dtype=np.int64)
    L = prog.shape[0]
    W, NB, FULL = cfg.n_threads, cfg.n_bx, cfg.full_mask
    st = _ArchState(cfg, init_regs, init_mem, lane_ids)
    skip_pcs = frozenset(bsync_skip_pcs)

    ws: list[list[int]] = [[0, FULL if active0 is None else active0]]  # [pc, mask]
    rec: list[list[int]] = []                                          # [pc, bx]
    bx_val = [0] * NB
    bx_valid = [False] * NB
    waiting = 0
    finished = 0
    error: str | None = None
    trace: list[tuple[int, int]] = []

    fuel = cfg.max_steps
    steps = 0
    while fuel > 0:
        fuel -= 1
        # 1) reconvergence check first (SS VII-B): REC top ready -> reconverge.
        if rec:
            rpc, b = rec[-1]
            if bx_valid[b]:
                live = bx_val[b] & ~finished
                if (live & ~waiting) == 0:
                    rec.pop()
                    bx_valid[b] = False
                    waiting &= ~live
                    if live:
                        ws.append([rpc + 1, live])
                    continue
        if not ws:
            break
        pc, amask = ws[-1]
        if pc < 0 or pc >= L:           # fell off program: implicit EXIT
            finished |= amask
            for x in range(NB):
                if bx_valid[x]:
                    bx_val[x] &= ~amask
            ws.pop()
            continue

        f = tuple(int(v) for v in prog[pc])
        op = f[0]
        exec_m = st.exec_mask(amask, f[6], f[7])
        if record_trace:
            trace.append((pc, amask))
        steps += 1

        if op == Op.BRA:
            target = f[5]
            taken, ft = exec_m, amask & ~exec_m
            if taken == 0:
                ws[-1][0] = pc + 1
            elif ft == 0:
                ws[-1][0] = target
            else:
                ws.pop()
                ent_t, ent_f = [target, taken], [pc + 1, ft]
                # SS VII-C: the majority path executes first (ties: taken).
                if majority_first and popcount(ft) > popcount(taken):
                    first, second = ent_f, ent_t
                else:
                    first, second = ent_t, ent_f
                ws.append(second)
                ws.append(first)
        elif op == Op.EXIT:
            fin = exec_m
            finished |= fin
            for x in range(NB):             # SS VII-A: strip finished threads
                if bx_valid[x]:
                    bx_val[x] &= ~fin
            rem = amask & ~fin
            if rem == 0:
                ws.pop()
            else:                            # predicated-off threads continue
                ws[-1] = [pc + 1, rem]
        elif op == Op.BSSY:
            if exec_m:
                b = f[1]
                bx_val[b] = amask
                bx_valid[b] = True
                rec.append([f[5], b])
            ws[-1][0] = pc + 1
        elif op == Op.BSYNC:
            b = f[1]
            if (pc in skip_pcs and bx_valid[b]
                    and (bx_val[b] & ~finished) != amask):
                # Turing-oracle heuristic: ignore the reconvergence; the
                # skipping subset is implicitly BREAK-ed out of the mask so
                # the remaining threads still sync among themselves.
                bx_val[b] &= ~amask
                ws[-1][0] = pc + 1
            elif rec and rec[-1][1] == b:
                ws.pop()
                waiting |= amask
            else:
                # The waiting mask only tracks the TOP REC entry (Fig 8);
                # a path reaching a deeper sync point parks: retry after the
                # sibling (swap), or spin if it is the only path.  If no
                # progress is possible this drains the fuel -> deadlock,
                # exactly the paper's Fig 6 without-BREAK scenario.
                if len(ws) >= 2:
                    ws[-1], ws[-2] = ws[-2], ws[-1]
        elif op == Op.WARPSYNC:
            m = (f[5] if f[2] == -1
                 else int(st.regs[first_lane(exec_m or amask), f[2]])) & FULL
            if not any(e[0] == pc for e in rec):     # first arriving subset
                free = next((x for x in range(NB) if not bx_valid[x]), None)
                if free is None:
                    error = error or "WARPSYNC: no free Bx register"
                    ws[-1][0] = pc + 1
                    continue
                bx_val[free] = m & ~finished
                bx_valid[free] = True
                rec.append([pc, free])
                ws.pop()
                waiting |= amask
            elif rec and rec[-1][0] == pc:
                ws.pop()
                waiting |= amask
            else:                                    # deeper entry: park
                if len(ws) >= 2:
                    ws[-1], ws[-2] = ws[-2], ws[-1]
        elif op == Op.BREAK:
            bx_val[f[1]] &= ~exec_m
            ws[-1][0] = pc + 1
        elif op == Op.BMOV_B2R:
            if exec_m:
                ev = mask_vec(exec_m, W)
                # reconvergence masks are unsigned; wrap into the i32 regfile
                st.regs[ev, f[1]] = np.int64(bx_val[f[2]]).astype(_I32)
                bx_valid[f[2]] = False        # spill invalidates (SS VII-A)
            ws[-1][0] = pc + 1
        elif op == Op.BMOV_R2B:
            if exec_m:
                v = int(st.regs[first_lane(exec_m), f[2]])
                bx_val[f[1]] = v & FULL & ~finished   # strip finished on fill
                bx_valid[f[1]] = True
            ws[-1][0] = pc + 1
        elif op == Op.YIELD:
            ws[-1][0] = pc + 1                 # resume after YIELD (SS VI-C)
            if len(ws) >= 2 and rec:
                rpc, b = rec[-1]
                if bx_valid[b]:
                    live = bx_val[b] & ~finished
                    if ((ws[-1][1] | ws[-2][1]) & ~live) == 0:  # siblings
                        ws[-1], ws[-2] = ws[-2], ws[-1]
        elif op == Op.CALL:
            ws[-1][0] = f[5] if exec_m else pc + 1
        elif op == Op.RET:
            ws[-1][0] = (int(st.regs[first_lane(exec_m), f[2]])
                         if exec_m else pc + 1)
        else:
            st.alu(op, f, exec_m)
            ws[-1][0] = pc + 1

    deadlocked = (finished & FULL) != FULL
    if fuel <= 0:
        deadlocked = True
    return RunResult(st.regs, st.preds, st.mem, finished, steps, deadlocked,
                     error, trace, fuel_left=max(0, fuel))


# --------------------------------------------------------------------------
# pre-Volta SIMT-Stack baseline (SS II)
# --------------------------------------------------------------------------

def run_simt_stack(program: np.ndarray,
                   cfg: MachineConfig = MachineConfig(),
                   *,
                   init_regs=None, init_mem=None, lane_ids=None,
                   ipdom: dict[int, int] | None = None,
                   record_trace: bool = True) -> RunResult:
    """Classic single-stack machine with IPDom reconvergence.

    Entries are ``[pc, rpc, mask]``; a divergent branch converts the top entry
    into the reconvergence entry at the IPDom and pushes both paths (taken
    executes first, as in the paper's Fig 1).  Post-Volta instructions are
    NOPs.  SIMT-induced deadlocks (SS III) manifest as fuel exhaustion.
    """
    from .cfg import immediate_postdominators
    prog = np.asarray(program, dtype=np.int64)
    L = prog.shape[0]
    W, FULL = cfg.n_threads, cfg.full_mask
    st = _ArchState(cfg, init_regs, init_mem, lane_ids)
    if ipdom is None:
        ipdom = immediate_postdominators(prog)

    NOPS = {Op.BSSY, Op.BSYNC, Op.BMOV_B2R, Op.BMOV_R2B, Op.BREAK,
            Op.WARPSYNC, Op.YIELD}
    stack: list[list[int]] = [[0, -1, FULL]]
    finished = 0
    trace: list[tuple[int, int]] = []
    fuel = cfg.max_steps
    steps = 0
    error = None

    while fuel > 0 and stack:
        fuel -= 1
        # reconvergence: pop entries whose pc reached their rpc or died out
        pc, rpc, amask = stack[-1]
        if amask == 0 or (rpc >= 0 and pc == rpc):
            stack.pop()
            continue
        if pc < 0 or pc >= L:
            finished |= amask
            stack.pop()
            continue

        f = tuple(int(v) for v in prog[pc])
        op = f[0]
        exec_m = st.exec_mask(amask, f[6], f[7])
        if record_trace:
            trace.append((pc, amask))
        steps += 1

        if op == Op.BRA:
            target = f[5]
            taken, ft = exec_m, amask & ~exec_m
            if taken == 0:
                stack[-1][0] = pc + 1
            elif ft == 0:
                stack[-1][0] = target
            else:
                r = ipdom.get(pc, -1)
                stack[-1] = [r, rpc, amask]      # reconvergence entry
                stack.append([pc + 1, r, ft])    # not-taken
                stack.append([target, r, taken])  # taken executes first (Fig 1)
        elif op == Op.EXIT:
            fin = exec_m
            finished |= fin
            for e in stack:                      # drop finished everywhere
                e[2] &= ~fin
            if stack[-1][2] != 0:
                stack[-1][0] = pc + 1
        elif op in NOPS:
            stack[-1][0] = pc + 1
        elif op == Op.CALL:
            stack[-1][0] = f[5] if exec_m else pc + 1
        elif op == Op.RET:
            stack[-1][0] = (int(st.regs[first_lane(exec_m), f[2]])
                            if exec_m else pc + 1)
        else:
            st.alu(op, f, exec_m)
            stack[-1][0] = pc + 1

    deadlocked = (finished & FULL) != FULL or fuel <= 0
    return RunResult(st.regs, st.preds, st.mem, finished, steps, deadlocked,
                     error, trace, fuel_left=max(0, fuel))


# --------------------------------------------------------------------------
# per-thread scalar reference (the architectural-semantics oracle)
# --------------------------------------------------------------------------

def run_reference(program: np.ndarray,
                  cfg: MachineConfig = MachineConfig(),
                  *,
                  init_regs=None, init_mem=None) -> RunResult:
    """Execute each thread to completion, one at a time, sharing memory.

    For data-race-free programs this is the architectural ground truth any
    control-flow-management mechanism must match (the paper's correctness
    criterion).  Programs that *require* inter-thread interleaving (spinlocks)
    are out of scope here by construction — they are validated behaviorally.
    """
    W = cfg.n_threads
    scfg = cfg._replace(n_threads=1)
    regs = (np.zeros((W, cfg.n_regs), _I32) if init_regs is None
            else np.array(init_regs, _I32))
    mem = (np.zeros(cfg.mem_size, _I32) if init_mem is None
           else np.array(init_mem, _I32))
    out_regs = np.zeros_like(regs)
    out_preds = np.zeros((W, cfg.n_preds), dtype=bool)
    finished = 0
    deadlocked = False
    steps = 0
    fuel_left = cfg.max_steps
    for t in range(W):
        r = run_hanoi(program, scfg, init_regs=regs[t:t + 1], init_mem=mem,
                      lane_ids=np.array([t], _I32), record_trace=False)
        out_regs[t] = r.regs[0]
        out_preds[t] = r.preds[0]
        mem = r.mem
        steps += r.steps
        deadlocked |= r.deadlocked
        fuel_left = min(fuel_left, r.fuel_left)
        if r.finished:
            finished |= (1 << t)
    return RunResult(out_regs, out_preds, mem, finished, steps, deadlocked,
                     None, [], fuel_left=fuel_left)
