"""The one instruction-execution path shared by every numpy mechanism.

Historically each reference machine (Hanoi, SIMT-Stack, Dual-Path) carried
its own copy of the mask helpers, predicate resolution, and the ALU —
``interp.py`` owned them and the others imported its privates.  This module
is the extraction: architectural state (:class:`ArchState`), mask helpers,
and — new with the Volta-style per-thread-PC scheduler — a *lane-PC
stepper* (:func:`step_group`) that executes one instruction for a group of
lanes at a common PC and reports per-lane control-flow outcomes, so
stackless mechanisms do not re-implement instruction semantics either.

Division of responsibility:

* this module knows what every instruction DOES to architectural state and
  where each lane WANTS to go next;
* a mechanism (SIMT-Stack, Hanoi, Dual-Path, per-thread-PC, ...) decides
  which lanes issue together and how reconvergence is managed — that is the
  whole design space the paper studies, and the only part mechanisms may
  legitimately differ in.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .isa import (ATOMIC_OPS, CMP_EQ, CMP_GE, CMP_GT, CMP_LE, CMP_LT, CMP_NE,
                  MachineConfig, Op)

_I32 = np.int32


# --------------------------------------------------------------------------
# mask helpers (masks are python ints, thread t <-> bit (1 << t))
# --------------------------------------------------------------------------

def popcount(m: int) -> int:
    return int(m).bit_count()


def first_lane(m: int) -> int:
    """Index of the lowest set bit (first active lane)."""
    assert m, "first_lane of empty mask"
    return (m & -m).bit_length() - 1


def lanes(m: int):
    """Iterate active lane indices, lowest first (atomics serialize this way)."""
    t = 0
    while m:
        if m & 1:
            yield t
        m >>= 1
        t += 1


def mask_vec(m: int, w: int) -> np.ndarray:
    return np.array([(m >> t) & 1 for t in range(w)], dtype=bool)


def vec_mask(v: np.ndarray) -> int:
    return int(sum(1 << t for t, b in enumerate(v) if b))


# --------------------------------------------------------------------------
# predicate / comparison resolution
# --------------------------------------------------------------------------

def _pred_vec(preds: np.ndarray, p: int, w: int) -> np.ndarray:
    if p == 0:
        return np.ones(w, dtype=bool)
    if p > 0:
        return preds[:, p - 1]
    return ~preds[:, -p - 1]


def _cmp(a: np.ndarray, b: np.ndarray, code: int) -> np.ndarray:
    if code == CMP_EQ:
        return a == b
    if code == CMP_NE:
        return a != b
    if code == CMP_LT:
        return a < b
    if code == CMP_LE:
        return a <= b
    if code == CMP_GT:
        return a > b
    if code == CMP_GE:
        return a >= b
    raise ValueError(f"bad cmp code {code}")


# --------------------------------------------------------------------------
# architectural state + ALU
# --------------------------------------------------------------------------

class ArchState:
    """Architectural state shared by all machines."""

    def __init__(self, cfg: MachineConfig, init_regs, init_mem, lane_ids):
        self.cfg = cfg
        w = cfg.n_threads
        self.regs = (np.zeros((w, cfg.n_regs), _I32) if init_regs is None
                     else np.array(init_regs, _I32).reshape(w, cfg.n_regs))
        self.preds = np.zeros((w, cfg.n_preds), dtype=bool)
        self.mem = (np.zeros(cfg.mem_size, _I32) if init_mem is None
                    else np.array(init_mem, _I32).reshape(cfg.mem_size))
        self.lane_ids = (np.arange(w, dtype=_I32) if lane_ids is None
                         else np.array(lane_ids, _I32).reshape(w))

    def exec_mask(self, amask: int, p1: int, p2: int) -> int:
        g = (_pred_vec(self.preds, p1, self.cfg.n_threads)
             & _pred_vec(self.preds, p2, self.cfg.n_threads))
        return amask & vec_mask(g)

    def alu(self, op: int, f, exec_m: int) -> None:
        """Execute a non-control op for lanes in ``exec_m``.  ``f`` = fields."""
        cfg = self.cfg
        ev = mask_vec(exec_m, cfg.n_threads)
        R, M = self.regs, self.mem
        dst, s0, s1, s2, imm = f[1], f[2], f[3], f[4], f[5]
        if op == Op.NOP:
            return
        if op == Op.MOV:
            R[ev, dst] = _I32(imm)
        elif op == Op.MOVR:
            R[ev, dst] = R[ev, s0]
        elif op == Op.IADD:
            R[ev, dst] = R[ev, s0] + R[ev, s1]
        elif op == Op.IADDI:
            R[ev, dst] = R[ev, s0] + _I32(imm)
        elif op == Op.IMUL:
            R[ev, dst] = R[ev, s0] * R[ev, s1]
        elif op == Op.AND:
            R[ev, dst] = R[ev, s0] & R[ev, s1]
        elif op == Op.OR:
            R[ev, dst] = R[ev, s0] | R[ev, s1]
        elif op == Op.XOR:
            R[ev, dst] = R[ev, s0] ^ R[ev, s1]
        elif op == Op.SHL:
            R[ev, dst] = R[ev, s0] << (imm & 31)
        elif op == Op.SHR:
            R[ev, dst] = (R[ev, s0].astype(np.uint32) >> (imm & 31)).astype(_I32)
        elif op == Op.ISETP:
            b = _I32(imm) if s1 == -1 else R[ev, s1]
            self.preds[ev, dst] = _cmp(R[ev, s0], b, s2)
        elif op == Op.LANEID:
            R[ev, dst] = self.lane_ids[ev]
        elif op == Op.LDG:
            addr = (R[ev, s0] + imm) % cfg.mem_size
            R[ev, dst] = M[addr]
        elif op == Op.STG:
            for t in lanes(exec_m):
                M[(int(R[t, s0]) + imm) % cfg.mem_size] = R[t, s1]
        elif op in ATOMIC_OPS:
            for t in lanes(exec_m):
                a = (int(R[t, s0]) + imm) % cfg.mem_size
                old = M[a]
                if op == Op.ATOMCAS:
                    if old == R[t, s1]:
                        M[a] = R[t, s2]
                elif op == Op.ATOMEXCH:
                    M[a] = R[t, s1]
                else:  # ATOMADD
                    M[a] = _I32(int(old) + int(R[t, s1]))
                R[t, dst] = old
        else:
            raise ValueError(f"alu cannot handle op {Op(op).name}")


# --------------------------------------------------------------------------
# lane-PC stepper: per-lane control-flow outcomes for stackless mechanisms
# --------------------------------------------------------------------------

@dataclass
class GroupOutcome:
    """What happened when a group of lanes issued one instruction together.

    ``next_pcs`` gives each surviving lane's next PC (lanes that retired via
    EXIT appear in ``exited`` instead).  ``sync_mask`` is set for WARPSYNC:
    the issuing mechanism must hold the executing lanes at this PC until
    every unfinished lane named in the mask has arrived (however the
    mechanism chooses to represent "arrived").
    """

    next_pcs: dict[int, int] = field(default_factory=dict)
    exited: int = 0
    sync_mask: int | None = None
    sync_lanes: int = 0          # the subset of the group that must wait


#: Convergence-management ops that are no-ops on a per-thread-PC machine:
#: there is no reconvergence stack to maintain, so BSSY/BSYNC bracketing,
#: Bx spills and BREAK mask edits have nothing to act on, and YIELD's
#: "switch to the sibling path" is subsumed by the fair scheduler.
STACKLESS_NOPS = frozenset({Op.BSSY, Op.BSYNC, Op.BMOV_B2R, Op.BMOV_R2B,
                            Op.BREAK, Op.YIELD})


def step_group(prog: np.ndarray, st: ArchState, pc: int, group: int,
               *, full_mask: int) -> GroupOutcome:
    """Execute the instruction at ``pc`` for the lanes in ``group``.

    Architectural effects (ALU, memory, atomics, predicates) are applied to
    ``st`` exactly as on every other machine — this is the shared execution
    path.  Control flow is reported *per lane* so a per-thread-PC mechanism
    can scatter the group; stack mechanisms use their own aggregate handling
    and only share :class:`ArchState`.
    """
    out = GroupOutcome()
    L = prog.shape[0]
    if pc < 0 or pc >= L:            # fell off the program: implicit EXIT
        out.exited = group
        return out
    f = tuple(int(v) for v in prog[pc])
    op = f[0]
    exec_m = st.exec_mask(group, f[6], f[7])

    if op == Op.BRA:
        target = f[5]
        for t in lanes(group):
            out.next_pcs[t] = target if (exec_m >> t) & 1 else pc + 1
    elif op == Op.EXIT:
        out.exited = exec_m
        for t in lanes(group & ~exec_m):     # predicated-off lanes continue
            out.next_pcs[t] = pc + 1
    elif op == Op.WARPSYNC:
        m = (f[5] if f[2] == -1
             else int(st.regs[first_lane(exec_m or group), f[2]])) & full_mask
        out.sync_mask = m
        out.sync_lanes = exec_m
        for t in lanes(group & ~exec_m):     # predicated-off lanes skip it
            out.next_pcs[t] = pc + 1
        for t in lanes(exec_m):              # released lanes resume after it
            out.next_pcs[t] = pc + 1
    elif op == Op.CALL:
        for t in lanes(group):
            out.next_pcs[t] = f[5] if (exec_m >> t) & 1 else pc + 1
    elif op == Op.RET:
        for t in lanes(group):               # indirect: per-lane register
            out.next_pcs[t] = (int(st.regs[t, f[2]]) if (exec_m >> t) & 1
                               else pc + 1)
    elif op in STACKLESS_NOPS:
        for t in lanes(group):
            out.next_pcs[t] = pc + 1
    else:
        st.alu(op, f, exec_m)
        for t in lanes(group):
            out.next_pcs[t] = pc + 1
    return out
