"""Dual-Path execution model (Rhu & Erez, HPCA'13) — the paper's SS X
comparison point.

Each stack entry holds TWO concurrently schedulable paths (the two sides of
one divergence) plus the IPDom reconvergence PC; the warp scheduler may
interleave them (we alternate).  This solves same-branch SIMT-induced
deadlocks (the spinlock) WITHOUT Turing's YIELD — but, as the paper argues
(SS X), it cannot support the Turing ISA:

* BREAK needs to edit a reconvergence mask that may be buried in the stack
  (Dual-Path stores masks positionally, not in Bx registers) -> treated as
  NOP here, so earlier-than-IPDom reconvergence is impossible;
* WARPSYNC has no prior BSSY-like marker, so the stack cannot be set up for
  it -> NOP (synchronization semantics silently lost);
* BSSY/BSYNC/BMOV/YIELD likewise have no mechanism -> NOP; reconvergence is
  hard-wired to the IPDom.

`repro.core` uses this model to reproduce the paper's comparative claims:
same architectural results on structured programs, completed spinlocks, but
IPDom-late reconvergence (lower SIMD utilization on Fig-6-like flows) and
broken WARPSYNC guarantees.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .interp import RunResult
from .isa import MachineConfig, Op
from .stepper import ArchState as _ArchState, first_lane, popcount

_NOPS = {Op.BSSY, Op.BSYNC, Op.BMOV_B2R, Op.BMOV_R2B, Op.BREAK,
         Op.WARPSYNC, Op.YIELD}


@dataclass
class _Entry:
    rpc: int                     # IPDom reconvergence pc (-1 for root)
    parent_slot: int             # which slot of the parent spawned us
    pcs: list                    # [pcA or None, pcB or None]
    masks: list                  # [maskA, maskB]
    last: int = 0                # last-scheduled slot (for alternation)

    def live_slots(self):
        return [i for i in (0, 1)
                if self.masks[i] and self.pcs[i] is not None
                and self.pcs[i] != self.rpc]

    def finished(self):
        return all(self.masks[i] == 0 or self.pcs[i] == self.rpc
                   for i in (0, 1))


def run_dual_path(program: np.ndarray,
                  cfg: MachineConfig = MachineConfig(),
                  *, init_regs=None, init_mem=None, lane_ids=None,
                  ipdom: dict[int, int] | None = None,
                  record_trace: bool = True) -> RunResult:
    from .cfg import immediate_postdominators
    prog = np.asarray(program, dtype=np.int64)
    L = prog.shape[0]
    FULL = cfg.full_mask
    st = _ArchState(cfg, init_regs, init_mem, lane_ids)
    if ipdom is None:
        ipdom = immediate_postdominators(prog)

    stack: list[_Entry] = [_Entry(-1, 0, [0, None], [FULL, 0])]
    finished = 0
    trace: list[tuple[int, int]] = []
    fuel = cfg.max_steps
    steps = 0

    def strip(mask):
        for e in stack:
            e.masks = [m & ~mask for m in e.masks]

    while fuel > 0 and stack:
        fuel -= 1
        top = stack[-1]
        # reconvergence: both paths at rpc (or dead) -> merge into parent
        if top.finished():
            stack.pop()
            merged = top.masks[0] | top.masks[1]
            if not stack:
                if merged:
                    # root refill (shouldn't happen: root rpc = -1)
                    stack.append(_Entry(-1, 0, [top.rpc, None], [merged, 0]))
                continue
            parent = stack[-1]
            s = top.parent_slot
            parent.pcs[s] = top.rpc
            parent.masks[s] = merged | (parent.masks[s] & ~FULL)
            continue
        live = top.live_slots()
        if not live:
            # paths stuck at rpc but masks empty handled above; a lone path
            # waiting at rpc with its sibling dead is also 'finished'
            break
        # alternate between the two paths (the Dual-Path scheduler freedom)
        slot = live[0] if len(live) == 1 else (1 - top.last
                                               if (1 - top.last) in live
                                               else live[0])
        top.last = slot
        pc, amask = top.pcs[slot], top.masks[slot]
        if pc < 0 or pc >= L:
            finished |= amask
            strip(amask)
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
                top.pcs[slot] = pc + 1
            elif ft == 0:
                top.pcs[slot] = target
            else:
                r = ipdom.get(pc, -1)
                top.pcs[slot] = r            # this slot waits at the IPDom
                top.masks[slot] = 0          # mass moves to the child entry
                stack.append(_Entry(r, slot, [target, pc + 1], [taken, ft]))
        elif op == Op.EXIT:
            fin = exec_m
            finished |= fin
            strip(fin)
            if top.masks[slot]:
                top.pcs[slot] = pc + 1
        elif op in _NOPS:                    # unsupported Turing instrs
            top.pcs[slot] = pc + 1
        elif op == Op.CALL:
            top.pcs[slot] = f[5] if exec_m else pc + 1
        elif op == Op.RET:
            top.pcs[slot] = (int(st.regs[first_lane(exec_m), f[2]])
                             if exec_m else pc + 1)
        else:
            st.alu(op, f, exec_m)
            top.pcs[slot] = pc + 1

    deadlocked = (finished & FULL) != FULL or fuel <= 0
    return RunResult(st.regs, st.preds, st.mem, finished, steps, deadlocked,
                     None, trace, fuel_left=max(0, fuel))
