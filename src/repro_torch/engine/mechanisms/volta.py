"""``volta_itps`` — Volta-style independent thread scheduling (ITS).

Port of ``repro.engine.mechanisms.volta`` (numpy only, copied).

Post-Volta NVIDIA GPUs abandoned the single-PC-per-warp model: every lane
carries its own PC (plus call stack), and a *convergence optimizer* in the
scheduler opportunistically regroups lanes that sit at the same PC so SIMD
lanes are still shared ("Analyzing Modern NVIDIA GPU cores", arXiv
2503.20481, SS II-B; CUDA's independent-thread-scheduling contract).  The
two properties this mechanism reproduces:

* **no reconvergence stack** — BSSY/BSYNC bracketing, Bx registers, BREAK
  mask edits and YIELD are no-ops (:data:`~repro_torch.core.stepper.STACKLESS_NOPS`);
  reconvergence happens exactly when diverged lanes happen to reach a
  common PC and the optimizer merges them into one issue group;
* **a forward-progress guarantee** — the scheduler may favor wide groups,
  but every runnable lane is issued within a bounded number of slots
  (``itps_patience``).  This is what makes the paper's Fig 3 spinlock — and
  its YIELD-less SS V-G ablation, which deadlocks both the pre-Volta
  SIMT-Stack and Hanoi — terminate here: the lock holder's singleton group
  is eventually scheduled no matter how wide the spinning group is.

Scheduling policy ("greedy convergence optimizer with aging"): each slot,
group runnable lanes by PC and issue the widest group (ties: lowest PC —
lagging lanes catch up toward reconvergence points); but if some runnable
lane has been starved for ``itps_patience`` slots, its group is issued
instead.  WARPSYNC is the one instruction with real synchronization
semantics on this machine: executing lanes park at the sync PC until every
unfinished lane named in the mask has arrived (finished lanes count as
arrived), and a rendezvous that can never assemble is reported as a
*structural* ``DEADLOCK`` (fuel to spare), not fuel exhaustion.

Request options (``SimRequest.meta``):

* ``itps_patience`` (int, default 8) — the starvation bound, in slots.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.interp import RunResult, simd_utilization
from repro_torch.core.isa import MachineConfig
from repro_torch.core.stepper import ArchState, lanes, popcount, step_group

from ..adapters import result_from_runresult
from ..registry import register_mechanism
from ..types import SimRequest, SimResult

DEFAULT_PATIENCE = 8


def run_volta_itps(program: np.ndarray,
                   cfg: MachineConfig = MachineConfig(),
                   *,
                   init_regs=None, init_mem=None, lane_ids=None,
                   active0: int | None = None,
                   patience: int = DEFAULT_PATIENCE,
                   record_trace: bool = True) -> RunResult:
    """Run one warp under independent thread scheduling; see module doc."""
    prog = np.asarray(program, dtype=np.int64)
    L = prog.shape[0]
    W, FULL = cfg.n_threads, cfg.full_mask
    st = ArchState(cfg, init_regs, init_mem, lane_ids)
    patience = max(1, int(patience))

    active = FULL if active0 is None else (active0 & FULL)
    pcs = [0] * W
    finished = 0
    blocked = 0                      # lanes parked at a WARPSYNC rendezvous
    syncs: dict[int, int] = {}       # sync pc -> required mask
    resume: dict[int, int] = {}      # parked lane -> pc to resume at
    last_issue = [0] * W
    trace: list[tuple[int, int]] = []

    def retire(mask: int) -> None:
        nonlocal finished
        finished |= mask

    def release_ready_syncs() -> None:
        """Unpark every rendezvous whose mask has fully arrived (finished
        lanes count as arrived — they can never get there)."""
        nonlocal blocked
        for spc in list(syncs):
            need = syncs[spc] & active & ~finished
            parked_here = sum(1 << t for t in lanes(blocked)
                              if pcs[t] == spc)
            if need & ~parked_here:
                continue             # someone named in the mask is still out
            for t in lanes(parked_here):
                pcs[t] = resume.pop(t, spc + 1)
            blocked &= ~parked_here
            del syncs[spc]

    fuel = cfg.max_steps
    steps = 0
    while fuel > 0:
        # retire lanes that fell off the program (implicit EXIT, no slot)
        off = sum(1 << t for t in lanes(active & ~finished & ~blocked)
                  if not 0 <= pcs[t] < L)
        if off:
            retire(off)
            release_ready_syncs()
        runnable = active & ~finished & ~blocked
        if not runnable:
            break                    # all done, or a structural deadlock

        # --- convergence optimizer: group runnable lanes by PC -------------
        groups: dict[int, int] = {}
        for t in lanes(runnable):
            groups[pcs[t]] = groups.get(pcs[t], 0) | (1 << t)

        # --- pick a group: greedy-widest with a progress guarantee ---------
        starved = min(lanes(runnable), key=lambda t: last_issue[t])
        if steps - last_issue[starved] >= patience:
            pc = pcs[starved]
        else:
            pc = max(groups, key=lambda p: (popcount(groups[p]), -p))
        gmask = groups[pc]

        fuel -= 1
        steps += 1
        if record_trace:
            trace.append((pc, gmask))
        for t in lanes(gmask):
            last_issue[t] = steps

        out = step_group(prog, st, pc, gmask, full_mask=FULL)
        if out.exited:
            retire(out.exited)
        for t, npc in out.next_pcs.items():
            pcs[t] = npc
        if out.sync_mask is not None and out.sync_lanes:
            # park the executing lanes AT the sync pc; their post-release
            # pcs were reported by the stepper.  Divergent register-operand
            # masks at one pc (UB on real hardware) UNION rather than
            # overwrite: conservative — a rendezvous can only get harder to
            # assemble, never spuriously release earlier arrivals
            syncs[pc] = syncs.get(pc, 0) | out.sync_mask
            for t in lanes(out.sync_lanes):
                resume[t] = out.next_pcs.get(t, pc + 1)
                pcs[t] = pc
            blocked |= out.sync_lanes
        release_ready_syncs()

    deadlocked = (finished & FULL) != FULL or fuel <= 0
    return RunResult(st.regs, st.preds, st.mem, finished, steps, deadlocked,
                     None, trace, fuel_left=max(0, fuel))


@register_mechanism(
    "volta_itps", backend="numpy", tags=("post-volta", "per-thread-pc"),
    description="Volta-style independent thread scheduling: per-lane PCs, "
                "no reconvergence stack, greedy convergence optimizer with "
                "a forward-progress guarantee (spinlocks terminate without "
                "YIELD)")
def _run_volta_itps(req: SimRequest) -> SimResult:
    cfg = req.resolved_cfg()
    t0 = time.perf_counter()
    r = run_volta_itps(
        req.program, cfg, init_regs=req.init_regs, init_mem=req.init_mem,
        lane_ids=req.lane_ids, active0=req.active0,
        patience=int(req.meta.get("itps_patience", DEFAULT_PATIENCE)),
        record_trace=req.record_trace)
    return result_from_runresult("volta_itps", r, req,
                                 time.perf_counter() - t0)


# re-exported for callers that want the raw engine (tests, benchmarks)
__all__ = ["run_volta_itps", "DEFAULT_PATIENCE"]
