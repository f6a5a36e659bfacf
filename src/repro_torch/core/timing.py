"""Trace-driven timing model (the paper's Accel-Sim stand-in).

The paper feeds Hanoi's control-flow traces into Accel-Sim to measure the IPC
impact of trace discrepancies (Fig 10).  Accel-Sim itself is not available in
this environment, so we model the issue structure that matters for *relative*
IPC between two control-flow schedules of the same program:

* one issue slot per cycle per scheduler (Table III: 4 schedulers/SM — we
  model one scheduler; warps are those assigned to it);
* Greedy-Then-Oldest (GTO) warp selection (Table III);
* a warp's next instruction is assumed dependent on its previous one
  (trace-level conservatism): ALU/control = short latency, memory = long;
* SIMD utilization = active threads per issued instruction / warp width.

IPC here counts *thread* instructions (popcount of the active mask), so a
schedule with better reconvergence shows both fewer issue slots and higher
IPC — the paper's BFSD effect (+31.9% SIMD utilization => +83% IPC).

This module is now the *legacy façade*: :func:`schedule_traces` and
:func:`simulate` are thin shims over the event-driven cycle engine in
:mod:`repro.timing` (trace-conservative, single-issue, fixed-latency mode —
bit-identical to the historical loop, which is preserved below as
:func:`schedule_traces_reference`, the differential oracle).  Pass a
:class:`repro.timing.CycleConfig` instead of a :class:`TimingConfig` to get
register-level scoreboards, memory-latency distributions, and dual issue
through the same entry points.

Port of ``repro.core.timing``.  The cycle engine (``repro.timing``) is not
ported yet (ROADMAP.md, open items, item 3): :func:`schedule_traces` and
:func:`simulate` raise ``NotImplementedError`` until it is;
:func:`schedule_traces_reference` and :func:`ipc_delta` work.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .isa import ATOMIC_OPS, F_OP, MEMORY_OPS, Op
from .stepper import popcount


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} runs on the cycle engine repro.timing, which repro_torch has "
        "not ported yet (ROADMAP.md, open items, item 3)")


@dataclass(frozen=True)
class TimingConfig:
    alu_latency: int = 2
    control_latency: int = 1
    memory_latency: int = 30
    atomic_latency: int = 40


@dataclass
class TimingResult:
    """Issue-schedule outcome.  The stall fields are populated by the
    cycle engine (:mod:`repro.timing`); every ratio is guarded so a
    zero-instruction schedule reports 0.0 instead of dividing by zero."""

    cycles: int
    issues: int                 # warp-instructions issued
    thread_instructions: int    # sum of active-mask popcounts
    warp_width: int
    busy_cycles: int = 0
    issue_stall_cycles: int = 0
    scoreboard_stall_cycles: int = 0
    memory_stall_cycles: int = 0

    @property
    def ipc(self) -> float:
        """Thread-level IPC (the paper's Fig 10 metric)."""
        if self.cycles <= 0:
            return 0.0
        return self.thread_instructions / self.cycles

    @property
    def warp_ipc(self) -> float:
        if self.cycles <= 0:
            return 0.0
        return self.issues / self.cycles

    @property
    def simd_utilization(self) -> float:
        denom = self.issues * self.warp_width
        if denom <= 0:
            return 0.0
        return self.thread_instructions / denom

    @property
    def stall_cycles(self) -> int:
        """Idle cycles (no warp could issue); busy + these == cycles when
        the schedule came from the cycle engine."""
        return self.scoreboard_stall_cycles + self.memory_stall_cycles

    @property
    def stall_breakdown(self) -> dict[str, int]:
        return {"issue": self.issue_stall_cycles,
                "scoreboard": self.scoreboard_stall_cycles,
                "memory": self.memory_stall_cycles}


def _latency(op: int, cfg: TimingConfig) -> int:
    if op in ATOMIC_OPS:
        return cfg.atomic_latency
    if op in MEMORY_OPS:
        return cfg.memory_latency
    if op in (Op.BRA, Op.EXIT, Op.BSSY, Op.BSYNC, Op.BMOV_B2R, Op.BMOV_R2B,
              Op.BREAK, Op.WARPSYNC, Op.YIELD, Op.CALL, Op.RET, Op.NOP):
        return cfg.control_latency
    return cfg.alu_latency


def schedule_traces(traces: "list[list[tuple[int, int]]]",
                    prog_ops: "list[np.ndarray]",
                    policy: str = "greedy_then_oldest",
                    cfg: "TimingConfig | object" = TimingConfig(),
                    ) -> tuple[list[tuple[int, int, int]], int, int]:
    """Per-warp traces through one issue port (shim over the cycle engine).

    ``prog_ops`` holds each warp's opcode column (warps may run different
    programs — the per-SM model needs that); full ``[L, N_FIELDS]`` row
    tables are also accepted and are required when ``cfg`` is a scoreboard
    :class:`repro.timing.CycleConfig`.  Returns ``(order, cycles,
    thread_instructions)`` with ``order`` the issued ``(warp, pc, mask)``
    slots.  Policies: ``greedy_then_oldest`` (GTO, Table III),
    ``round_robin``, ``oldest_first`` — see :mod:`repro.timing.policies`.

    With a :class:`TimingConfig` this reproduces
    :func:`schedule_traces_reference` bit-for-bit (differential-tested).
    :func:`simulate` (the Fig 10 IPC model) and
    :func:`repro.engine.mechanisms.sm.interleave_traces` both delegate
    here, so latency semantics cannot drift apart.
    """
    raise _not_ported("schedule_traces")


def schedule_traces_reference(traces: "list[list[tuple[int, int]]]",
                              prog_ops: "list[np.ndarray]",
                              policy: str = "greedy_then_oldest",
                              cfg: TimingConfig = TimingConfig(),
                              ) -> tuple[list[tuple[int, int, int]], int, int]:
    """The historical uniform-cost issue loop, kept verbatim as the
    differential oracle for the cycle engine's trace-conservative mode
    (the role ``levenshtein_dp`` plays for the bit-parallel matcher)."""
    n = len(traces)
    idx = [0] * n
    ready = [0] * n
    lens = [len(t) for t in traces]
    remaining = sum(lens)
    order: list[tuple[int, int, int]] = []
    tinstr = 0
    cycle = 0
    cur = 0
    rr_next = 0
    while remaining:
        if policy == "round_robin":
            cands = [w for w in range(n) if idx[w] < lens[w]]
            ready_now = [w for w in cands if ready[w] <= cycle]
            if not ready_now:
                cycle = min(ready[w] for w in cands)
                ready_now = [w for w in cands if ready[w] <= cycle]
            cur = min(ready_now, key=lambda w: (w - rr_next) % n)
            rr_next = cur + 1
        elif not (idx[cur] < lens[cur] and ready[cur] <= cycle):
            cands = [w for w in range(n) if idx[w] < lens[w]]
            ready_now = [w for w in cands if ready[w] <= cycle]
            if ready_now:
                cur = ready_now[0]
            else:
                cycle = min(ready[w] for w in cands)
                cur = next(w for w in cands if ready[w] <= cycle)
        pc, mask = traces[cur][idx[cur]]
        ops = prog_ops[cur]
        op = int(ops[pc]) if 0 <= pc < len(ops) else int(Op.NOP)
        idx[cur] += 1
        remaining -= 1
        order.append((cur, pc, mask))
        tinstr += popcount(mask)
        ready[cur] = cycle + _latency(op, cfg)
        cycle += 1
    return order, cycle, tinstr


def simulate(traces: list[list[tuple[int, int]]],
             program: np.ndarray,
             warp_width: int,
             cfg: "TimingConfig | object" = TimingConfig()) -> TimingResult:
    """GTO issue simulation over per-warp control-flow traces.

    Shim over :func:`repro.timing.simulate_cycle`: a legacy
    :class:`TimingConfig` runs the exact-compat trace-conservative mode; a
    :class:`repro.timing.CycleConfig` unlocks scoreboards / memory
    distributions / dual issue.  Either way the result carries the stall
    breakdown fields.
    """
    raise _not_ported("simulate (compare's IPC model; pass timing=False)")


def ipc_delta(res_a: TimingResult, res_b: TimingResult) -> float:
    """Relative IPC difference of a vs b (the paper reports |delta| avg)."""
    return (res_a.ipc - res_b.ipc) / max(1e-12, res_b.ipc)
