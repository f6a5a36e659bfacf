"""Event-driven, cycle-level SM issue model (the Fig 10 engine).

Port of ``repro.timing.sm_model`` (numpy only, copied).

The legacy Fig 10 model (:mod:`repro_torch.core.timing`) charged every
instruction a class latency and assumed each instruction depends on its
predecessor — trace-level conservatism.  This module is the real model
underneath: per-warp **scoreboards** with register/predicate dependence
checks, **configurable memory-latency distributions** (fixed / uniform /
bimodal hit-miss, deterministically seeded), an optional **dual-issue**
port, and pluggable issue policies (:mod:`repro_torch.timing.policies`).  Time
advances through an :class:`~repro_torch.timing.events.EventQueue` of completion
events — idle gaps are skipped in one hop, never walked cycle by cycle.

Dependence modes
----------------
``CycleConfig.scoreboard`` selects the hazard model:

* ``scoreboard=False`` — *trace conservatism*: a warp's next instruction
  waits for its previous one.  With ``issue_width=1`` and the ``fixed``
  memory model this reproduces the legacy
  :func:`repro_torch.core.timing.schedule_traces` loop **bit-for-bit** (the
  legacy functions are now shims over this engine; a differential test
  gates the equivalence).  Programs may be given as opcode columns.
* ``scoreboard=True`` — register-level dependence: an instruction issues
  once its source and destination registers/predicates have no outstanding
  writes (RAW + WAW; WAR is safe under in-order issue with read-at-issue).
  Requires full ``int32[L, N_FIELDS]`` program rows.

Stall taxonomy (see ``docs/timing.md``)
---------------------------------------
Every cycle is either *busy* (>= 1 instruction issued) or a stall cycle:

* ``memory_stall_cycles``     — no warp could issue and the earliest
  blocked warp waits on an in-flight memory/atomic producer;
* ``scoreboard_stall_cycles`` — no warp could issue and the earliest
  blocked warp waits on a short-latency (ALU/control) producer;
* ``issue_stall_cycles``      — cycles where at least one *ready* warp was
  left unissued because the issue port was full (port contention; overlaps
  busy cycles, so it is reported separately from the partition).

Invariant: ``cycles == busy_cycles + scoreboard_stall_cycles +
memory_stall_cycles``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core.isa import (ATOMIC_OPS, F_DST, F_OP, F_PRED1, F_PRED2,
                            F_SRC0, F_SRC1, F_SRC2, MEMORY_OPS, Op)
from repro_torch.core.stepper import popcount

from .events import EventQueue
from .policies import get_policy, resolve_policy_name

__all__ = ["CycleConfig", "CycleResult", "instr_deps", "schedule_cycle",
           "simulate_cycle"]

_MEMORY_MODELS = ("fixed", "uniform", "bimodal")


@dataclass(frozen=True)
class CycleConfig:
    """Latency + structure configuration for the cycle-level SM model.

    The four class latencies mirror the legacy
    :class:`~repro_torch.core.timing.TimingConfig`.  ``memory_model`` selects how
    LDG/STG latency is drawn (atomics always pay ``atomic_latency`` — the
    L2 round trip has no hit path):

    * ``fixed``   — every access costs ``memory_latency``;
    * ``uniform`` — integer-uniform in ``[memory_latency_lo,
      memory_latency_hi]``;
    * ``bimodal`` — ``memory_hit_latency`` with probability
      ``memory_hit_rate``, else ``memory_latency`` (an L1 hit/miss mix).

    Draws come from ``numpy.random.default_rng(seed)`` consumed in issue
    order, so a fixed config is fully deterministic (property-tested).
    ``issue_width`` > 1 enables dual issue: up to that many independent
    instructions per cycle, possibly back-to-back from one warp.
    """

    alu_latency: int = 2
    control_latency: int = 1
    memory_latency: int = 30
    atomic_latency: int = 40
    memory_model: str = "fixed"
    memory_latency_lo: int = 10
    memory_latency_hi: int = 60
    memory_hit_latency: int = 8
    memory_hit_rate: float = 0.6
    seed: int = 0
    issue_width: int = 1
    scoreboard: bool = True

    def __post_init__(self) -> None:
        if self.memory_model not in _MEMORY_MODELS:
            raise ValueError(f"unknown memory_model {self.memory_model!r}; "
                             f"known: {_MEMORY_MODELS}")
        if self.issue_width < 1:
            raise ValueError(f"issue_width must be >= 1, "
                             f"got {self.issue_width}")
        if self.memory_latency_lo > self.memory_latency_hi:
            raise ValueError("memory_latency_lo > memory_latency_hi")
        if not 0.0 <= self.memory_hit_rate <= 1.0:
            raise ValueError(f"memory_hit_rate must be in [0, 1], "
                             f"got {self.memory_hit_rate}")

    @classmethod
    def from_timing(cls, cfg: Any, *, scoreboard: bool = False,
                    issue_width: int = 1) -> "CycleConfig":
        """Lift a legacy ``TimingConfig`` (or pass a CycleConfig through).

        The default (``scoreboard=False``, single issue, fixed memory) is
        the exact-compatibility mode the :mod:`repro_torch.core.timing` shims
        use; ``scoreboard=True`` is the realistic lift ``timing="cycle"``
        evaluation paths use.
        """
        if isinstance(cfg, cls):
            return cfg
        return cls(alu_latency=cfg.alu_latency,
                   control_latency=cfg.control_latency,
                   memory_latency=cfg.memory_latency,
                   atomic_latency=cfg.atomic_latency,
                   scoreboard=scoreboard, issue_width=issue_width)


def _memory_sampler(cfg: CycleConfig) -> Callable[[], int]:
    if cfg.memory_model == "fixed":
        lat = int(cfg.memory_latency)
        return lambda: lat
    rng = np.random.default_rng(cfg.seed)
    if cfg.memory_model == "uniform":
        lo, hi = int(cfg.memory_latency_lo), int(cfg.memory_latency_hi)
        return lambda: int(rng.integers(lo, hi + 1))
    hit, miss = int(cfg.memory_hit_latency), int(cfg.memory_latency)
    rate = float(cfg.memory_hit_rate)
    return lambda: hit if rng.random() < rate else miss


_CONTROL_LAT_OPS = frozenset({
    Op.BRA, Op.EXIT, Op.BSSY, Op.BSYNC, Op.BMOV_B2R, Op.BMOV_R2B,
    Op.BREAK, Op.WARPSYNC, Op.YIELD, Op.CALL, Op.RET, Op.NOP,
})

# (register-read fields, register-write fields) per opcode; predicates and
# conditional fields are handled in instr_deps.  Bx registers are control
# state, not scoreboarded (their hazards are what BSSY/BSYNC *are*).
_REG_READS = {
    Op.MOVR: (F_SRC0,), Op.IADDI: (F_SRC0,), Op.SHL: (F_SRC0,),
    Op.SHR: (F_SRC0,),
    Op.IADD: (F_SRC0, F_SRC1), Op.IMUL: (F_SRC0, F_SRC1),
    Op.AND: (F_SRC0, F_SRC1), Op.OR: (F_SRC0, F_SRC1),
    Op.XOR: (F_SRC0, F_SRC1),
    Op.ISETP: (F_SRC0,),           # + F_SRC1 unless it encodes "imm" (-1)
    Op.LDG: (F_SRC0,),
    Op.STG: (F_SRC0, F_SRC1),
    Op.ATOMCAS: (F_SRC0, F_SRC1, F_SRC2),
    Op.ATOMEXCH: (F_SRC0, F_SRC1), Op.ATOMADD: (F_SRC0, F_SRC1),
    Op.BMOV_R2B: (F_SRC0,), Op.RET: (F_SRC0,),
}
_REG_WRITES = frozenset({
    Op.MOV, Op.MOVR, Op.IADD, Op.IADDI, Op.IMUL, Op.AND, Op.OR, Op.XOR,
    Op.SHL, Op.SHR, Op.LANEID, Op.LDG, Op.ATOMCAS, Op.ATOMEXCH, Op.ATOMADD,
    Op.BMOV_B2R,
})


def instr_deps(row: Sequence[int]) -> tuple[tuple[int, ...], tuple[int, ...],
                                            tuple[int, ...], tuple[int, ...]]:
    """``(reads_regs, writes_regs, reads_preds, writes_preds)`` of one
    instruction word — the scoreboard's view of the ISA.

    Predication (``pred1``/``pred2``, SS V-A encoding: 0 = none,
    ``+-k`` = [!]P(k-1)) reads the named predicate on *every* opcode;
    ISETP writes its destination predicate.  WARPSYNC reads its mask
    register only in the register form (``src0 != -1``).
    """
    op = int(row[F_OP])
    reads: list[int] = []
    if op == int(Op.WARPSYNC):
        if int(row[F_SRC0]) != -1:
            reads.append(int(row[F_SRC0]))
    else:
        for f in _REG_READS.get(op, ()):
            r = int(row[f])
            if r >= 0:
                reads.append(r)
        if op == int(Op.ISETP) and int(row[F_SRC1]) != -1:
            reads.append(int(row[F_SRC1]))
    writes: tuple[int, ...] = ()
    if op in _REG_WRITES and op != int(Op.ISETP):
        writes = (int(row[F_DST]),)
    reads_preds = tuple(abs(int(row[f])) - 1 for f in (F_PRED1, F_PRED2)
                        if int(row[f]) != 0)
    writes_preds = (int(row[F_DST]),) if op == int(Op.ISETP) else ()
    return tuple(reads), writes, reads_preds, writes_preds


def _class_latency(op: int, cfg: CycleConfig) -> int:
    """Latency of a non-memory op (memory goes through the sampler)."""
    if op in _CONTROL_LAT_OPS:
        return cfg.control_latency
    return cfg.alu_latency


# per-program dependence tables, keyed by the ndarray's identity — warps of
# one SM usually share a program, so the decode is done once per cell
_DEPS_CACHE: dict[int, tuple[Any, list]] = {}


def _dep_table(program: np.ndarray) -> list:
    key = id(program)
    hit = _DEPS_CACHE.get(key)
    if hit is not None and hit[0] is program:
        return hit[1]
    table = [instr_deps(row) for row in np.asarray(program)]
    if len(_DEPS_CACHE) > 256:        # bound: this is a cache, not a leak
        _DEPS_CACHE.clear()
    _DEPS_CACHE[key] = (program, table)
    return table


@dataclass
class CycleResult:
    """Outcome of one cycle-level schedule (see module docstring).

    ``order`` is the issue order as ``(warp, pc, mask)``; the stall fields
    follow the taxonomy above.  All ratio properties are guarded: a
    zero-instruction schedule reports 0.0, never a ZeroDivisionError.
    """

    order: list[tuple[int, int, int]]
    cycles: int
    thread_instructions: int
    warp_width: int
    busy_cycles: int = 0
    issue_stall_cycles: int = 0
    scoreboard_stall_cycles: int = 0
    memory_stall_cycles: int = 0
    policy: str = "greedy_then_oldest"
    per_warp_issues: tuple[int, ...] = ()

    @property
    def issues(self) -> int:
        return len(self.order)

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
        return self.scoreboard_stall_cycles + self.memory_stall_cycles

    @property
    def stall_breakdown(self) -> dict[str, int]:
        return {"issue": self.issue_stall_cycles,
                "scoreboard": self.scoreboard_stall_cycles,
                "memory": self.memory_stall_cycles}

    def to_timing_result(self) -> "Any":
        """This schedule as a legacy :class:`~repro_torch.core.timing.TimingResult`
        (carrying the new stall fields)."""
        from repro_torch.core.timing import TimingResult
        return TimingResult(
            cycles=self.cycles, issues=self.issues,
            thread_instructions=self.thread_instructions,
            warp_width=self.warp_width,
            busy_cycles=self.busy_cycles,
            issue_stall_cycles=self.issue_stall_cycles,
            scoreboard_stall_cycles=self.scoreboard_stall_cycles,
            memory_stall_cycles=self.memory_stall_cycles)


def _normalize_programs(programs: Sequence[Any], n: int,
                        scoreboard: bool) -> tuple[list, list]:
    """Per-warp ``(opcode list, dep table | None)`` from program inputs.

    Accepts full ``[L, N_FIELDS]`` row tables or bare opcode columns; the
    scoreboard needs operands, so it insists on full rows.
    """
    if len(programs) != n:
        raise ValueError(f"{len(programs)} programs for {n} warp traces")
    ops_list, deps_list = [], []
    for p in programs:
        arr = np.asarray(p)
        if arr.ndim == 2:
            ops_list.append([int(o) for o in arr[:, F_OP]])
            deps_list.append(_dep_table(p if isinstance(p, np.ndarray)
                                        else arr) if scoreboard else None)
        elif arr.ndim == 1:
            if scoreboard:
                raise ValueError(
                    "scoreboard mode needs full [L, N_FIELDS] program rows "
                    "(got a bare opcode column); pass scoreboard=False or "
                    "the full program table")
            ops_list.append([int(o) for o in arr])
            deps_list.append(None)
        else:
            raise ValueError(f"program must be 1-D opcodes or 2-D rows, "
                             f"got ndim={arr.ndim}")
    return ops_list, deps_list


def schedule_cycle(traces: Sequence[Sequence[tuple[int, int]]],
                   programs: Sequence[Any],
                   policy: str = "greedy_then_oldest",
                   cfg: CycleConfig = CycleConfig(),
                   *, warp_width: int = 0) -> CycleResult:
    """Schedule per-warp traces through one SM issue port, cycle-level.

    ``traces[w]`` is warp *w*'s finished control-flow trace of
    ``(pc, mask)`` slots; ``programs[w]`` its program (full rows, or opcode
    column in trace-conservative mode).  Returns a :class:`CycleResult`
    whose ``order``/``cycles``/``thread_instructions`` are, in
    trace-conservative single-issue fixed-memory mode, bit-identical to the
    legacy ``schedule_traces`` loop — the differential suite gates this.
    """
    policy_name = resolve_policy_name(policy)
    n = len(traces)
    traces = [list(t) for t in traces]
    lens = [len(t) for t in traces]
    ops_list, deps_list = _normalize_programs(programs, n, cfg.scoreboard)
    pol = get_policy(policy_name, n)
    mem_draw = _memory_sampler(cfg)

    idx = [0] * n
    in_order = [0] * n               # in-order floor: last issue cycle + 1
    # trace-conservatism state: completion time + class of the previous
    # instruction; scoreboard state: per-reg/pred (ready time, is_mem)
    t_ready = [0] * n
    t_mem = [False] * n
    reg_ready: list[dict[int, tuple[int, bool]]] = [dict() for _ in range(n)]
    pred_ready: list[dict[int, tuple[int, bool]]] = [dict() for _ in range(n)]

    wake = EventQueue()              # completion events: payload = warp
    order: list[tuple[int, int, int]] = []
    per_warp = [0] * n
    tinstr = 0
    cycle = 0
    busy = issue_stall = sb_stall = mem_stall = 0
    remaining = sum(lens)
    scoreboard = cfg.scoreboard

    def ready_info(w: int, now: int, floor: bool = True
                   ) -> tuple[int, bool]:
        """(earliest issue time, blocked-by-memory?) for warp w's next
        instruction.  ``floor=False`` drops the in-order constraint — used
        for same-cycle dual issue of a warp that already issued."""
        rt = in_order[w] if floor else 0
        is_mem = False
        if not scoreboard:
            if t_ready[w] > rt:
                rt, is_mem = t_ready[w], t_mem[w]
            elif t_ready[w] == rt:
                is_mem = is_mem or t_mem[w]
            return rt, is_mem
        pc = traces[w][idx[w]][0]
        deps = deps_list[w]
        if not (0 <= pc < len(deps)):
            return rt, is_mem
        reads, writes, p_reads, p_writes = deps[pc]
        regs, preds = reg_ready[w], pred_ready[w]
        for r in reads + writes:                       # RAW + WAW
            t, m = regs.get(r, (0, False))
            if t > rt:
                rt, is_mem = t, m
            elif t == rt:
                is_mem = is_mem or (m and t > 0)
        for p in p_reads + p_writes:
            t, m = preds.get(p, (0, False))
            if t > rt:
                rt, is_mem = t, m
        return rt, is_mem

    def ready_set(now: int, issued_now: set) -> list[int]:
        out = []
        for w in range(n):
            if idx[w] >= lens[w]:
                continue
            rt, _ = ready_info(w, now, floor=w not in issued_now)
            if rt <= now:
                out.append(w)
        return out

    while remaining:
        issued_now: set[int] = set()
        ready = ready_set(cycle, issued_now)
        if not ready:
            # idle: hop along completion events until some warp wakes,
            # then classify the whole gap by the earliest blocked warp(s)
            start = cycle
            while not ready:
                if not wake:         # pragma: no cover - defensive
                    raise RuntimeError("timing model wedged: pending warps "
                                       "but no completion events")
                nt, _ = wake.pop()
                if nt <= cycle:
                    continue
                cycle = nt
                ready = ready_set(cycle, issued_now)
            gap_mem = False
            for w in range(n):
                if idx[w] >= lens[w]:
                    continue
                rt, m = ready_info(w, cycle)
                if rt <= cycle and m:
                    gap_mem = True
                    break
            if gap_mem:
                mem_stall += cycle - start
            else:
                sb_stall += cycle - start
            pol.stalled()
        busy += 1
        slots = cfg.issue_width
        while slots > 0 and ready:
            w = pol.select(ready)
            pc, mask = traces[w][idx[w]]
            idx[w] += 1
            remaining -= 1
            ops = ops_list[w]
            op = ops[pc] if 0 <= pc < len(ops) else int(Op.NOP)
            if op in ATOMIC_OPS:
                lat, is_mem = cfg.atomic_latency, True
            elif op in MEMORY_OPS:
                lat, is_mem = mem_draw(), True
            else:
                lat, is_mem = _class_latency(op, cfg), False
            done = cycle + lat
            if scoreboard:
                deps = deps_list[w]
                if 0 <= pc < len(deps):
                    _, writes, _, p_writes = deps[pc]
                    for r in writes:
                        reg_ready[w][r] = (done, is_mem)
                    for p in p_writes:
                        pred_ready[w][p] = (done, is_mem)
            else:
                t_ready[w] = done
                t_mem[w] = is_mem
            wake.push(done, w)
            order.append((w, pc, mask))
            per_warp[w] += 1
            tinstr += popcount(mask)
            pol.issued(w)
            issued_now.add(w)
            slots -= 1
            ready = ready_set(cycle, issued_now)
        if ready:                    # ready warps stranded by the port
            issue_stall += 1
        for w in issued_now:
            in_order[w] = cycle + 1
        cycle += 1

    return CycleResult(order=order, cycles=cycle,
                       thread_instructions=tinstr, warp_width=warp_width,
                       busy_cycles=busy, issue_stall_cycles=issue_stall,
                       scoreboard_stall_cycles=sb_stall,
                       memory_stall_cycles=mem_stall,
                       policy=policy_name, per_warp_issues=tuple(per_warp))


def simulate_cycle(traces: Sequence[Sequence[tuple[int, int]]],
                   program: Any, warp_width: int,
                   cfg: CycleConfig = CycleConfig(),
                   policy: str = "greedy_then_oldest") -> "Any":
    """Fig 10 entry point: N warps of one program through the cycle model.

    The cycle-model analogue of :func:`repro_torch.core.timing.simulate`;
    returns an extended :class:`~repro_torch.core.timing.TimingResult` carrying
    the stall breakdown.
    """
    res = schedule_cycle(traces, [program] * len(traces), policy, cfg,
                         warp_width=warp_width)
    return res.to_timing_result()
