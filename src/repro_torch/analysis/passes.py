"""The static verification passes and their diagnostic catalog.

Port of ``repro.analysis.passes`` (numpy only, copied; it imports nothing of
``repro``).

``analyze_program`` runs every pass over one encoded program — without
executing an instruction — and returns an :class:`AnalysisReport` of
structured :class:`Diagnostic`\\ s, each carrying a severity, a stable
code, the pc, and the disassembled instruction text.

Severity contract (what the platform layers key off):

* ``error`` — the program violates a static contract of the paper's
  control-flow semantics; running it wastes shard fuel on a guaranteed
  malfunction.  `SimulationService` refuses these at admission.
* ``warn`` — legal but hazardous (a YIELD-less spin-loop can hang
  ``simt_stack``; a region nest deeper than the Bx file forces BMOV
  spills).  Reported; runs proceed.
* ``info`` — noteworthy structure (BREAK early reconvergence,
  unannotated divergent branches) that explains mechanism disagreement.

The catalog is documented in the reference's docs/analysis.md; codes are stable API.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from functools import lru_cache

import numpy as np

from repro_torch.core.asm import disassemble_line
from repro_torch.core.isa import (ATOMIC_OPS, F_DST, F_IMM, F_OP, F_PRED1, F_PRED2,
                            F_SRC0, MachineConfig, Op)

from .cfg import SINK, ProgramCFG
from .fingerprint import graph_fingerprint

__all__ = ["AnalysisReport", "Diagnostic", "Severity", "StaticAnalysisError",
           "analyze_program", "verify_program"]


class Severity(str, Enum):
    ERROR = "error"
    WARN = "warn"
    INFO = "info"

    def __str__(self) -> str:      # render "error", not "Severity.ERROR"
        return self.value


@dataclass(frozen=True)
class Diagnostic:
    """One finding: ``(severity, stable code, pc, message, disassembly)``."""

    severity: Severity
    code: str
    pc: int
    message: str
    line: str = ""

    def render(self) -> str:
        return (f"pc {self.pc:4d}  [{self.severity}] {self.code}: "
                f"{self.message}\n          {self.line}")


@dataclass(frozen=True)
class AnalysisReport:
    """Everything one analyzer run produced for one program."""

    diagnostics: tuple[Diagnostic, ...] = ()
    fingerprint: tuple[float, ...] = ()
    name: str = ""

    @property
    def errors(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity is Severity.ERROR)

    @property
    def warnings(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity is Severity.WARN)

    @property
    def infos(self) -> tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity is Severity.INFO)

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)

    def render(self) -> str:
        head = f"analysis{f' of {self.name}' if self.name else ''}: "
        if not self.diagnostics:
            return head + "clean"
        lines = [head + f"{len(self.errors)} error(s), "
                        f"{len(self.warnings)} warning(s), "
                        f"{len(self.infos)} info(s)"]
        lines += [d.render() for d in self.diagnostics]
        return "\n".join(lines)


class StaticAnalysisError(ValueError):
    """Raised (and set on service tickets) for ``error``-level programs."""

    def __init__(self, report: AnalysisReport) -> None:
        self.report = report
        super().__init__(report.render())


def analyze_program(program: np.ndarray, cfg: MachineConfig | None = None,
                    *, name: str = "") -> AnalysisReport:
    """Run every static pass; diagnostics come back sorted by pc then
    severity (errors first at equal pc)."""
    prog = np.ascontiguousarray(np.asarray(program, dtype=np.int32))
    cfg = cfg if cfg is not None else MachineConfig()
    report = _analyze_cached(prog.tobytes(), prog.shape[0],
                             cfg.n_bx, cfg.n_preds, cfg.n_regs)
    if name:
        report = AnalysisReport(report.diagnostics, report.fingerprint, name)
    return report


def verify_program(program: np.ndarray, cfg: MachineConfig | None = None,
                   *, name: str = "", strict: bool = False) -> AnalysisReport:
    """:func:`analyze_program`, raising :class:`StaticAnalysisError` when
    errors (or, with ``strict``, warnings) are present."""
    report = analyze_program(program, cfg, name=name)
    bad = report.errors + (report.warnings if strict else ())
    if bad:
        raise StaticAnalysisError(report)
    return report


@lru_cache(maxsize=4096)
def _analyze_cached(key: bytes, length: int, n_bx: int,
                    n_preds: int, n_regs: int) -> AnalysisReport:
    # the key carries every MachineConfig knob a pass reads (n_bx for
    # stack-depth/bad-bx, n_preds for predicate checks, n_regs for the
    # spill-capacity hint) so reports never go stale across configs
    prog = np.frombuffer(key, dtype=np.int32).reshape(length, -1)
    cfg = MachineConfig(n_bx=n_bx, n_preds=n_preds, n_regs=n_regs)
    return _analyze(prog, cfg)


_SEV_ORDER = {Severity.ERROR: 0, Severity.WARN: 1, Severity.INFO: 2}


def _analyze(prog: np.ndarray, cfg: MachineConfig) -> AnalysisReport:
    g = ProgramCFG(prog, cfg)
    diags: list[Diagnostic] = []

    def emit(severity: Severity, code: str, pc: int, message: str) -> None:
        line = disassemble_line(prog[pc]) if 0 <= pc < g.n else ""
        diags.append(Diagnostic(severity, code, pc, message, line))

    _check_targets(g, emit)
    _check_bx(g, cfg, emit)
    _check_regions(g, emit)
    _check_reconvergence(g, emit)
    _check_warpsync(g, emit)
    _check_reachability(g, emit)
    _check_loops(g, emit)
    _check_stack_depth(g, cfg, emit)

    diags.sort(key=lambda d: (d.pc, _SEV_ORDER[d.severity], d.code))
    return AnalysisReport(tuple(diags), graph_fingerprint(g))


# ---------------------------------------------------------------------------
# individual passes
# ---------------------------------------------------------------------------

def _check_targets(g: ProgramCFG, emit) -> None:
    """``bad-target``: a control-transfer immediate outside the program."""
    for pc in g.bad_targets:
        op = Op(g.ops[pc])
        emit(Severity.ERROR, "bad-target", pc,
             f"{op.name} target {g.rows[pc][F_IMM]} is outside the program "
             f"(0..{g.n - 1})")
    # BSSY targets are data, not edges — validate them here
    for pc, _, t in g.regions:
        if not (0 <= t < g.n):
            emit(Severity.ERROR, "bad-target", pc,
                 f"BSSY reconvergence target {t} is outside the program "
                 f"(0..{g.n - 1})")


def _check_bx(g: ProgramCFG, cfg: MachineConfig, emit) -> None:
    """``bad-bx``: a Bx operand beyond the machine's convergence-barrier
    register file."""
    for pc, op in enumerate(g.ops):
        row = g.rows[pc]
        bx = None
        if op in (Op.BSSY, Op.BSYNC, Op.BREAK, Op.BMOV_R2B):
            bx = row[F_DST]
        elif op == Op.BMOV_B2R:
            bx = row[F_SRC0]
        if bx is not None and not (0 <= bx < cfg.n_bx):
            emit(Severity.ERROR, "bad-bx", pc,
                 f"B{bx} out of range for an n_bx={cfg.n_bx} machine")


def _check_regions(g: ProgramCFG, emit) -> None:
    """``bssy-target`` (target isn't this region's BSYNC) and
    ``bx-clobber`` (nested BSSY reuses a live Bx without a BMOV save —
    the Fig 5 spill contract)."""
    for pc, bx, t in g.regions:
        if not (0 <= t < g.n):
            continue                                       # bad-target already
        if g.ops[t] != Op.BSYNC:
            emit(Severity.ERROR, "bssy-target", pc,
                 f"BSSY B{bx} target pc {t} is {Op(g.ops[t]).name}, "
                 f"not BSYNC")
        elif g.rows[t][F_DST] != bx:
            emit(Severity.ERROR, "bssy-target", pc,
                 f"BSSY B{bx} target pc {t} syncs B{g.rows[t][F_DST]}, "
                 f"not B{bx}")
    for outer_pc, bx, outer_t in g.valid_regions:
        for inner_pc, bx2, _ in g.valid_regions:
            if bx2 == bx and outer_pc < inner_pc < outer_t:
                if not g.spills_of(bx, outer_pc, inner_pc):
                    emit(Severity.ERROR, "bx-clobber", inner_pc,
                         f"nested BSSY reuses live B{bx} (held by the "
                         f"region at pc {outer_pc}) with no BMOV "
                         f"spill in between")


def _check_reconvergence(g: ProgramCFG, emit) -> None:
    """Reconvergence verification (paper SS V-B / Fig 5-6).

    For every conditional branch inside a BSSY region, the region's BSYNC
    must be a point all paths from the branch pass through (its IPDom, or
    a straight-line continuation of it — the BMOV-refill preamble).
    A BREAK on the region's Bx makes earlier-than-IPDom reconvergence
    *legal* (Fig 6) and downgrades the finding to ``early-reconvergence``
    info.  Conditional branches under no region get an
    ``unannotated-branch`` info — divergence there reconverges wherever
    the mechanism's fallback picks, which is exactly where mechanisms
    disagree."""
    for pc, op in enumerate(g.ops):
        if op != Op.BRA or not g.reachable[pc]:
            continue
        row = g.rows[pc]
        if row[F_PRED1] == 0 and row[F_PRED2] == 0:
            continue                                       # not divergent
        region = g.innermost_region(pc)
        if region is None:
            emit(Severity.INFO, "unannotated-branch", pc,
                 "conditional branch outside any BSSY region; "
                 "reconvergence point is mechanism-defined")
            continue
        rpc, bx, sync = region
        breaks = g.breaks_on(bx, rpc, sync)
        if g.postdominates(sync, pc):
            ip = g.ipostdom(pc)
            if ip is not None and ip != SINK and ip != sync \
                    and not g.straight_line(ip, sync):
                emit(Severity.WARN, "late-reconvergence", pc,
                     f"region BSYNC at pc {sync} postdominates this "
                     f"branch but its IPDom is pc {ip}; paths "
                     f"re-diverge before syncing")
            continue
        if breaks:
            emit(Severity.INFO, "early-reconvergence", pc,
                 f"BREAK at pc {breaks[0]} releases threads from "
                 f"B{bx} before the BSYNC at pc {sync} "
                 f"(legal earlier-than-IPDom reconvergence)")
        else:
            ip = g.ipostdom(pc)
            where = ("unreachable from it" if ip is None
                     else f"pc {ip}" if ip != SINK else "the exit")
            emit(Severity.ERROR, "reconvergence", pc,
                 f"region BSYNC at pc {sync} does not postdominate this "
                 f"branch (IPDom is {where}) and no BREAK on B{bx} "
                 f"legalizes early reconvergence; threads bypassing "
                 f"the BSYNC strand the ones parked in B{bx}")


def _check_warpsync(g: ProgramCFG, emit) -> None:
    """``warpsync-split``: two static paths from entry lead to *different*
    first WARPSYNC rendezvous — a divergent warp can park complementary
    lane subsets at each, and neither barrier ever fills (the structural
    half of the DEADLOCK class ``volta_itps`` reports)."""
    if g.n == 0:
        return
    first = sorted(g.first_warpsync[0])
    if len(first) > 1:
        pcs = ", ".join(str(p) for p in first)
        emit(Severity.ERROR, "warpsync-split", first[0],
             f"divergent paths rendezvous at different WARPSYNCs "
             f"(pcs {pcs}); lanes parked at one cannot release the other")


def _check_reachability(g: ProgramCFG, emit) -> None:
    """``unreachable`` (warn, one per contiguous range) and
    ``fall-off-end`` (warn: the last instruction can fall off the table,
    which the steppers treat as an implicit EXIT)."""
    pc = 0
    while pc < g.n:
        if g.reachable[pc]:
            pc += 1
            continue
        start = pc
        while pc < g.n and not g.reachable[pc]:
            pc += 1
        span = f"pcs {start}..{pc - 1}" if pc - 1 > start else f"pc {start}"
        emit(Severity.WARN, "unreachable", start,
             f"{span} unreachable from entry ({pc - start} instruction(s))")
    last = g.n - 1
    if last >= 0 and g.reachable[last]:
        row = g.rows[last]
        op = row[F_OP]
        guarded = row[F_PRED1] != 0 or row[F_PRED2] != 0
        terminates = (op in (Op.EXIT, Op.RET) and not guarded) \
            or (op == Op.BRA and not guarded)
        if not terminates:
            emit(Severity.WARN, "fall-off-end", last,
                 "control can run off the end of the program "
                 "(implicit EXIT); terminate explicitly")


def _check_loops(g: ProgramCFG, emit) -> None:
    """``spin-loop`` (warn: atomics but no YIELD — paper Fig 3/7, hangs
    legacy per-warp stacks when the lock holder is in the warp) and
    ``infinite-loop`` (warn: no edge leaves the loop at all)."""
    for loop in g.loops:
        if not g.loop_has_exit(loop):
            emit(Severity.WARN, "infinite-loop", loop.header,
                 f"loop at pc {loop.header} has no exit edge; only "
                 f"fuel exhaustion stops it")
            continue
        has_atomic = g.loop_has(loop, ATOMIC_OPS)
        has_yield = g.loop_has(loop, {int(Op.YIELD)})
        if has_atomic and not has_yield:
            emit(Severity.WARN, "spin-loop", loop.header,
                 f"spin-loop at pc {loop.header} polls an atomic with no "
                 f"YIELD; a serial-execution mechanism (simt_stack, "
                 f"hanoi) cannot switch to the lock holder")


def _check_stack_depth(g: ProgramCFG, cfg: MachineConfig, emit) -> None:
    """``stack-depth``: static BSSY nesting exceeding the Bx file — every
    extra level forces a BMOV spill/fill pair around the inner region
    (paper SS IX-A sizes n_bx=8 to make this rare, not impossible)."""
    depth = g.max_region_depth
    if depth > cfg.n_bx:
        emit(Severity.WARN, "stack-depth", 0,
             f"static divergence-region nesting reaches {depth} but the "
             f"machine has n_bx={cfg.n_bx} barrier registers; "
             f"{depth - cfg.n_bx} level(s) must spill via BMOV "
             f"({cfg.n_regs} general registers available for slots)")
