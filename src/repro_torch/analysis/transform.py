"""Annotation-synthesis compiler passes (paper SS V, Fig 5-7).

Port of ``repro.analysis.transform`` (numpy only, copied; it imports nothing of
``repro``).

The verifier (:mod:`repro_torch.analysis.passes`) polices the control-flow
management contract the vendor compiler emits; this module *produces* it.
Given an unannotated (or stripped) program, :func:`synthesize_annotations`
plants the same annotations ``repro_torch.core.structured`` lowers from its AST:

* **Region synthesis** — for every divergent conditional branch, a
  ``BSSY Bk, <sync>`` ahead of the branch (hoisted out of any loop the
  branch re-executes in) and a ``BSYNC Bk`` at the branch's immediate
  postdominator.
* **Bx allocation** — an interval-based allocator over the nesting forest:
  region at nesting level *d* gets ``pool[d % len(pool)]`` where ``pool``
  excludes Bx registers pinned by retained (pre-existing) regions.  When a
  subtree nests deeper than the pool, the outer region spills its Bx
  through ``BMOV R{n_regs-1-d}, Bk`` / ``BMOV Bk, R{n_regs-1-d}`` — the
  exact contract the ``bx-clobber`` pass polices.
* **YIELD insertion** — a ``YIELD`` at the header of every atomic-polling
  loop the ``spin-loop`` warning flags, restoring forward progress for
  serial-execution mechanisms (paper Fig 3/7).

:func:`strip_annotations` is the inverse: it removes every annotation the
synthesizer can faithfully reconstruct, so ``strip -> synthesize``
round-trips the suite and the progen corpus (bit-exactly wherever the
original followed the structured-compiler idiom).  Regions that carry
semantics the synthesizer must not guess at — BREAK loops (early
reconvergence), regions whose BSYNC sits *later* than the branch IPDom to
cover real work (the spinlock critical section), predicated annotations —
are retained, recursively: a region is only strippable if everything
nested inside it is.

Programs containing CALL/RET are never edited: ``MOV Rd, <label>`` stages
return addresses as plain immediates (see ``programs.CALLS``), so any
insertion or removal would silently shift them.  Such edits are refused
with a diagnostic instead of mis-annotating.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.asm import EditInstr, ProgramEditor
from repro_torch.core.isa import (ATOMIC_OPS, F_DST, F_IMM, F_OP, F_PRED1,
                            F_PRED2, Instr, MachineConfig, Op)

from .cfg import SINK, ProgramCFG
from .passes import AnalysisReport, analyze_program

__all__ = ["ANNOTATION_OPS", "Refusal", "StripResult", "SynthesisResult",
           "TransformError", "strip_annotations", "synthesize_annotations"]

#: The ops the transform layer owns: pure control-flow management with no
#: architectural effect on registers or memory (BMOV writes a register, but
#: only as a spill slot the allocator reserves from the top of the file).
ANNOTATION_OPS = frozenset({int(Op.BSSY), int(Op.BSYNC), int(Op.BMOV_B2R),
                            int(Op.BMOV_R2B), int(Op.YIELD)})


class TransformError(ValueError):
    """A rewrite could not be completed safely.

    Raised when the synthesizer has no free Bx register, no free spill
    register, or — the backstop — when the rewritten program fails
    re-analysis.  ``refusals`` carries the per-site diagnostics; ``report``
    the post-rewrite analysis when one was produced.
    """

    def __init__(self, message: str,
                 refusals: "tuple[Refusal, ...]" = (),
                 report: "AnalysisReport | None" = None) -> None:
        self.refusals = refusals
        self.report = report
        detail = "; ".join(r.message for r in refusals)
        super().__init__(message + (f" [{detail}]" if detail else ""))


@dataclass(frozen=True)
class Refusal:
    """One site the synthesizer declined to annotate, and why."""

    pc: int
    code: str        # stable: ipdom-sink / warpsync-join / call-ret / ...
    message: str


@dataclass(frozen=True)
class StripResult:
    """Output of :func:`strip_annotations`."""

    program: np.ndarray
    removed: tuple[int, ...]                    # input pcs removed
    kept_regions: tuple[tuple[int, int, int], ...]   # retained (p, bx, t)
    pc_map: tuple[tuple[int, int], ...]         # (input pc, output pc)

    @property
    def changed(self) -> bool:
        return bool(self.removed)


@dataclass(frozen=True)
class SynthesisResult:
    """Output of :func:`synthesize_annotations`."""

    program: np.ndarray
    regions: int                                # BSSY/BSYNC pairs inserted
    spills: int                                 # BMOV pairs inserted
    yields: int                                 # YIELDs inserted
    skipped: tuple[Refusal, ...]                # benign: nothing to place
    refused: tuple[Refusal, ...]                # unsafe: declined to place
    report: AnalysisReport                      # post-synthesis analysis
    pc_map: tuple[tuple[int, int], ...]         # (input pc, output pc)

    @property
    def changed(self) -> bool:
        return bool(self.regions or self.spills or self.yields)


# ---------------------------------------------------------------------------
# strip
# ---------------------------------------------------------------------------

def _has_call(g: ProgramCFG) -> bool:
    return any(op in (Op.CALL, Op.RET) for op in g.ops)


def _region_spills(g: ProgramCFG, p: int, bx: int, t: int) -> list[int]:
    """Both halves of a region's spill pair (B2R saves + R2B refills)."""
    out = g.spills_of(bx, p, t)
    out += [pc for pc in range(p + 1, t)
            if g.ops[pc] == Op.BMOV_R2B and g.rows[pc][F_DST] == bx]
    return out


def _branch_canonical(g: ProgramCFG, pc: int,
                      region: tuple[int, int, int]) -> bool:
    """Whether the region syncs ``pc`` exactly at its IPDom (modulo the
    refill preamble) — i.e. carries no information synthesis can't rebuild."""
    p, bx, t = region
    ip = g.ipostdom(pc)
    if ip is None or ip == SINK:
        return False
    ip = _sink_through_exit_bra(g, pc, ip)
    if ip == t:
        return True
    if not p < ip < t:
        return False
    # Everything between the IPDom and the BSYNC must be this region's own
    # refill; any real instruction there (e.g. a critical section guarded
    # by the late BSYNC, as in SPINLOCK) is semantics we must not drop.
    return all(g.ops[x] == Op.BMOV_R2B and g.rows[x][F_DST] == bx
               for x in range(ip, t))


def _strippable_regions(g: ProgramCFG) -> list[tuple[int, int, int]]:
    regions = g.valid_regions
    overlapped: set[tuple[int, int, int]] = set()
    for a in regions:
        for b in regions:
            if a is not b and a[0] < b[0] <= a[2] < b[2]:
                overlapped.add(a)
                overlapped.add(b)

    def nested_in(outer: tuple[int, int, int]) -> list[tuple[int, int, int]]:
        return [r for r in regions if r is not outer
                and outer[0] <= r[0] and r[2] <= outer[2]]

    def branches_of(r: tuple[int, int, int]) -> list[int]:
        p, _, t = r
        return [b2 for b2, op in enumerate(g.ops)
                if op == Op.BRA and p < b2 < t and g.reachable[b2]
                and (g.rows[b2][F_PRED1] or g.rows[b2][F_PRED2])
                and g.innermost_region(b2) == r]

    def joins_at_warpsync(r: tuple[int, int, int]) -> bool:
        # if stripping this region's closers would leave the join sitting
        # on a WARPSYNC, synthesis would (correctly) defer to the explicit
        # rendezvous and never re-create the region — keep it instead
        x = r[2]
        while x < g.n and g.ops[x] in (Op.BSYNC, Op.BMOV_R2B):
            x += 1
        return x < g.n and g.ops[x] == Op.WARPSYNC

    ok: dict[tuple[int, int, int], bool] = {}
    # innermost-first so the recursive condition is a plain lookup
    for r in sorted(regions, key=lambda r: r[2] - r[0]):
        p, bx, t = r
        strippable = (
            r not in overlapped
            and t < g.n - 1                       # never expose a fall-off
            and not g.breaks_on(bx, p, t)         # BREAK: early reconvergence
            and g.rows[p][F_PRED1] == 0 and g.rows[p][F_PRED2] == 0
            and g.rows[t][F_PRED1] == 0 and g.rows[t][F_PRED2] == 0
            and all(g.ops[x] not in (Op.CALL, Op.RET) for x in range(p + 1, t))
            and not joins_at_warpsync(r)
            and all(_branch_canonical(g, b2, r) for b2 in branches_of(r))
            and all(ok[r2] for r2 in nested_in(r)))
        ok[r] = strippable

    # Fixpoint: a strippable region sitting inside a RETAINED one can only
    # be removed if synthesis would re-plan it.  A retained If region whose
    # BSYNC postdominates the inner branch "covers" it — stripping the
    # inner region would silently coarsen reconvergence to the outer sync
    # (the base-progen else-arm shape).  A retained BREAK region does NOT
    # cover its interior (the break path bypasses its BSYNC), so regions
    # inside it re-plan fine and stay strippable.  Retention cascades:
    # anything wrapping a newly retained region is retained too.
    keep = {r for r in regions if ok.get(r, False)}
    changed = True
    while changed:
        changed = False
        for r in sorted(keep, key=lambda r: r[2] - r[0]):
            ancestors = [a for a in regions if a not in keep
                         and a[0] <= r[0] and r[2] <= a[2] and a != r]
            if not ancestors:
                continue
            a = min(ancestors, key=lambda a: a[2] - a[0])   # nearest retained
            for b2 in branches_of(r):
                ip = g.ipostdom(b2)
                if ip is None or ip == SINK:
                    continue
                ip = _sink_through_exit_bra(g, b2, ip)
                replanned = (not g.postdominates(a[2], b2)
                             and a[0] < ip < a[2])
                if not replanned:
                    keep.discard(r)
                    changed = True
                    break
        for r in sorted(keep, key=lambda r: r[2] - r[0]):
            if any(r2 not in keep for r2 in nested_in(r)):
                keep.discard(r)
                changed = True
    return [r for r in regions if r in keep]


def _spin_headers(g: ProgramCFG) -> list[int]:
    """Headers of loops the ``spin-loop`` pass would flag were their YIELD
    removed (atomics + an exit edge), in pc order."""
    return sorted(lp.header for lp in g.loops
                  if g.loop_has_exit(lp) and g.loop_has(lp, ATOMIC_OPS))


def strip_annotations(program: np.ndarray,
                      cfg: MachineConfig | None = None) -> StripResult:
    """Remove every annotation :func:`synthesize_annotations` can rebuild.

    Strippable regions (see module docstring) lose their BSSY, BSYNC and
    spill pairs; a YIELD sitting at the header of an atomic-polling loop is
    removed too.  Everything else — BREAK regions and anything nested
    around them, late-sync regions, predicated annotations, whole CALL/RET
    programs — survives untouched and is reported in ``kept_regions``.
    """
    prog = np.ascontiguousarray(np.asarray(program, dtype=np.int32))
    g = ProgramCFG(prog, cfg)
    identity = tuple((pc, pc) for pc in range(g.n))
    if _has_call(g):
        return StripResult(prog, (), tuple(g.valid_regions), identity)

    strippable = _strippable_regions(g)
    doomed: set[int] = set()
    for p, bx, t in strippable:
        doomed.update((p, t))
        doomed.update(_region_spills(g, p, bx, t))
    for header in _spin_headers(g):
        if g.ops[header] == Op.YIELD:
            doomed.add(header)

    if not doomed:
        return StripResult(prog, (), tuple(g.valid_regions), identity)

    editor = ProgramEditor(prog)
    nodes0 = list(editor.nodes)
    for pc in sorted(doomed):
        editor.remove(nodes0[pc])
    out = editor.encode()
    positions = editor.positions()
    pc_map = tuple((pc, positions[node]) for pc, node in enumerate(nodes0)
                   if node in positions)
    kept = tuple(r for r in g.valid_regions if r not in set(strippable))
    return StripResult(out, tuple(sorted(doomed)), kept, pc_map)


# ---------------------------------------------------------------------------
# synthesize
# ---------------------------------------------------------------------------

@dataclass
class _Plan:
    """One region to materialize, in *input* coordinates."""

    branch: int                     # the divergent BRA
    anchor: int                     # where BSSY goes (== branch or hoisted)
    t: int                          # IPDom: where BSYNC goes
    bx: int = -1
    spill_reg: int = -1             # <0: no spill
    bssy: EditInstr = field(default=None, repr=False)    # type: ignore
    bsync: EditInstr = field(default=None, repr=False)   # type: ignore
    spill: EditInstr = field(default=None, repr=False)   # type: ignore
    refill: EditInstr = field(default=None, repr=False)  # type: ignore

    @property
    def interval(self) -> tuple[int, int]:
        return (self.anchor, self.t)


def _needs_region(g: ProgramCFG, pc: int) -> bool:
    """Whether a divergent branch lacks reconvergence coverage.

    Uncovered means: no region contains it, or the innermost region's
    BSYNC does not postdominate it *and* its IPDom falls strictly inside
    that region (a fixable inner join — e.g. an If inside a retained BREAK
    loop).  Branches whose IPDom escapes the enclosing region (the BREAK
    loop's own exit test) are that region's business, not ours.
    """
    region = g.innermost_region(pc)
    if region is None:
        return True
    p, _, t = region
    if g.postdominates(t, pc):
        return False
    ip = g.ipostdom(pc)
    return ip is not None and ip != SINK and p < ip < t


def _anchor(g: ProgramCFG, pc: int, t: int) -> int:
    """BSSY placement for the branch at ``pc`` reconverging at ``t``.

    A BSSY inside a loop re-executes and re-arms Bk every iteration, so a
    branch whose reconvergence point lies outside a containing loop hoists
    its BSSY to that loop's header (the structured-compiler While shape).
    Otherwise the BSSY lands just above the branch's guard ISETP when the
    branch consumes one directly (the If shape), else above the branch.
    """
    hoists = [lp for lp in g.loops if pc in lp.nodes and t not in lp.nodes]
    if hoists:
        best = max(hoists, key=lambda lp: (len(lp.nodes), -lp.header))
        return best.header
    row = g.rows[pc]
    prev = pc - 1
    if prev >= 0 and g.ops[prev] == Op.ISETP:
        prow = g.rows[prev]
        guards = {abs(p) - 1 for p in (row[F_PRED1], row[F_PRED2]) if p}
        if prow[F_PRED1] == 0 and prow[F_PRED2] == 0 \
                and prow[F_DST] in guards:
            return prev
    return pc


def _sink_through_exit_bra(g: ProgramCFG, pc: int, t: int) -> int:
    """Sink a BSYNC site through the branch's own fall-through exit jump.

    A While lowers to ``@P BRA body / BRA rest`` — every path from the cond
    branch funnels through the unconditional ``BRA rest`` at ``pc+1``, so
    the IPDom lands ON that jump.  The reconvergence point the compiler
    means is the jump's (forward) destination; syncing there keeps the
    BSYNC out of the loop body and matches the structured-compiler layout.
    """
    while (t == pc + 1 and 0 <= t < g.n and g.ops[t] == Op.BRA
           and g.rows[t][F_PRED1] == 0 and g.rows[t][F_PRED2] == 0
           and g.rows[t][F_IMM] > t):
        pc, t = t, g.rows[t][F_IMM]
    return t


def _contains(a: tuple[int, int], b: tuple[int, int]) -> bool:
    """Interval ``a`` strictly wraps interval ``b`` (shared endpoints nest
    outermost-first, matching how shared-join regions stack their BSYNCs)."""
    if a == b:
        return False
    return a[0] <= b[0] and b[1] <= a[1]


def _allocate(plans: list[_Plan], retained: list[tuple[int, int, int]],
              g: ProgramCFG, mach: MachineConfig) -> int:
    """Assign ``bx`` / ``spill_reg`` to every plan; returns spill count.

    Mirrors ``repro_torch.core.structured._Ctx`` exactly: retained BREAK regions
    pin their (top-of-file) dedicated Bx, the regular pool is ``[0, n_bx -
    n_breaks)``, nesting level *d* (counting both planned and retained
    enclosing regions) maps to ``pool[d % P]``, and a spill pair is added
    when the subtree below reaches ``P`` levels deeper.  Retained non-BREAK
    regions keep their Bx in the pool — at matching depth parity the
    original already carried the spill the contract requires, and if a
    hand-written input didn't, re-analysis flags the clobber and synthesis
    refuses rather than emitting it.
    """
    break_regions = [r for r in retained if g.breaks_on(r[1], r[0], r[2])]
    pool = list(range(mach.n_bx - len(break_regions)))
    if plans and not pool:
        raise TransformError(
            f"no free Bx registers: the {mach.n_bx}-entry file is entirely "
            f"pinned by {len(break_regions)} BREAK region(s)")

    intervals: list[tuple[int, int]] = (
        [p.interval for p in plans] + [(r[0], r[2]) for r in retained])

    def level(iv: tuple[int, int]) -> int:
        return sum(1 for other in intervals if _contains(other, iv))

    spills = 0
    for plan in plans:
        d = level(plan.interval)
        plan.bx = pool[d % len(pool)]
        inner = [level(iv) for iv in intervals
                 if _contains(plan.interval, iv)]
        deepest = max(inner, default=d)
        if deepest - d >= len(pool):
            plan.spill_reg = mach.n_regs - 1 - d
            if plan.spill_reg < 0:
                raise TransformError(
                    f"branch at pc {plan.branch}: nesting level {d} "
                    f"exhausts the register file (n_regs={mach.n_regs}); "
                    f"no spill register left")
            spills += 1
    return spills


def _row(op: Op, **kw: int) -> list[int]:
    return list(Instr(op, **kw))


def synthesize_annotations(program: np.ndarray,
                           cfg: MachineConfig | None = None, *,
                           name: str = "",
                           strict: bool = False) -> SynthesisResult:
    """Plant BSSY/BSYNC regions, Bx spills and spin-loop YIELDs.

    Safe sites are rewritten; sites with nothing to anchor to are recorded
    in ``skipped`` (IPDom is the virtual exit, or reconvergence is already
    a WARPSYNC rendezvous); sites the pass must not touch are recorded in
    ``refused`` (CALL/RET programs, irreducible shapes).  With ``strict``
    any refusal raises :class:`TransformError`.  The rewritten program is
    always re-analyzed; synthesis introducing *errors* raises regardless.
    """
    prog = np.ascontiguousarray(np.asarray(program, dtype=np.int32))
    mach = cfg if cfg is not None else MachineConfig()
    g = ProgramCFG(prog, mach)
    skipped: list[Refusal] = []
    refused: list[Refusal] = []
    has_call = _has_call(g)

    plans: list[_Plan] = []
    for pc, op in enumerate(g.ops):
        if op != Op.BRA or not g.reachable[pc]:
            continue
        row = g.rows[pc]
        if row[F_PRED1] == 0 and row[F_PRED2] == 0:
            continue                                   # not divergent
        if not _needs_region(g, pc):
            continue
        t = g.ipostdom(pc)
        if t is None:
            refused.append(Refusal(
                pc, "no-postdominator",
                f"branch at pc {pc} has no postdominator (cannot reach an "
                f"exit); no reconvergence point exists"))
            continue
        if t == SINK:
            skipped.append(Refusal(
                pc, "ipdom-sink",
                f"branch at pc {pc} reconverges only at the virtual exit; "
                f"no BSYNC site exists (paths EXIT or fall off separately)"))
            continue
        t = _sink_through_exit_bra(g, pc, t)
        if g.ops[t] == Op.WARPSYNC:
            skipped.append(Refusal(
                pc, "warpsync-join",
                f"branch at pc {pc} reconverges at the WARPSYNC rendezvous "
                f"at pc {t}; the explicit barrier already manages it"))
            continue
        anchor = _anchor(g, pc, t)
        if has_call:
            refused.append(Refusal(
                pc, "call-ret",
                f"branch at pc {pc}: program contains CALL/RET and stages "
                f"return addresses as MOV immediates; a region spanning "
                f"pcs {anchor}..{t} would shift them — refusing to "
                f"annotate rather than mis-annotate"))
            continue
        if not anchor <= pc < t:
            refused.append(Refusal(
                pc, "unstructured",
                f"branch at pc {pc}: anchor pc {anchor} / IPDom pc {t} do "
                f"not bracket the branch; shape is not reducible to a "
                f"BSSY..BSYNC interval"))
            continue
        plans.append(_Plan(branch=pc, anchor=anchor, t=t))

    yield_headers = [h for h in _spin_headers(g)
                     if not any(g.ops[pc2] == Op.YIELD
                                for pc2 in next(lp.nodes for lp in g.loops
                                                if lp.header == h))]
    if has_call and yield_headers:
        for h in yield_headers:
            refused.append(Refusal(
                h, "call-ret",
                f"spin-loop at pc {h}: inserting YIELD would shift the "
                f"MOV-staged return addresses of this CALL/RET program"))
        yield_headers = []

    if strict and refused:
        raise TransformError(
            f"{len(refused)} site(s) refused", tuple(refused))

    if not plans and not yield_headers:
        report = analyze_program(prog, mach, name=name)
        return SynthesisResult(prog, 0, 0, 0, tuple(skipped), tuple(refused),
                               report, tuple((pc, pc) for pc in range(g.n)))

    n_spills = _allocate(plans, g.valid_regions, g, mach)

    editor = ProgramEditor(prog)
    nodes0 = list(editor.nodes)
    for plan in plans:
        plan.bsync = EditInstr(_row(Op.BSYNC, dst=plan.bx))
        plan.bssy = EditInstr(_row(Op.BSSY, dst=plan.bx), target=plan.bsync)
        if plan.spill_reg >= 0:
            plan.spill = EditInstr(
                _row(Op.BMOV_B2R, dst=plan.spill_reg, src0=plan.bx))
            plan.refill = EditInstr(
                _row(Op.BMOV_R2B, dst=plan.bx, src0=plan.spill_reg))

    def jump_refs(node: EditInstr) -> list[EditInstr]:
        # only control transfers follow a retarget; a BSSY referencing the
        # node names its own BSYNC and must never be captured
        return [r for r in editor.refs_to(node) if r.fields[F_OP] == Op.BRA]

    # Closes run before opens: when one region's BSYNC site coincides with
    # the next region's BSSY anchor (a While followed directly by an If),
    # the close must end up ABOVE the open at that shared boundary node.

    # Close phase: innermost-first at shared joins so BSYNCs stack
    # inner-above-outer.  Jumps to the join from *inside* the region (the
    # If's BRA over the then-arm) funnel through the refill/BSYNC.
    for plan in sorted(plans, key=lambda p: (p.t, -p.anchor, -p.branch)):
        at = nodes0[plan.t]
        a_pos = editor.index(nodes0[plan.anchor])
        t_pos = editor.index(at)
        first = plan.refill if plan.refill is not None else plan.bsync
        for r in jump_refs(at):
            if a_pos <= editor.index(r) < t_pos:
                r.target = first
        if plan.refill is not None:
            editor.insert_before(at, plan.refill)
        editor.insert_before(at, plan.bsync)

    # Open phase: outermost-first at equal anchors.  Jumps into the anchor
    # from *outside* the region (loop back-edges, then-labels of a
    # preceding If) land on the new BSSY; jumps from inside stay put.
    for plan in sorted(plans, key=lambda p: (p.anchor, -p.t, p.branch)):
        at = nodes0[plan.anchor]
        a_pos, t_pos = editor.index(at), editor.index(nodes0[plan.t])
        outside = [r for r in jump_refs(at)
                   if not a_pos <= editor.index(r) < t_pos]
        editor.insert_before(at, plan.bssy, capture=outside)
        if plan.spill is not None:
            editor.insert_before(at, plan.spill)

    # Phase C: spin-loop YIELDs at loop headers; every jump to the header
    # (back-edges included) must re-execute the YIELD each iteration.
    for header in yield_headers:
        at = nodes0[header]
        editor.insert_before(at, EditInstr(_row(Op.YIELD)),
                             capture=jump_refs(at))

    out = editor.encode()
    positions = editor.positions()
    pc_map = tuple((pc, positions[node]) for pc, node in enumerate(nodes0))
    report = analyze_program(out, mach, name=name)
    if report.errors:
        raise TransformError(
            f"synthesis produced {len(report.errors)} analysis error(s): "
            + ", ".join(d.code for d in report.errors),
            tuple(refused), report)
    return SynthesisResult(out, len(plans), n_spills, len(yield_headers),
                           tuple(skipped), tuple(refused), report, pc_map)
