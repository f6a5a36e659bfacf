"""Full-opcode static CFG over encoded SASS-lite programs.

Port of ``repro.analysis.cfg`` (numpy only, copied; it imports nothing of
``repro``).

This generalizes :mod:`repro_torch.core.cfg` (which builds just enough
graph to compute IPDoms for conditional branches) into the analysis
substrate the static verifier and the CFG fingerprints share:

* every opcode's successor edges — BRA targets, EXIT/RET terminations,
  CALL call+return-continuation edges, RET edges back to every call site's
  continuation, and the predicated fall-through each of those gains when
  guarded (``@P0 EXIT`` falls through for the lanes whose predicate is
  false);
* entry reachability, immediate postdominators for *every* node (pure
  Cooper–Harvey–Kennedy on the reversed graph — no networkx, so a whole
  progen corpus analyzes at >1k programs/s), natural-loop detection with
  nesting depth, BSSY→BSYNC region intervals with their static nesting
  depth, and the "first WARPSYNC rendezvous reachable from here" sets the
  structural-deadlock check consumes.

Everything is computed lazily and cached: the fingerprint path touches only
edges/loops/regions, the verifier additionally forces postdominators.

Out-of-range control-flow targets never crash graph construction — the
edge is redirected to the virtual sink and the pc recorded in
``bad_targets`` for the verifier to report as an ``error``.
"""
from __future__ import annotations

from functools import cached_property

import numpy as np

from repro_torch.core.isa import (ATOMIC_OPS, F_DST, F_IMM, F_OP, F_PRED1,
                                  F_PRED2, F_SRC0, MachineConfig, Op)

SINK = -1          # external name for the virtual exit node

# plain ints for the per-row opcode tests (an IntEnum member lookup costs
# about three times an int compare in the graph builders' inner loops)
_BRA, _EXIT, _RET, _CALL = int(Op.BRA), int(Op.EXIT), int(Op.RET), \
    int(Op.CALL)
_WARPSYNC = int(Op.WARPSYNC)

__all__ = ["SINK", "Loop", "ProgramCFG"]


class Loop:
    """One natural loop (back edges merged per header)."""

    __slots__ = ("header", "nodes", "back_edges")

    def __init__(self, header: int) -> None:
        self.header = header
        self.nodes: set[int] = {header}
        self.back_edges: list[tuple[int, int]] = []

    def __repr__(self) -> str:
        return f"Loop(header={self.header}, nodes={len(self.nodes)})"


class ProgramCFG:
    """The static control-flow graph of one encoded program.

    Nodes are pcs ``0..L-1`` plus the virtual sink (internally index ``L``;
    the public API renders it as :data:`SINK`).  ``cfg`` supplies machine
    limits (``n_bx`` bounds, warp width) to the passes that need them.
    """

    def __init__(self, program: np.ndarray,
                 cfg: MachineConfig | None = None) -> None:
        prog = np.asarray(program)
        if prog.ndim != 2:
            raise ValueError(f"program must be a 2-D table, got shape "
                             f"{prog.shape}")
        self.program = prog
        self.cfg = cfg if cfg is not None else MachineConfig()
        self.rows: list[list[int]] = prog.tolist()
        self.n = len(self.rows)
        self.sink = self.n
        self.ops = [r[F_OP] for r in self.rows]
        self.bad_targets: list[int] = []
        self.succs: list[list[int]] = self._build_succs()

    # -- construction -------------------------------------------------------

    def _edge_target(self, pc: int, t: int) -> int:
        if 0 <= t < self.n:
            return t
        self.bad_targets.append(pc)
        return self.sink

    def _build_succs(self) -> list[list[int]]:
        n, sink = self.n, self.sink
        # the interprocedural summary: RET returns to every call site's
        # continuation (see repro_torch.core.cfg.build_cfg); with no CALL in
        # the program RET degrades to an exit edge
        returns = [pc + 1 if pc + 1 < n else sink
                   for pc, op in enumerate(self.ops) if op == _CALL]
        succs: list[list[int]] = []
        for pc, row in enumerate(self.rows):
            op = row[F_OP]
            nxt = pc + 1 if pc + 1 < n else sink
            if op != _BRA and op != _EXIT and op != _RET and op != _CALL:
                succs.append([nxt])
                continue
            predicated = row[F_PRED1] != 0 or row[F_PRED2] != 0
            out: list[int] = []
            if op == _BRA:
                out.append(self._edge_target(pc, row[F_IMM]))
                if predicated:
                    out.append(nxt)
            elif op == _EXIT:
                out.append(sink)
                if predicated:
                    out.append(nxt)
            elif op == _RET:
                out.extend(returns or [sink])
                if predicated:
                    out.append(nxt)
            else:
                out.append(self._edge_target(pc, row[F_IMM]))
                out.append(nxt)          # return continuation / guarded skip
            seen: set[int] = set()
            succs.append([s for s in out
                          if not (s in seen or seen.add(s))])
        return succs

    # -- basic graph views --------------------------------------------------

    @cached_property
    def preds(self) -> list[list[int]]:
        preds: list[list[int]] = [[] for _ in range(self.n + 1)]
        for pc, out in enumerate(self.succs):
            for s in out:
                preds[s].append(pc)
        return preds

    @cached_property
    def n_edges(self) -> int:
        return sum(len(out) for out in self.succs)

    @cached_property
    def reachable(self) -> list[bool]:
        """Entry reachability (pc 0), including through CALL edges."""
        seen = [False] * (self.n + 1)
        if self.n == 0:
            return seen
        seen[0] = True
        stack = [0]
        while stack:
            for s in self.succs[stack.pop()]:
                if not seen[s]:
                    seen[s] = True
                    if s != self.sink:
                        stack.append(s)
        return seen

    # -- postdominators (CHK on the reversed graph, rooted at sink) ---------

    @cached_property
    def _ipostdom(self) -> list[int | None]:
        """Immediate postdominator per node (internal sink index space).

        ``None`` for nodes that cannot reach the sink at all (code trapped
        in an exit-free loop) — postdominance is undefined there.
        """
        n, sink = self.n, self.sink
        preds = self.preds
        # postorder DFS over the reversed graph from sink; rev-successors of
        # a node are its forward predecessors
        seen = [False] * (n + 1)
        seen[sink] = True
        order: list[int] = []
        stack: list[tuple[int, "iter"]] = [(sink, iter(preds[sink]))]
        while stack:
            node, it = stack[-1]
            descended = False
            for nb in it:
                if not seen[nb]:
                    seen[nb] = True
                    stack.append((nb, iter(preds[nb])))
                    descended = True
                    break
            if not descended:
                order.append(node)
                stack.pop()
        rpo = order[::-1]                     # sink first
        idx = [0] * (n + 1)
        for i, nd in enumerate(rpo):
            idx[nd] = i
        idom: list[int | None] = [None] * (n + 1)
        idom[sink] = sink

        def intersect(a: int, b: int) -> int:
            while a != b:
                while idx[a] > idx[b]:
                    a = idom[a]               # type: ignore[assignment]
                while idx[b] > idx[a]:
                    b = idom[b]               # type: ignore[assignment]
            return a

        changed = True
        while changed:
            changed = False
            for nd in rpo:
                if nd == sink:
                    continue
                new: int | None = None
                for s in self.succs[nd]:      # rev-preds of nd
                    if idom[s] is not None:
                        new = s if new is None else intersect(new, s)
                if new is not None and idom[nd] != new:
                    idom[nd] = new
                    changed = True
        return idom

    def ipostdom(self, pc: int) -> int | None:
        """The immediate postdominator of ``pc`` (:data:`SINK` for the
        virtual exit; ``None`` when ``pc`` cannot reach an exit)."""
        d = self._ipostdom[pc]
        if d is None:
            return None
        return SINK if d == self.sink else d

    def postdominates(self, t: int, pc: int) -> bool:
        """Whether every path from ``pc`` to an exit passes through ``t``."""
        x: int | None = pc
        for _ in range(self.n + 2):
            if x is None or x == self.sink:
                return False
            x = self._ipostdom[x]
            if x == t:
                return True
        return False

    @cached_property
    def branch_ipdoms(self) -> dict[int, int]:
        """``{branch_pc: ipdom}`` for every reachable BRA — the same map
        :func:`repro_torch.core.cfg.immediate_postdominators` computes, for
        cross-checking the two builders against each other."""
        out: dict[int, int] = {}
        for pc, op in enumerate(self.ops):
            if op == Op.BRA and self.reachable[pc]:
                d = self._ipostdom[pc]
                out[pc] = SINK if d is None or d == self.sink else d
        return out

    def straight_line(self, a: int, t: int) -> bool:
        """Whether ``a`` reaches ``t`` through single-successor nodes only
        (the BMOV-refill preamble between a region's IPDom and its BSYNC)."""
        x = a
        for _ in range(self.n + 1):
            if x == t:
                return True
            if x == self.sink or x < 0 or len(self.succs[x]) != 1:
                return False
            x = self.succs[x][0]
        return False

    # -- loops --------------------------------------------------------------

    @cached_property
    def loops(self) -> list[Loop]:
        """Natural loops of the reachable subgraph, merged per header."""
        n, sink = self.n, self.sink
        if n == 0:
            return []
        color = [0] * (n + 1)                # 0 new / 1 on stack / 2 done
        back: list[tuple[int, int]] = []
        color[0] = 1
        stack: list[tuple[int, "iter"]] = [(0, iter(self.succs[0]))]
        while stack:
            node, it = stack[-1]
            descended = False
            for nb in it:
                if nb == sink:
                    continue
                if color[nb] == 0:
                    color[nb] = 1
                    stack.append((nb, iter(self.succs[nb])))
                    descended = True
                    break
                if color[nb] == 1:
                    back.append((node, nb))
            if not descended:
                color[node] = 2
                stack.pop()
        by_header: dict[int, Loop] = {}
        preds, reachable = self.preds, self.reachable
        for u, h in back:
            loop = by_header.setdefault(h, Loop(h))
            loop.back_edges.append((u, h))
            # natural loop body: everything that reaches u without passing h
            nodes = loop.nodes
            work = [u]
            while work:
                x = work.pop()
                if x in nodes:
                    continue
                nodes.add(x)
                for p in preds[x]:
                    if p != sink and reachable[p]:
                        work.append(p)
        return [by_header[h] for h in sorted(by_header)]

    @cached_property
    def max_loop_depth(self) -> int:
        loops = self.loops
        depth = 0
        for lp in loops:
            depth = max(depth, sum(1 for other in loops
                                   if lp.header in other.nodes))
        return depth

    def loop_has(self, loop: Loop, ops: "frozenset[int] | set[int]") -> bool:
        return any(self.ops[pc] in ops for pc in loop.nodes)

    def loop_has_exit(self, loop: Loop) -> bool:
        """Whether any node in the loop has an edge leaving it (the sink —
        an EXIT or a fall-off — counts as leaving)."""
        return any(s not in loop.nodes
                   for pc in loop.nodes for s in self.succs[pc])

    # -- BSSY regions -------------------------------------------------------

    @cached_property
    def regions(self) -> list[tuple[int, int, int]]:
        """Every BSSY as ``(bssy_pc, bx, target_pc)`` in program order.
        Targets are raw (possibly out of range) — the verifier validates."""
        return [(pc, self.rows[pc][F_DST], self.rows[pc][F_IMM])
                for pc, op in enumerate(self.ops) if op == Op.BSSY]

    @cached_property
    def valid_regions(self) -> list[tuple[int, int, int]]:
        """Regions whose target really is a BSYNC on the same Bx."""
        return [(p, b, t) for p, b, t in self.regions
                if 0 <= t < self.n and self.ops[t] == Op.BSYNC
                and self.rows[t][F_DST] == b]

    @cached_property
    def max_region_depth(self) -> int:
        """Maximum static BSSY..BSYNC interval nesting — the divergence
        stack depth the Bx file must hold (spills excluded)."""
        depth = 0
        for p, _, t in self.valid_regions:
            d = 1 + sum(1 for p2, _, t2 in self.valid_regions
                        if p2 < p and p < t2)
            depth = max(depth, d)
        return depth

    def innermost_region(self, pc: int) -> tuple[int, int, int] | None:
        """The tightest valid BSSY region strictly containing ``pc``."""
        best: tuple[int, int, int] | None = None
        for p, b, t in self.valid_regions:
            if p < pc < t and (best is None or t - p < best[2] - best[0]):
                best = (p, b, t)
        return best

    # -- WARPSYNC rendezvous ------------------------------------------------

    @cached_property
    def first_warpsync(self) -> list[frozenset[int]]:
        """Per node: the set of WARPSYNC pcs that can be the *first*
        rendezvous a lane starting at that node encounters.

        Lanes that EXIT (or fall off the end) before any WARPSYNC
        contribute nothing — a finished lane counts as arrived at every
        barrier.  ``first_warpsync[0]`` holding two different pcs means a
        divergent warp can park one subset at each: the structural-DEADLOCK
        class ``volta_itps`` reports, detected without executing."""
        n, sink = self.n, self.sink
        fw: list[frozenset[int]] = [frozenset()] * (n + 1)
        if _WARPSYNC not in self.ops:
            return fw                        # the fixpoint is all empty
        changed = True
        while changed:
            changed = False
            for pc in range(n - 1, -1, -1):
                if not self.reachable[pc]:
                    continue
                row = self.rows[pc]
                if self.ops[pc] == Op.WARPSYNC:
                    s = {pc}
                    if row[F_PRED1] != 0 or row[F_PRED2] != 0:
                        nxt = pc + 1 if pc + 1 < n else sink
                        s |= fw[nxt]         # guarded-off lanes skip it
                    new = frozenset(s)
                else:
                    acc: set[int] = set()
                    for s2 in self.succs[pc]:
                        acc |= fw[s2]
                    new = frozenset(acc)
                if new != fw[pc]:
                    fw[pc] = new
                    changed = True
        return fw

    # -- misc counts shared with the fingerprint ----------------------------

    @cached_property
    def op_counts(self) -> dict[int, int]:
        counts: dict[int, int] = {}
        for op in self.ops:
            counts[op] = counts.get(op, 0) + 1
        return counts

    @cached_property
    def block_leaders(self) -> list[int]:
        """Basic-block leader pcs among reachable code."""
        if self.n == 0:
            return []
        leaders = {0}
        for pc, out in enumerate(self.succs):
            if not self.reachable[pc]:
                continue
            multi = len(out) > 1
            for s in out:
                if s != self.sink and (multi or s != pc + 1):
                    leaders.add(s)
        return sorted(pc for pc in leaders if self.reachable[pc])

    @cached_property
    def n_atomics(self) -> int:
        return sum(1 for op in self.ops if op in ATOMIC_OPS)

    def breaks_on(self, bx: int, lo: int, hi: int) -> list[int]:
        """BREAK pcs naming ``bx`` strictly inside ``(lo, hi)``."""
        return [pc for pc in range(lo + 1, hi)
                if self.ops[pc] == Op.BREAK and self.rows[pc][F_DST] == bx]

    def spills_of(self, bx: int, lo: int, hi: int) -> list[int]:
        """BMOV B→R saves of ``bx`` strictly inside ``(lo, hi)``."""
        return [pc for pc in range(lo + 1, hi)
                if self.ops[pc] == Op.BMOV_B2R
                and self.rows[pc][F_SRC0] == bx]
