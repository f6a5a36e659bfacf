"""Instruction-level CFG analysis: immediate post-dominators (IPDom).

Port of ``repro.core.cfg`` without ``networkx``, which the machine with the
card does not have.  Pre-Volta control-flow management reconverges at IPDom
points (paper SS II); the compiler assist there was a per-branch
reconvergence PC.  We compute it from the program table — this stands in for
the SSY annotations an NVIDIA compiler would have emitted for a pre-Volta
target.

The graph is a successor dict over the same nodes as the reference's
``nx.DiGraph`` (program counters, out-of-range branch targets, and the
virtual ``SINK``); the dominators of the reversed graph come from the
iterative Cooper-Harvey-Kennedy pass, the algorithm behind
``nx.immediate_dominators``.  Immediate dominators are unique, so the result
is the reference's, node for node.
"""
from __future__ import annotations

import numpy as np

from .isa import F_IMM, F_OP, F_PRED1, F_PRED2, Op

SINK = -1


def build_cfg(program: np.ndarray) -> dict[int, list[int]]:
    """``{node: successors}`` of the program's control-flow graph; every
    node that appears as an edge's end is a key."""
    prog = np.asarray(program)
    L = prog.shape[0]
    succ: dict[int, list[int]] = {SINK: []}

    def edge(a: int, b: int) -> None:
        out = succ.setdefault(a, [])
        if b not in out:
            out.append(b)
        succ.setdefault(b, [])

    # RET is an indirect jump through a register, but the calling convention
    # (programs stage `pc+1` of the CALL into the return register) means it
    # resolves to some call site's continuation.  Modeling RET as an edge to
    # every continuation — instead of straight to SINK — keeps the function
    # body on the path between a call site and its join, so IPDoms
    # downstream of a call site are the actual reconvergence points rather
    # than SINK.  With no CALL in the program, RET degrades to an exit.
    returns = [pc + 1 if pc + 1 < L else SINK
               for pc in range(L) if int(prog[pc, F_OP]) == Op.CALL]
    for pc in range(L):
        op = int(prog[pc, F_OP])
        predicated = int(prog[pc, F_PRED1]) != 0 or int(prog[pc, F_PRED2]) != 0
        nxt = pc + 1 if pc + 1 < L else SINK
        if op == Op.BRA:
            edge(pc, int(prog[pc, F_IMM]))
            if predicated:
                edge(pc, nxt)
        elif op == Op.EXIT:
            edge(pc, SINK)
            if predicated:
                edge(pc, nxt)
        elif op == Op.RET:
            for r in (returns or [SINK]):
                edge(pc, r)
            if predicated:
                edge(pc, nxt)
        elif op == Op.CALL:
            edge(pc, int(prog[pc, F_IMM]))
            edge(pc, nxt)     # return continuation / predicated skip
        else:
            edge(pc, nxt)
    return succ


def _reachable(succ: dict[int, list[int]], start: int) -> set[int]:
    seen, todo = {start}, [start]
    while todo:
        for nxt in succ.get(todo.pop(), ()):
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
    return seen


def _immediate_dominators(succ: dict[int, list[int]],
                          start: int) -> dict[int, int]:
    """Immediate dominators of the nodes reachable from ``start`` (which
    maps to itself): Cooper, Harvey and Kennedy's iterative pass over
    reverse postorder."""
    if start not in succ:
        raise ValueError(f"start {start} is not in the graph")
    preds: dict[int, list[int]] = {n: [] for n in succ}
    for a, outs in succ.items():
        for b in outs:
            preds[b].append(a)
    order: list[int] = []              # postorder, by an explicit DFS
    seen, stack = {start}, [(start, iter(succ[start]))]
    while stack:
        node, it = stack[-1]
        for nxt in it:
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, iter(succ[nxt])))
                break
        else:
            order.append(node)
            stack.pop()
    rank = {n: i for i, n in enumerate(order)}
    idom = {start: start}

    def intersect(a: int, b: int) -> int:
        while a != b:
            while rank[a] < rank[b]:
                a = idom[a]
            while rank[b] < rank[a]:
                b = idom[b]
        return a

    changed = True
    while changed:
        changed = False
        for node in reversed(order[:-1]):
            new = None
            for p in preds[node]:
                if p in idom:
                    new = p if new is None else intersect(p, new)
            if idom.get(node) != new:
                idom[node] = new
                changed = True
    return idom


def immediate_postdominators(program: np.ndarray) -> dict[int, int]:
    """``{branch_pc: ipdom_pc}`` for every conditional BRA in the program.

    IPDom(pc) is the immediate dominator of pc in the reversed CFG rooted at
    the virtual SINK.  Unreachable code maps to SINK (-1).
    """
    prog = np.asarray(program)
    succ = build_cfg(prog)
    # restrict to nodes reachable from entry, else idom is undefined
    reachable = _reachable(succ, 0)
    rsucc = {n: [] for n in reachable}          # the reversed subgraph
    for a in reachable:
        for b in succ.get(a, ()):
            if b in reachable:
                rsucc[b].append(a)
    idom = _immediate_dominators(rsucc, SINK)
    out: dict[int, int] = {}
    for pc in range(prog.shape[0]):
        if int(prog[pc, F_OP]) == Op.BRA and pc in reachable:
            out[pc] = int(idom.get(pc, SINK))
    return out
