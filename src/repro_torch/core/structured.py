"""Structured-program compiler for SASS-lite.

NVIDIA's compiler algorithms for placing BSSY/BSYNC/BMOV/BREAK/YIELD are not
disclosed (paper SS X: "we do not know the detailed algorithms NVIDIA's
compiler uses").  This module implements a *plausible* pass with the exact
properties the paper observes:

* every divergence region is bracketed ``BSSY Bx, sync`` ... ``BSYNC Bx`` with
  the BSSY target pointing AT the BSYNC instruction (SS V-E);
* Bx registers are allocated round-robin over the small Bx file; a region
  whose subtree will reuse its physical Bx spills it to a high-numbered Rx
  right after BSSY and refills right before its BSYNC (SS VI-A / Fig 5).
  Spilling is demand-driven: a resident (unspilled) Bx is required both for
  BREAK (it edits the live mask, SS VI-B) and for YIELD's sibling check
  (SS VII-C) — spilling everything would starve both, which is why the paper's
  compiler also keeps masks resident when it can;
* loops whose body contains atomics get a YIELD at the loop head so a thread
  holding a lock can make progress (SS VI-C / Fig 7);
* ``break_pred`` on a loop lowers to BREAK + a jump PAST the loop's BSYNC:
  broken threads never reach that reconvergence point, exactly the Fig 6
  early-reconvergence shape.

The pass emits assembler text (readable in failure logs) and assembles it.
Property tests drive random ASTs through this pass and check that Hanoi
matches the per-thread scalar reference exactly.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from .asm import assemble
from .isa import MachineConfig

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass
class Raw:
    """Straight-line assembler lines (no control flow)."""
    lines: list[str]


@dataclass
class If:
    """``if (P<pred>) then_ else else_`` — cond lines must set P<pred>."""
    cond: list[str]
    pred: int
    then_: "Node"
    else_: "Node | None" = None


@dataclass
class While:
    """``while (P<pred>) body`` — cond lines re-evaluated every iteration."""
    cond: list[str]
    pred: int
    body: "Node"
    yield_at_head: bool = False     # forced; auto-set when body has atomics
    break_pred: int | None = None   # early exit past the BSYNC via BREAK


@dataclass
class Seq:
    items: list["Node"]


Node = Raw | If | While | Seq


_ATOMICS = ("ATOMCAS", "ATOMEXCH", "ATOMADD")


def _has_atomics(n: Node) -> bool:
    if isinstance(n, Raw):
        return any(a in ln.upper() for ln in n.lines for a in _ATOMICS)
    if isinstance(n, Seq):
        return any(_has_atomics(i) for i in n.items)
    if isinstance(n, If):
        return (_has_atomics(n.then_)
                or (n.else_ is not None and _has_atomics(n.else_))
                or any(a in ln.upper() for ln in n.cond for a in _ATOMICS))
    if isinstance(n, While):
        return (_has_atomics(n.body)
                or any(a in ln.upper() for ln in n.cond for a in _ATOMICS))
    raise TypeError(n)


def region_depth(n: Node) -> int:
    """Maximum number of nested divergence regions within ``n``."""
    if isinstance(n, Raw):
        return 0
    if isinstance(n, Seq):
        return max((region_depth(i) for i in n.items), default=0)
    if isinstance(n, If):
        inner = max(region_depth(n.then_),
                    region_depth(n.else_) if n.else_ is not None else 0)
        return 1 + inner
    if isinstance(n, While):
        return 1 + region_depth(n.body)
    raise TypeError(n)


def count_breaks(n: Node) -> int:
    if isinstance(n, Raw):
        return 0
    if isinstance(n, Seq):
        return sum(count_breaks(i) for i in n.items)
    if isinstance(n, If):
        return (count_breaks(n.then_)
                + (count_breaks(n.else_) if n.else_ is not None else 0))
    if isinstance(n, While):
        return (1 if n.break_pred is not None else 0) + count_breaks(n.body)
    raise TypeError(n)


@dataclass
class _Ctx:
    """Bx allocation: BREAK-bearing loops let broken threads race past the
    loop's BSYNC while its REC entry is still live, so their reconvergence
    mask must never be clobbered by a later sibling region.  NVIDIA's
    register-allocation strategy is undisclosed (SS X); we conservatively
    DEDICATE one Bx per BREAK loop (allocated from the top of the file) and
    cycle the remaining pool over regular regions, spilling on reuse."""
    cfg: MachineConfig
    pool: int = 0                   # regular registers: indices [0, pool)
    labels: "itertools.count" = field(default_factory=itertools.count)
    dedicated: "itertools.count" = field(default_factory=itertools.count)
    depth: int = 0
    loop_depth: int = 0

    def label(self, stem: str) -> str:
        return f"{stem}_{next(self.labels)}"

    def bx(self) -> int:
        return self.depth % self.pool

    def dedicated_bx(self) -> int:
        return self.cfg.n_bx - 1 - next(self.dedicated)

    def spill_reg(self) -> int:
        r = self.cfg.n_regs - 1 - self.depth
        if r < 0:
            raise ValueError("divergence nesting exceeds spill registers")
        return r

    def needs_spill(self, inner_depth: int) -> bool:
        # the physical Bx is reused by a descendant iff nesting >= pool size
        return inner_depth >= self.pool


def _emit(n: Node, ctx: _Ctx, out: list[str]) -> None:
    if isinstance(n, Raw):
        out.extend(n.lines)
        return
    if isinstance(n, Seq):
        for item in n.items:
            _emit(item, ctx, out)
        return

    bx, sr = ctx.bx(), ctx.spill_reg()
    if isinstance(n, If):
        inner = max(region_depth(n.then_),
                    region_depth(n.else_) if n.else_ is not None else 0)
        spill = ctx.needs_spill(inner)
        then_l, rest_l, sync_l = (ctx.label("then"), ctx.label("rest"),
                                  ctx.label("sync"))
        out += [f"BSSY B{bx}, {sync_l}"]
        if spill:
            out += [f"BMOV R{sr}, B{bx}"]
        out += n.cond
        out += [f"@P{n.pred} BRA {then_l}"]
        ctx.depth += 1
        if n.else_ is not None:
            _emit(n.else_, ctx, out)
        out += [f"BRA {rest_l}", f"{then_l}:"]
        _emit(n.then_, ctx, out)
        ctx.depth -= 1
        out += [f"{rest_l}:"]
        if spill:
            out += [f"BMOV B{bx}, R{sr}"]
        out += [f"{sync_l}:", f"BSYNC B{bx}"]
        return

    if isinstance(n, While):
        inner = region_depth(n.body)
        if n.break_pred is not None:
            if ctx.loop_depth > 0:
                # broken threads jump past this loop's BSYNC; inside an outer
                # loop they would race around the back-edge and re-enter the
                # region while its REC entry is live.  BREAK is only used for
                # FORWARD unstructured exits (Fig 6) — structured breaks pass
                # through the BSYNC instead.
                raise ValueError("BREAK loop may not nest inside another loop")
            bx, spill = ctx.dedicated_bx(), False
        else:
            spill = ctx.needs_spill(inner)
        loop_l, body_l = ctx.label("loop"), ctx.label("body")
        rest_l, sync_l, post_l = (ctx.label("wrest"), ctx.label("wsync"),
                                  ctx.label("wpost"))
        out += [f"BSSY B{bx}, {sync_l}"]
        if spill:
            out += [f"BMOV R{sr}, B{bx}"]
        out += [f"{loop_l}:"]
        if n.yield_at_head or _has_atomics(n.body):
            out += ["YIELD"]               # deadlock avoidance (SS VI-C)
        out += n.cond
        out += [f"@P{n.pred} BRA {body_l}", f"BRA {rest_l}", f"{body_l}:"]
        ctx.depth += 1
        ctx.loop_depth += 1
        if n.break_pred is not None:
            # remove early-exiting threads from the reconvergence mask and
            # route them PAST the BSYNC (SS VI-B / Fig 6)
            out += [f"@P{n.break_pred} BREAK P{n.break_pred}, B{bx}",
                    f"@P{n.break_pred} BRA {post_l}"]
        _emit(n.body, ctx, out)
        ctx.depth -= 1
        ctx.loop_depth -= 1
        out += [f"BRA {loop_l}", f"{rest_l}:"]
        if spill:
            out += [f"BMOV B{bx}, R{sr}"]
        out += [f"{sync_l}:", f"BSYNC B{bx}", f"{post_l}:"]
        return

    raise TypeError(f"unknown node {n!r}")


def emit_text(node: Node, cfg: MachineConfig = MachineConfig(),
              *, add_exit: bool = True) -> str:
    n_breaks = count_breaks(node)
    pool = cfg.n_bx - n_breaks
    if pool < 1:
        raise ValueError(
            f"{n_breaks} BREAK loops need dedicated Bx registers but the "
            f"file only has {cfg.n_bx}; enlarge n_bx or reduce breaks")
    out: list[str] = []
    _emit(node, _Ctx(cfg, pool=pool), out)
    if add_exit:
        out.append("EXIT")
    return "\n".join(out)


def compile_structured(node: Node,
                       cfg: MachineConfig = MachineConfig(),
                       *, add_exit: bool = True) -> np.ndarray:
    """Lower a structured AST to an assembled SASS-lite program table."""
    return assemble(emit_text(node, cfg, add_exit=add_exit))
