"""repro_torch.analysis.cost — static cost model for SASS-lite programs.

Port of ``repro.analysis.cost`` (numpy only, copied; it imports nothing of
``repro``).

Predicts, without executing, roughly how expensive a program will be on
the :mod:`repro_torch.timing` cycle engine: every reachable instruction is
weighted by a loop-trip multiplier (``trip`` per enclosing loop level)
and priced by its :class:`~repro_torch.timing.CycleConfig` latency class
(control / ALU / memory / atomic, with the memory model's expected
latency for sampled models).  On top of the issue estimate the model
reports the structural facts the paper ties to control-flow cost: the
peak reconvergence-stack depth (nested BSSY regions), the sizes of the
divergent regions, and the predicted issue/stall mix.

The model is deliberately coarse — it knows nothing about warp count,
scoreboard hazards, or actual trip counts — but it is *monotone* in the
right things, which is what an optimization pass needs: more divergent
work, deeper nesting, and more long-latency memory traffic all raise the
estimate.  ``tests/test_transform.py`` gates a Spearman rank correlation
between :func:`estimate` and measured ``simulate_cycle`` cycles over the
benchmark suite, so the ordering stays honest as either side evolves.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.isa import ATOMIC_OPS, F_OP, MachineConfig, Op

from .cfg import ProgramCFG

__all__ = ["CostEstimate", "estimate", "rank_correlation"]

_MEM_OPS = frozenset({int(Op.LDG), int(Op.STG)})
_ATOMIC_OPS = frozenset(int(op) for op in ATOMIC_OPS)


def _expected_memory_latency(cycle_cfg) -> float:
    """Expected LDG/STG latency under the config's memory model."""
    model = getattr(cycle_cfg, "memory_model", "fixed")
    if model == "uniform":
        return (cycle_cfg.memory_latency_lo + cycle_cfg.memory_latency_hi) / 2.0
    if model == "bimodal":
        rate = cycle_cfg.memory_hit_rate
        return (rate * cycle_cfg.memory_hit_latency
                + (1.0 - rate) * cycle_cfg.memory_latency)
    return float(cycle_cfg.memory_latency)


@dataclass(frozen=True)
class CostEstimate:
    """Static cost prediction for one program (see module docstring).

    ``issue_cycles`` is the headline number: the latency-weighted,
    trip-weighted sum over reachable instructions.  The ``*_cycles``
    fields partition it by latency class; ``weighted_instructions`` is
    the same sum with every latency set to 1 (a static trace-length
    guess).  ``stack_depth`` / ``region_sizes`` / ``divergent_fraction``
    expose the control-flow-management structure the estimate rests on.
    """

    issue_cycles: float
    weighted_instructions: float
    control_cycles: float
    alu_cycles: float
    memory_cycles: float
    atomic_cycles: float
    stack_depth: int
    region_sizes: tuple[int, ...] = ()
    divergent_fraction: float = 0.0
    spin_loops: int = 0
    trip: int = 8

    @property
    def stall_fraction(self) -> float:
        """Predicted share of cycles spent waiting on memory/atomics."""
        if self.issue_cycles <= 0:
            return 0.0
        return (self.memory_cycles + self.atomic_cycles) / self.issue_cycles

    def render(self) -> str:
        parts = [f"issue={self.issue_cycles:.0f}",
                 f"instrs={self.weighted_instructions:.0f}",
                 f"stack_depth={self.stack_depth}",
                 f"divergent={self.divergent_fraction:.0%}",
                 f"stall={self.stall_fraction:.0%}"]
        if self.spin_loops:
            parts.append(f"spin_loops={self.spin_loops}")
        return " ".join(parts)


def estimate(program, cfg: MachineConfig | None = None, *,
             cycle_cfg=None, trip: int = 8) -> CostEstimate:
    """Statically price ``program`` against ``cycle_cfg`` latencies.

    ``trip`` is the assumed iteration count per loop-nesting level: an
    instruction inside ``k`` nested loops contributes ``trip**k`` times
    its class latency.  Unreachable instructions contribute nothing.
    """
    from repro_torch.timing import CycleConfig  # local: keep import cycle short
    if cfg is None:
        cfg = MachineConfig()
    if cycle_cfg is None:
        cycle_cfg = CycleConfig()
    if trip < 1:
        raise ValueError(f"trip must be >= 1, got {trip}")
    g = program if isinstance(program, ProgramCFG) else ProgramCFG(program)

    mem_lat = _expected_memory_latency(cycle_cfg)
    loop_sets = [loop.nodes for loop in g.loops]
    regions = g.valid_regions

    control = alu = mem = atomic = instrs = 0.0
    divergent_weight = total_weight = 0.0
    for pc in range(g.n):
        if not g.reachable[pc]:
            continue
        weight = float(trip ** sum(1 for nodes in loop_sets if pc in nodes))
        op = g.ops[pc]
        if op in _ATOMIC_OPS:
            atomic += weight * cycle_cfg.atomic_latency
        elif op in _MEM_OPS:
            mem += weight * mem_lat
        elif Op(op) in _CONTROL_OPS:
            control += weight * cycle_cfg.control_latency
        else:
            alu += weight * cycle_cfg.alu_latency
        instrs += weight
        total_weight += weight
        if any(p < pc < t for p, _bx, t in regions):
            divergent_weight += weight

    issue = control + alu + mem + atomic
    spin = sum(1 for loop in g.loops
               if g.loop_has(loop, ATOMIC_OPS) and g.loop_has_exit(loop))
    return CostEstimate(
        issue_cycles=issue,
        weighted_instructions=instrs,
        control_cycles=control,
        alu_cycles=alu,
        memory_cycles=mem,
        atomic_cycles=atomic,
        stack_depth=g.max_region_depth,
        region_sizes=tuple(sorted(t - p - 1 for p, _bx, t in regions)),
        divergent_fraction=(divergent_weight / total_weight
                            if total_weight else 0.0),
        spin_loops=spin,
        trip=trip,
    )


# control-latency ops, mirroring repro_torch.timing's taxonomy without importing
# its private set (the two are cross-checked in tests)
_CONTROL_OPS = frozenset({
    Op.BRA, Op.EXIT, Op.BSSY, Op.BSYNC, Op.BMOV_B2R, Op.BMOV_R2B,
    Op.BREAK, Op.WARPSYNC, Op.YIELD, Op.CALL, Op.RET, Op.NOP,
})


def _ranks(values) -> list[float]:
    """Average ranks (1-based) with ties sharing their mean rank."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and values[order[j + 1]] == values[order[i]]:
            j += 1
        mean = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = mean
        i = j + 1
    return ranks


def rank_correlation(xs, ys) -> float:
    """Spearman rank correlation of two equal-length sequences.

    Hand-rolled (Pearson over average ranks) so the gate has no SciPy
    dependency.  Returns 0.0 for degenerate inputs (< 2 points, or a
    constant sequence).
    """
    xs, ys = list(xs), list(ys)
    if len(xs) != len(ys):
        raise ValueError(f"length mismatch: {len(xs)} vs {len(ys)}")
    if len(xs) < 2:
        return 0.0
    rx = np.asarray(_ranks(xs), dtype=np.float64)
    ry = np.asarray(_ranks(ys), dtype=np.float64)
    sx, sy = rx.std(), ry.std()
    if sx == 0.0 or sy == 0.0:
        return 0.0
    return float(((rx - rx.mean()) * (ry - ry.mean())).mean() / (sx * sy))
