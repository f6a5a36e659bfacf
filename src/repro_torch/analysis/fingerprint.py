"""Per-program CFG fingerprints for control-flow similarity search.

Port of ``repro.analysis.fingerprint`` (numpy only, copied; it imports nothing of
``repro``).

Implements the static side of "A Similarity Measure for GPU Kernel
Subgraph Matching" (arXiv 1707.02423): each program's control-flow graph
is summarized into a fixed-length vector of degree / loop / branch /
region features, and two programs are compared with a Canberra-style
distance over those vectors.  A fingerprint costs microseconds to compute
and ~200 bytes to store, so the archive stamps one into every run's
begin-event meta and sidecar index entry — "find archived runs whose
control flow resembles this pathology" then never replays a trace.

Versioned: bump :data:`FP_VERSION` whenever :data:`FEATURES` changes so
stale archive stamps are recomputed rather than compared across formats.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.core.isa import (F_PRED1, F_PRED2, MEMORY_OPS, MachineConfig,
                            Op)

from .cfg import ProgramCFG

FP_VERSION = 1

#: Feature names, in vector order.  Counts are raw (size-sensitive, per the
#: paper's finding that kernel scale matters) except the ``frac_*`` and
#: ``avg_*`` entries, which are shape-relative.
FEATURES: tuple[str, ...] = (
    "n_instr", "n_edges", "n_blocks", "cyclomatic",
    "n_cond_branch", "n_uncond_branch", "n_back_edges", "n_loops",
    "max_loop_depth", "n_regions", "max_region_depth",
    "n_break", "n_call", "n_ret", "n_warpsync", "n_yield",
    "n_atomic", "n_mem", "n_pred_instr",
    "frac_branch_nodes", "frac_join_nodes", "avg_block_len",
)

__all__ = ["FEATURES", "FP_VERSION", "distance", "fingerprint",
           "fingerprint_meta", "rank"]

_CACHE: "OrderedDict[bytes, tuple[float, ...]]" = OrderedDict()
_CACHE_CAP = 4096


def fingerprint(program: np.ndarray,
                cfg: MachineConfig | None = None) -> tuple[float, ...]:
    """The feature vector of ``program``, aligned with :data:`FEATURES`."""
    prog = np.ascontiguousarray(np.asarray(program, dtype=np.int32))
    return _cached(prog.tobytes(), lambda: ProgramCFG(prog, cfg))


def graph_fingerprint(g: ProgramCFG) -> tuple[float, ...]:
    """:func:`fingerprint` of ``g.program`` from a graph the caller has
    built already (the verifier's), so its loops, reachability and blocks
    are computed once.  No feature reads ``g.cfg``."""
    prog = np.ascontiguousarray(np.asarray(g.program, dtype=np.int32))
    return _cached(prog.tobytes(), lambda: g)


def _cached(key: bytes, graph) -> tuple[float, ...]:
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        return hit
    fp = _compute(graph())
    _CACHE[key] = fp
    if len(_CACHE) > _CACHE_CAP:
        _CACHE.popitem(last=False)
    return fp


def _compute(g: ProgramCFG) -> tuple[float, ...]:
    n = g.n
    counts = g.op_counts
    n_cond = n_uncond = 0
    for pc, op in enumerate(g.ops):
        if op == Op.BRA:
            row = g.rows[pc]
            if row[F_PRED1] != 0 or row[F_PRED2] != 0:
                n_cond += 1
            else:
                n_uncond += 1
    n_blocks = max(1, len(g.block_leaders))
    n_branch_nodes = sum(1 for out in g.succs if len(out) > 1)
    n_join_nodes = sum(1 for p in g.preds[:n] if len(p) > 1)
    n_reach = sum(g.reachable[:n])
    vals = {
        "n_instr": n,
        "n_edges": g.n_edges,
        "n_blocks": n_blocks,
        # E - N + 2 over the connected reachable component
        "cyclomatic": g.n_edges - (n + 1) + 2,
        "n_cond_branch": n_cond,
        "n_uncond_branch": n_uncond,
        "n_back_edges": sum(len(lp.back_edges) for lp in g.loops),
        "n_loops": len(g.loops),
        "max_loop_depth": g.max_loop_depth,
        "n_regions": len(g.regions),
        "max_region_depth": g.max_region_depth,
        "n_break": counts.get(Op.BREAK, 0),
        "n_call": counts.get(Op.CALL, 0),
        "n_ret": counts.get(Op.RET, 0),
        "n_warpsync": counts.get(Op.WARPSYNC, 0),
        "n_yield": counts.get(Op.YIELD, 0),
        "n_atomic": g.n_atomics,
        "n_mem": sum(1 for op in g.ops if op in MEMORY_OPS),
        "n_pred_instr": sum(1 for r in g.rows
                            if r[F_PRED1] != 0 or r[F_PRED2] != 0),
        "frac_branch_nodes": n_branch_nodes / n if n else 0.0,
        "frac_join_nodes": n_join_nodes / n if n else 0.0,
        "avg_block_len": (n_reach / n_blocks) if n_blocks else 0.0,
    }
    # rounded at the source so a recomputed fingerprint is bit-identical
    # to one round-tripped through a JSON archive stamp — self-matches
    # rank at exactly 0.0 regardless of which side the query came from
    return tuple(round(float(vals[name]), 6) for name in FEATURES)


def fingerprint_meta(program: np.ndarray,
                     cfg: MachineConfig | None = None) -> dict:
    """The JSON-ready form archives stamp: ``{"v": version, "f": [...]}``."""
    return {"v": FP_VERSION,
            "f": [round(x, 6) for x in fingerprint(program, cfg)]}


def distance(a, b) -> float:
    """Canberra-style distance between two fingerprints, in ``[0, 1]``.

    Mean over features of ``|a_i - b_i| / (|a_i| + |b_i|)`` with 0/0
    terms scored 0 — scale-free per feature, and *exactly* 0.0 for a
    self-match (the ``archive similar`` ranking contract).
    """
    a = tuple(a)
    b = tuple(b)
    if len(a) != len(b):
        raise ValueError(f"fingerprint length mismatch: {len(a)} vs {len(b)}")
    if not a:
        return 0.0
    total = 0.0
    for x, y in zip(a, b):
        denom = abs(x) + abs(y)
        if denom:
            total += abs(x - y) / denom
    return total / len(a)


def rank(query, candidates, *, top: int | None = None):
    """Rank ``candidates`` — an iterable of ``(key, fingerprint)`` — by
    ascending :func:`distance` to ``query``.  Returns ``(key, dist)``
    pairs; ties break on key for determinism."""
    scored = sorted(((distance(query, fp), key) for key, fp in candidates
                     if fp is not None))
    out = [(key, d) for d, key in scored]
    return out[:top] if top is not None else out
