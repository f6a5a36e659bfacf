"""Divergence management at tile granularity — the Hanoi insight transferred
to TPU masked execution (DESIGN.md SS2b).

Port of ``repro.core.divergence`` (numpy only, copied).

A warp's *active mask* becomes a tile grid's activity classification:

* EMPTY   — path never scheduled (Hanoi: never pushed to the WS stack);
* PARTIAL — predicated execution (threads masked within the path);
* FULL    — the reconverged fast path.

``classify_grid`` produces the census for any (causal, window, kv_len)
attention pattern; the Pallas flash-attention kernel consumes the same
predicate arithmetic at schedule time (repro_torch.kernels.flash_attention), and
the MoE dispatch uses the path/BREAK vocabulary for capacity-dropped tokens
(repro.models.moe).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EMPTY, PARTIAL, FULL = 0, 1, 2


@dataclass(frozen=True)
class MaskSpec:
    causal: bool = True
    window: int = 0          # <=0: unlimited
    kv_len: int | None = None


def classify_tile(qs: int, ks: int, bq: int, bk: int,
                  spec: MaskSpec, kv_len: int) -> int:
    q_min, q_max = qs, qs + bq - 1
    k_min, k_max = ks, ks + bk - 1
    empty, full = False, True
    if spec.causal:
        empty |= k_min > q_max
        full &= k_max <= q_min
    if spec.window and spec.window > 0:
        empty |= k_max < q_min - spec.window + 1
        full &= k_min >= q_max - spec.window + 1
    empty |= k_min >= kv_len
    full &= k_max < kv_len
    return EMPTY if empty else (FULL if full else PARTIAL)


def classify_grid(sq: int, sk: int, spec: MaskSpec, *,
                  bq: int = 128, bk: int = 128) -> np.ndarray:
    """int8 grid [nq, nk] of EMPTY/PARTIAL/FULL."""
    kv_len = sk if spec.kv_len is None else spec.kv_len
    nq, nk = -(-sq // bq), -(-sk // bk)
    g = np.empty((nq, nk), np.int8)
    for i in range(nq):
        for j in range(nk):
            g[i, j] = classify_tile(i * bq, j * bk, bq, bk, spec, kv_len)
    return g


def census(grid: np.ndarray) -> dict:
    total = grid.size
    empty = int((grid == EMPTY).sum())
    partial = int((grid == PARTIAL).sum())
    full = int((grid == FULL).sum())
    return {
        "total": total, "empty": empty, "partial": partial, "full": full,
        # fraction of tile-FLOPs that must execute (EMPTY skipped = the
        # Hanoi "path never scheduled" saving)
        "flops_kept_frac": (partial + full) / total,
        # predication overhead share (PARTIAL = masked-lane execution)
        "mask_overhead_frac": partial / max(1, partial + full),
        # the SIMD-utilization analogue: useful lanes / scheduled lanes,
        # assuming PARTIAL tiles average half-live lanes
        "tile_utilization": (full + 0.5 * partial) / max(1, full + partial),
    }


def schedule_order(grid: np.ndarray) -> list[tuple[int, int]]:
    """Execution order for live tiles, FULL-majority first per row — the
    WS-stack 'majority path first' policy applied to tile scheduling."""
    order = []
    for i in range(grid.shape[0]):
        row = [(i, j) for j in range(grid.shape[1]) if grid[i, j] != EMPTY]
        row.sort(key=lambda t: 0 if grid[t[0], t[1]] == FULL else 1)
        order.extend(row)
    return order
