"""Control-flow trace comparison (paper SS IX).

A control-flow trace is the sequence of (pc, active-mask) pairs a warp issues
from program start to end.  The paper compares Hanoi's trace against real
hardware with the Levenshtein distance normalized by trace length — we
implement exactly that metric.

Two implementations of the edit distance live here:

* :func:`levenshtein` — Myers' bit-parallel algorithm (1999): the pattern is
  encoded as per-token bitmasks and each text token updates the whole DP
  column with O(1) big-int operations, so the cost is O(n·m/w) word ops
  instead of O(n·m) Python-level cell updates.  Python's arbitrary-precision
  ints serve as the bit vectors, so no blocking is needed at any length.
  This is what makes offline archive replay (``repro.archive``) tractable at
  fleet scale — millions of archived warps with multi-thousand-slot traces.
* :func:`levenshtein_dp` — the classic banded DP in numpy, kept as the
  differential-testing oracle (``tests/test_archive.py`` and the hypothesis
  property in ``tests/test_property_core.py`` assert both agree exactly;
  ``benchmarks/bench_archive.py`` gates the speedup).
"""
from __future__ import annotations

import math

import numpy as np


def levenshtein_dp(a: np.ndarray, b: np.ndarray) -> int:
    """Classic DP edit distance between two token sequences (the oracle)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if n < m:                       # keep the inner dimension small
        a, b, n, m = b, a, m, n
    prev = np.arange(m + 1, dtype=np.int64)
    cur = np.empty(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        dele = prev[1:] + 1
        np.minimum(sub, dele, out=cur[1:])
        # insertion needs a sequential scan (prefix dependency)
        ci = cur
        for j in range(1, m + 1):
            v = ci[j - 1] + 1
            if v < ci[j]:
                ci[j] = v
        prev, cur = cur, prev
    return int(prev[m])


def levenshtein(a: np.ndarray, b: np.ndarray) -> int:
    """Myers bit-parallel edit distance between two token sequences.

    Exactly :func:`levenshtein_dp`'s result.  The shorter sequence becomes
    the pattern: its positions are encoded as one arbitrary-precision bitmask
    per distinct token (``peq``), and each token of the longer sequence then
    advances the implicit DP column with a constant number of big-int ops
    (Hyyrö's formulation of Myers 1999).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if n > m:                       # pattern = shorter => smaller bitmasks
        a, b, n, m = b, a, m, n
    peq: dict[int, int] = {}
    for i, tok in enumerate(a.tolist()):
        peq[tok] = peq.get(tok, 0) | (1 << i)
    mask = (1 << n) - 1
    last = 1 << (n - 1)
    vp, vn = mask, 0                # vertical delta +1 / -1 bit columns
    score = n
    get = peq.get
    for tok in b.tolist():
        eq = get(tok, 0)
        xv = eq | vn
        xh = (((eq & vp) + vp) ^ vp) | eq
        ph = vn | ~(xh | vp)        # masked below; ~ is fine on big ints
        mh = vp & xh
        if ph & last:
            score += 1
        elif mh & last:
            score -= 1
        ph = ((ph << 1) | 1)
        vn = ph & xv & mask
        vp = ((mh << 1) | ~(xv | ph)) & mask
    return score


def nearest_rank(sorted_values, p: float) -> float:
    """Nearest-rank percentile — ``ceil(p*n)-1`` — of pre-*sorted* values.

    NaN for an empty sequence.  The one percentile indexing the service
    latency stats and the archive replay aggregates both use (``int(p*n)``
    is one-off-high: p50 of 2 samples would read the max).
    """
    if not sorted_values:
        return float("nan")
    idx = min(len(sorted_values) - 1,
              max(0, math.ceil(p * len(sorted_values)) - 1))
    return sorted_values[idx]


def trace_tokens(trace: list[tuple[int, int]]) -> np.ndarray:
    return np.array([(pc << 32) | m for pc, m in trace], dtype=np.int64)


def discrepancy(trace_a: list[tuple[int, int]],
                trace_b: list[tuple[int, int]]) -> float:
    """Paper's metric: Levenshtein(trace_a, trace_b) / len(reference).

    ``trace_b`` plays the role of the hardware reference.
    """
    ta, tb = trace_tokens(trace_a), trace_tokens(trace_b)
    denom = max(1, len(tb))
    return levenshtein(ta, tb) / denom
