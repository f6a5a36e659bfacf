"""Straggler detection and mitigation (a copy of
``repro.runtime.straggler``, which the train loop uses).

At thousand-node scale a single slow host gates every synchronous step.  The
monitor keeps a rolling window of per-host step times; hosts whose median
exceeds ``threshold`` x the fleet median are flagged.  Mitigation is data
rebalancing: shift per-host batch shares away from stragglers (the pipeline
accepts weighted shard sizes), a softer first response than eviction —
eviction (elastic re-mesh) is the escalation path (``runtime/elastic.py``).
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerMonitor:
    window: int = 20
    threshold: float = 1.5
    _times: dict = field(default_factory=lambda: defaultdict(deque))

    def record(self, host: int, step_time_s: float) -> None:
        dq = self._times[host]
        dq.append(step_time_s)
        if len(dq) > self.window:
            dq.popleft()

    def host_medians(self) -> dict[int, float]:
        return {h: float(np.median(list(dq)))
                for h, dq in self._times.items() if dq}

    def stragglers(self) -> list[int]:
        med = self.host_medians()
        if len(med) < 2:
            return []
        fleet = float(np.median(list(med.values())))
        return [h for h, m in med.items() if m > self.threshold * fleet]

    def relative_speed(self) -> dict[int, float]:
        """1.0 = fleet median; higher = faster host."""
        med = self.host_medians()
        if not med:
            return {}
        fleet = float(np.median(list(med.values())))
        return {h: fleet / max(m, 1e-9) for h, m in med.items()}


def rebalance_batches(global_batch: int, speeds: dict[int, float],
                      *, quantum: int = 1) -> dict[int, int]:
    """Split ``global_batch`` proportionally to host speeds (bounded below by
    one quantum so no host is starved), preserving the total exactly."""
    hosts = sorted(speeds)
    w = np.array([max(speeds[h], 1e-3) for h in hosts], dtype=np.float64)
    raw = w / w.sum() * (global_batch / quantum)
    alloc = np.maximum(1, np.floor(raw)).astype(int)
    # distribute the remainder to the largest fractional parts
    rem = global_batch // quantum - int(alloc.sum())
    if rem > 0:
        order = np.argsort(-(raw - np.floor(raw)))
        for i in order[:rem]:
            alloc[i] += 1
    elif rem < 0:
        order = np.argsort(raw - np.floor(raw))
        for i in order:
            if rem == 0:
                break
            if alloc[i] > 1:
                alloc[i] -= 1
                rem += 1
    return {h: int(a) * quantum for h, a in zip(hosts, alloc)}
