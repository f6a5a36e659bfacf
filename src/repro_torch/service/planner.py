"""Dispatch planning: one grouping/routing path for façade and service.

Historically :meth:`repro.engine.Simulator.run_batch` owned this logic as
private internals (an all-or-nothing ``_homogeneous`` check plus an opt-in
thread-pool fan-out).  The planner generalizes it and is now the **single**
dispatch path:

* the Simulator façade calls :func:`execute_plan` on every ``run_batch``;
* the queue-fed :class:`~repro.service.core.SimulationService` coalesces
  admissions into signature-homogeneous groups and executes each through
  :func:`run_group`;
* the SM composites dispatch their warps here too —
  ``Simulator.run_sm`` and the registered ``sm_interleave`` runner both
  call :func:`execute_plan` on the cell, so an inner mechanism with a
  native ``batch_runner`` (``sm_inner="hanoi_jax"``) executes the whole
  homogeneous cell as ONE cached ``jit(vmap)`` batch instead of a serial
  Python loop over warps.

Routing rules:

* a group whose mechanism has a native ``batch_runner`` and whose signature
  is ``batchable`` executes as **one** native batch (the vmap-over-warps-
  and-programs JAX path) — including mixed program lengths within one
  padding class;
* everything else runs per-request — sequentially, or through a thread
  pool when ``max_workers`` is given and the mechanism is a numpy engine
  with more than one request (see ``Simulator``'s docstring for why the
  default is sequential).

Unlike the old ``_homogeneous`` check, a *mixed* batch no longer falls back
entirely to per-request execution: each homogeneous sub-group still takes
the native path, and :func:`execute_plan` reassembles results in submission
order.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

from repro_torch.engine.registry import Mechanism
from repro_torch.engine.types import SimRequest, SimResult

from .signature import ExecSignature, signature_of

__all__ = ["DispatchGroup", "plan_dispatch", "run_group", "execute_plan"]


@dataclass(frozen=True)
class DispatchGroup:
    """One signature-homogeneous slice of a batch, with its route."""

    signature: ExecSignature
    indices: tuple[int, ...]      # positions in the submitted batch
    native: bool                  # True -> mechanism.batch_runner

    @property
    def size(self) -> int:
        return len(self.indices)


def group_is_native(mech: Mechanism, sig: ExecSignature) -> bool:
    """Whether a signature-homogeneous group takes the native batch path."""
    return mech.batch_runner is not None and sig.batchable


def plan_dispatch(mech: Mechanism,
                  reqs: Sequence[SimRequest]) -> list[DispatchGroup]:
    """Group ``reqs`` by execution signature, in first-seen order."""
    buckets: dict[ExecSignature, list[int]] = {}
    for i, req in enumerate(reqs):
        buckets.setdefault(signature_of(mech, req), []).append(i)
    return [DispatchGroup(signature=sig, indices=tuple(idx),
                          native=group_is_native(mech, sig))
            for sig, idx in buckets.items()]


def run_group(mech: Mechanism, reqs: Sequence[SimRequest], *,
              native: bool, max_workers: int | None = None
              ) -> list[SimResult]:
    """Execute one signature-homogeneous group, preserving order."""
    reqs = list(reqs)
    if not reqs:
        return []
    if native:
        results = list(mech.batch_runner(reqs))
        if len(results) != len(reqs):
            # a plugin batch_runner that drops results would otherwise
            # silently truncate downstream zips — hanging service tickets
            # instead of surfacing a diagnosable error
            raise RuntimeError(
                f"{mech.name}.batch_runner returned {len(results)} results "
                f"for {len(reqs)} requests")
        return results
    if (mech.backend == "numpy" and len(reqs) > 1
            and max_workers is not None):
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(mech, reqs))
    return [mech(r) for r in reqs]


def execute_plan(mech: Mechanism, reqs: Sequence[SimRequest], *,
                 max_workers: int | None = None,
                 plan: Sequence[DispatchGroup] | None = None
                 ) -> list[SimResult]:
    """Plan, execute, and reassemble a batch in submission order.

    Native groups run as one ``batch_runner`` call each; the per-request
    remainder is pooled *across* groups (a heterogeneous numpy batch would
    otherwise degenerate into size-1 groups and never reach the pool).
    """
    if plan is None:
        plan = plan_dispatch(mech, reqs)
    out: list[SimResult | None] = [None] * len(reqs)
    scalar_idx: list[int] = []
    for g in plan:
        if g.native:
            for i, res in zip(g.indices,
                              run_group(mech, [reqs[i] for i in g.indices],
                                        native=True)):
                out[i] = res
        else:
            scalar_idx.extend(g.indices)
    scalar_idx.sort()
    if scalar_idx:
        for i, res in zip(scalar_idx,
                          run_group(mech, [reqs[i] for i in scalar_idx],
                                    native=False, max_workers=max_workers)):
            out[i] = res
    return out  # type: ignore[return-value]
