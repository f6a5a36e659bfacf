"""Pluggable warp issue policies — the ONE policy layer for every scheduler.

Port of ``repro.timing.policies`` (numpy only, copied).

Both the legacy Fig 10 model (:mod:`repro_torch.core.timing`, via its shim over
the cycle engine) and the per-SM interleaver
(:mod:`repro_torch.engine.mechanisms.sm`) select warps through these classes, so
the semantics of ``greedy_then_oldest`` cannot drift between the IPC
evaluation and the SM mechanism — the asymmetry this package was built to
close.

A policy is a small stateful object: ``select(ready)`` picks one warp id
out of the ready set, ``issued(w)`` notifies it of the grant (so GTO can
stay greedy and round-robin can advance its cursor).  Policies never see
latencies or scoreboards — readiness is the model's job; arbitration is
the policy's.

Registered policies:

* ``greedy_then_oldest`` (alias ``gto``) — stay on the last-granted warp
  while it is ready, else the oldest (lowest-id) ready warp.  The paper's
  Table III scheduler.
* ``round_robin`` — rotate a cursor over ready warps every grant.
* ``oldest_first`` — always the lowest-id ready warp (no greedy
  stickiness); the degenerate baseline that makes GTO's locality win
  measurable.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["IssuePolicy", "GreedyThenOldest", "RoundRobin", "OldestFirst",
           "POLICY_NAMES", "get_policy", "resolve_policy_name",
           "priority_keys"]


def priority_keys(name: str, n_warps: int, *, last: "int | None" = None,
                  cursor: int = 0) -> np.ndarray:
    """The argmin-vector formulation of an issue policy's ``select``.

    Returns an ``int32[n_warps]`` key vector such that, for any non-empty
    ready set *R* and the policy state ``(last, cursor)``,
    ``select(R) == argmin over w in R of keys[w]`` — ties are impossible
    because every vector below is injective over ``[0, n_warps)``:

    * ``oldest_first``:       ``keys[w] = w``;
    * ``greedy_then_oldest``: ``keys[w] = w + 1`` except ``keys[last] = 0``
      (``last=None`` — post-stall — leaves the vector monotone, so the
      minimum falls back to the oldest ready warp);
    * ``round_robin``:        ``keys[w] = (w - cursor) mod n_warps``.

    This is the *one* formulation array schedulers (``sm_jax``) mirror with
    ``argmin(where(ready, keys, INF))``; a drift test pins it against the
    stateful classes below so the two can never diverge.
    """
    name = resolve_policy_name(name)
    n = max(1, int(n_warps))
    w = np.arange(n, dtype=np.int32)
    if name == OldestFirst.name:
        return w
    if name == GreedyThenOldest.name:
        keys = w + 1
        if last is not None and 0 <= last < n:
            keys[last] = 0
        return keys
    return (w - np.int32(cursor)) % n          # round_robin


class IssuePolicy:
    """Base class: subclasses implement ``select``; ``issued`` is optional."""

    name = "abstract"

    def __init__(self, n_warps: int) -> None:
        if n_warps < 0:
            raise ValueError(f"n_warps must be >= 0, got {n_warps}")
        self.n_warps = n_warps

    def select(self, ready: Sequence[int]) -> int:
        raise NotImplementedError

    def issued(self, warp: int) -> None:   # pragma: no cover - trivial hook
        pass

    def stalled(self) -> None:             # pragma: no cover - trivial hook
        """The scheduler sat idle (no ready warp) before this selection."""
        pass

    def priority_keys(self) -> np.ndarray:
        """This policy's :func:`priority_keys` vector at its current state."""
        return priority_keys(self.name, self.n_warps)


class GreedyThenOldest(IssuePolicy):
    """GTO: greedy on the current warp, else oldest ready (lowest id)."""

    name = "greedy_then_oldest"

    def __init__(self, n_warps: int) -> None:
        super().__init__(n_warps)
        self._last: int | None = 0   # legacy loop's initial ``cur = 0``

    def select(self, ready: Sequence[int]) -> int:
        if self._last is not None and self._last in ready:
            return self._last
        return min(ready)

    def issued(self, warp: int) -> None:
        self._last = warp

    def stalled(self) -> None:
        # After an idle gap the legacy loop re-picks the oldest ready warp
        # even when the greedy warp woke at the same instant; drop the
        # stickiness so the shim stays bit-identical to it.
        self._last = None

    def priority_keys(self) -> np.ndarray:
        return priority_keys(self.name, self.n_warps, last=self._last)


class RoundRobin(IssuePolicy):
    """Fair rotation: the ready warp closest after the last grant."""

    name = "round_robin"

    def __init__(self, n_warps: int) -> None:
        super().__init__(n_warps)
        self._next = 0

    def select(self, ready: Sequence[int]) -> int:
        n = max(1, self.n_warps)
        return min(ready, key=lambda w: (w - self._next) % n)

    def issued(self, warp: int) -> None:
        self._next = warp + 1

    def priority_keys(self) -> np.ndarray:
        return priority_keys(self.name, self.n_warps, cursor=self._next)


class OldestFirst(IssuePolicy):
    """Always the lowest-id ready warp — GTO without the greedy half."""

    name = "oldest_first"

    def select(self, ready: Sequence[int]) -> int:
        return min(ready)


_POLICIES = {
    GreedyThenOldest.name: GreedyThenOldest,
    RoundRobin.name: RoundRobin,
    OldestFirst.name: OldestFirst,
}
_ALIASES = {"gto": GreedyThenOldest.name}

#: Canonical policy names, stable order (aliases not included).
POLICY_NAMES = tuple(_POLICIES)


def resolve_policy_name(name: str) -> str:
    """Canonical name for ``name`` (aliases resolved); raises ValueError."""
    canon = _ALIASES.get(name, name)
    if canon not in _POLICIES:
        known = POLICY_NAMES + tuple(_ALIASES)
        raise ValueError(f"unknown issue policy {name!r}; known: {known}")
    return canon


def get_policy(name: str, n_warps: int) -> IssuePolicy:
    """A fresh policy instance for one schedule run."""
    return _POLICIES[resolve_policy_name(name)](n_warps)
