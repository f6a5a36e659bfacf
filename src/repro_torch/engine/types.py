"""Normalized request/result schema shared by every control-flow mechanism.

Before this module existed each engine had its own calling convention and
result shape: ``interp.run_hanoi`` / ``run_simt_stack`` returned a mutable
``RunResult`` with a python-list trace, ``dualpath.run_dual_path`` the same
but with different keyword knobs, and the vectorized JAX engine returned a
raw :class:`~repro.core.hanoi.HanoiState` pytree with a ring-buffer trace.
``SimRequest``/``SimResult`` are the one schema all of them now map onto.

Out-of-fuel normalization
-------------------------
All engines burn one unit of fuel per scheduler slot and stop issuing the
moment fuel reaches zero, so their traces are *truncated* identically — the
property suite asserts the numpy and JAX engines agree step-for-step even
when fuel dies mid-split.  What used to differ is the *flagging*: the numpy
engines folded fuel exhaustion into a generic ``deadlocked`` bool while the
JAX engine required inspecting ``state.fuel``.  ``SimResult.status`` makes
the distinction explicit and uniform:

* ``OK``           — every thread retired through EXIT with fuel to spare;
* ``OUT_OF_FUEL``  — the scheduler-slot budget expired first (the trace is
  truncated at the last fueled slot, never silently dropped);
* ``DEADLOCK``     — no runnable path remained while threads were still
  unfinished (fuel was left over — a *structural* hang, e.g. a BSYNC whose
  mask can never assemble);
* ``ERROR``        — a structural resource error (Bx exhaustion on
  WARPSYNC).
"""
from __future__ import annotations

import enum
import types as _pytypes
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from repro_torch.core.isa import MachineConfig
from repro_torch.core.trace import trace_tokens as _trace_tokens


def _freeze_meta(obj: Any, value: Mapping[str, Any]) -> None:
    """Normalize a ``meta`` mapping on a frozen dataclass to an immutable
    view.  ``field(default_factory=dict)`` alone still hands every caller a
    mutable dict (and ``meta=SHARED_DICT`` a *shared* mutable one) — copying
    into a ``MappingProxyType`` closes both holes."""
    object.__setattr__(obj, "meta",
                       _pytypes.MappingProxyType(dict(value)))


class _PicklableMeta:
    """Pickle support for the frozen request/result dataclasses.

    The ``meta`` field is normalized to a ``MappingProxyType``, which
    pickle refuses — a problem for the multi-process service tier, whose
    job/result envelopes carry these objects across process boundaries.
    ``__getstate__`` downgrades the proxy to a plain dict;
    ``__setstate__`` restores the fields and re-freezes ``meta``, so the
    immutability contract survives the round trip.
    """

    def __getstate__(self) -> dict[str, Any]:
        state = dict(self.__dict__)
        state["meta"] = dict(state["meta"])
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        for k, v in state.items():
            object.__setattr__(self, k, v)
        _freeze_meta(self, state["meta"])


class SimStatus(enum.Enum):
    """Normalized termination status (see module docstring)."""

    OK = "ok"
    OUT_OF_FUEL = "out_of_fuel"
    DEADLOCK = "deadlock"
    ERROR = "error"


@dataclass(frozen=True, eq=False)
class SimRequest(_PicklableMeta):
    """One warp execution: program + machine + initial state + run options.

    ``fuel`` overrides ``cfg.max_steps`` when given (so a shared config can
    be re-budgeted per request).  ``bsync_skip_pcs`` is consumed only by
    the ``turing_oracle`` mechanism; the others ignore it.

    ``meta`` carries mechanism-specific options that are not part of the
    universal schema — e.g. ``itps_patience`` for ``volta_itps`` or
    ``sm_warps`` / ``sm_inner`` / ``sm_policy`` for ``sm_interleave``.
    Mechanisms ignore keys they do not know.  It is normalized to an
    immutable mapping in ``__post_init__``.

    ``eq=False``: ndarray fields make generated ``__eq__``/``__hash__``
    raise, so requests/results compare and hash by identity — usable as
    set members and dict keys.
    """

    program: np.ndarray
    cfg: MachineConfig = MachineConfig()
    init_regs: Any = None
    init_mem: Any = None
    lane_ids: Any = None
    active0: int | None = None
    fuel: int | None = None
    record_trace: bool = True
    majority_first: bool = True
    bsync_skip_pcs: tuple[int, ...] = ()
    name: str = ""
    meta: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        _freeze_meta(self, self.meta)

    def resolved_cfg(self) -> MachineConfig:
        if self.fuel is None:
            return self.cfg
        return self.cfg._replace(max_steps=int(self.fuel))


@dataclass(frozen=True, eq=False)
class SimResult(_PicklableMeta):
    """Normalized outcome of running one warp under one mechanism.

    ``eq=False`` for the same reason as :class:`SimRequest`: identity
    comparison/hashing instead of crashing on the ndarray fields.
    """

    mechanism: str
    status: SimStatus
    regs: np.ndarray
    preds: np.ndarray
    mem: np.ndarray
    finished: int
    steps: int
    fuel_left: int
    trace: tuple[tuple[int, int], ...]
    utilization: float
    error: str | None = None
    wall_time_s: float = 0.0
    meta: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        _freeze_meta(self, self.meta)

    @property
    def ok(self) -> bool:
        return self.status is SimStatus.OK

    @property
    def deadlocked(self) -> bool:
        """Legacy predicate: matches ``RunResult.deadlocked`` (fuel
        exhaustion and structural deadlock were historically one flag)."""
        return self.status is not SimStatus.OK

    def trace_tokens(self) -> np.ndarray:
        return _trace_tokens(list(self.trace))


#: Severity order used when aggregating warp statuses into one SM status.
_STATUS_SEVERITY = {SimStatus.OK: 0, SimStatus.OUT_OF_FUEL: 1,
                    SimStatus.DEADLOCK: 2, SimStatus.ERROR: 3}


def worst_status(statuses) -> SimStatus:
    """The most severe status in ``statuses`` (OK < OUT_OF_FUEL < DEADLOCK
    < ERROR); OK for an empty sequence."""
    return max(statuses, key=_STATUS_SEVERITY.__getitem__,
               default=SimStatus.OK)


@dataclass(frozen=True, eq=False)
class SmResult(_PicklableMeta):
    """Outcome of running N warps on one SM through a single-warp mechanism.

    The SM model time-multiplexes the warps' control-flow traces through one
    issue scheduler (``policy``: ``round_robin`` or ``greedy_then_oldest``),
    so the per-warp architectural results come straight from the inner
    mechanism while the SM-level schedule — ``sm_trace`` of
    ``(warp, pc, mask)`` slots and the latency-aware ``cycles`` — reflects
    the interleaving.  ``requests`` keeps the per-warp
    :class:`SimRequest`s the cell executed (``requests[w]`` produced
    ``warps[w]``) so SM cells archive replayably: the service and the
    façade stamp each warp's begin event with the full replay payload via
    :func:`repro.engine.sinks.sm_run_meta`.  ``eq=False`` for the same
    identity-comparison reason as :class:`SimResult`.
    """

    mechanism: str
    inner: str
    policy: str
    warps: tuple[SimResult, ...]
    sm_trace: tuple[tuple[int, int, int], ...]
    status: SimStatus                 # worst across warps
    steps: int                        # total SM issue slots
    cycles: int                       # latency-aware schedule length
    thread_instructions: int          # sum of active-mask popcounts
    utilization: float                # SIMD utilization over the SM trace
    requests: tuple[SimRequest, ...] = ()   # per-warp requests (replay)
    wall_time_s: float = 0.0
    # stall taxonomy of the cycle-level schedule (repro.timing): busy +
    # scoreboard-stall + memory-stall partition ``cycles``; issue-stall
    # counts port-contention cycles and overlaps busy ones
    busy_cycles: int = 0
    issue_stall_cycles: int = 0
    scoreboard_stall_cycles: int = 0
    memory_stall_cycles: int = 0
    meta: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        _freeze_meta(self, self.meta)

    @property
    def n_warps(self) -> int:
        return len(self.warps)

    @property
    def ok(self) -> bool:
        return self.status is SimStatus.OK

    @property
    def ipc(self) -> float:
        """Thread-level IPC of the interleaved SM schedule (0.0 for an
        empty schedule)."""
        if self.cycles <= 0:
            return 0.0
        return self.thread_instructions / self.cycles

    @property
    def warp_ipc(self) -> float:
        if self.cycles <= 0:
            return 0.0
        return self.steps / self.cycles

    @property
    def stall_breakdown(self) -> dict[str, int]:
        return {"issue": self.issue_stall_cycles,
                "scoreboard": self.scoreboard_stall_cycles,
                "memory": self.memory_stall_cycles}


def classify_status(*, finished: int, full_mask: int, fuel_left: int,
                    error: str | None) -> SimStatus:
    """The one status derivation every adapter funnels through.

    ``fuel_left < 0`` means "unknown" (the legacy ``RunResult`` default for
    engines that predate fuel accounting): such runs classify on the
    finished mask alone and are never flagged OUT_OF_FUEL.
    """
    if error:
        return SimStatus.ERROR
    if fuel_left == 0:
        # budget expired — even a fully-finished run keeps the legacy
        # "deadlocked" view (fuel exhaustion has always been flagged)
        return SimStatus.OUT_OF_FUEL
    if (finished & full_mask) == full_mask:
        return SimStatus.OK
    return SimStatus.DEADLOCK
