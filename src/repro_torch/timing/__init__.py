"""repro_torch.timing — event-driven, cycle-level SM timing subsystem.

Port of ``repro.timing`` (numpy only, copied).

The Fig 10 IPC evaluation's engine room: a discrete-event simulator core
(:mod:`.events`), pluggable warp issue policies shared with the
``sm_interleave`` mechanism (:mod:`.policies`), and the cycle-level SM
model with per-warp scoreboards, configurable memory-latency
distributions, and optional dual issue (:mod:`.sm_model`).

The legacy :mod:`repro_torch.core.timing` API (``schedule_traces`` /
``simulate``) is a thin shim over this package; in trace-conservative
single-issue fixed-latency mode the engine reproduces the legacy numbers
bit-for-bit (differential-tested).  See ``docs/timing.md``.
"""
from .events import Delay, EventQueue, Process, Scheduler, Signal
from .policies import (POLICY_NAMES, GreedyThenOldest, IssuePolicy,
                       OldestFirst, RoundRobin, get_policy,
                       resolve_policy_name)
from .sm_model import (CycleConfig, CycleResult, instr_deps, schedule_cycle,
                       simulate_cycle)

__all__ = [
    "CycleConfig", "CycleResult", "Delay", "EventQueue", "GreedyThenOldest",
    "IssuePolicy", "OldestFirst", "POLICY_NAMES", "Process", "RoundRobin",
    "Scheduler", "Signal", "get_policy", "instr_deps", "resolve_policy_name",
    "schedule_cycle", "simulate_cycle",
]
