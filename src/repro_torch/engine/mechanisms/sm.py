"""``sm_interleave`` — a per-SM model: N warps through one issue scheduler.

Port of ``repro.engine.mechanisms.sm`` (numpy only, copied).

A streaming multiprocessor runs many warps; its scheduler picks one ready
warp per slot.  Warps are architecturally independent in this simulator
(each request carries its own register file and memory image), so the SM
model composes exactly: every warp executes to completion under any
registered *single-warp* mechanism, and the SM scheduler time-multiplexes
their control-flow traces into one latency-aware issue schedule — the same
trace-driven approach as :mod:`repro_torch.core.timing`, generalized to
per-warp programs, pluggable policies, and a full SM-level trace.

Policies:

* ``round_robin``        — rotate over ready warps every slot (fair,
  latency-hiding, worst locality);
* ``greedy_then_oldest`` — GTO (the paper's Table III scheduler): stay on
  the current warp while it is ready, else switch to the oldest ready warp.

Request options (``SimRequest.meta``) for the registered mechanism, which
replicates one request across identical warps:

* ``sm_warps``  (int, default 4)            — warps per SM;
* ``sm_inner``  (str, default ``"hanoi"``)  — single-warp mechanism name;
* ``sm_policy`` (str, default ``"round_robin"``).

Heterogeneous warps (different programs / memory images per warp) go
through :meth:`repro_torch.engine.Simulator.run_sm`, which returns the full
:class:`~repro_torch.engine.types.SmResult`; the registered mechanism exposes the
same model through the universal ``SimResult`` schema (warp-0 architectural
state, SM-level trace, ``meta["sm"]`` holding the aggregate) so
``run_batch`` / ``compare`` work unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core.timing import TimingConfig
from repro_torch.timing import CycleConfig, CycleResult, schedule_cycle
from repro_torch.timing.policies import POLICY_NAMES, resolve_policy_name

from ..registry import get_mechanism, register_mechanism
from ..types import SimRequest, SimResult, SmResult, worst_status

# the SM scheduler arbitrates through the shared repro_torch.timing policy layer,
# so its policy names are exactly the registered issue policies
SM_POLICIES = POLICY_NAMES

DEFAULT_WARPS = 4
DEFAULT_INNER = "hanoi"
DEFAULT_POLICY = "round_robin"


def interleave_cycle(traces: Sequence[Sequence[tuple[int, int]]],
                     programs: Sequence[np.ndarray],
                     policy: str = DEFAULT_POLICY,
                     tcfg: "TimingConfig | CycleConfig" = TimingConfig(),
                     ) -> CycleResult:
    """Schedule per-warp traces through one SM issue port, cycle-level.

    Thin façade over :func:`repro_torch.timing.schedule_cycle` — the one issue
    engine the Fig 10 IPC model also uses — passing full program rows so a
    scoreboard :class:`~repro_torch.timing.CycleConfig` gets real register
    dependences.  A legacy :class:`TimingConfig` runs the exact-compat
    trace-conservative mode.
    """
    policy = resolve_policy_name(policy)
    return schedule_cycle([list(t) for t in traces],
                          [np.asarray(p) for p in programs],
                          policy, CycleConfig.from_timing(tcfg))


def interleave_traces(traces: Sequence[Sequence[tuple[int, int]]],
                      programs: Sequence[np.ndarray],
                      policy: str = DEFAULT_POLICY,
                      tcfg: "TimingConfig | CycleConfig" = TimingConfig(),
                      ) -> tuple[list[tuple[int, int, int]], int, int]:
    """Legacy-shaped façade over :func:`interleave_cycle`.

    Returns ``(sm_trace, cycles, thread_instructions)`` where ``sm_trace``
    is the issue order as ``(warp, pc, mask)``; callers that want the stall
    breakdown use :func:`interleave_cycle` directly.
    """
    res = interleave_cycle(traces, programs, policy, tcfg)
    return res.order, res.cycles, res.thread_instructions


def build_sm_result(reqs: Sequence[SimRequest],
                    results: Sequence[SimResult],
                    *,
                    inner: str,
                    policy: str = DEFAULT_POLICY,
                    timing_cfg: "TimingConfig | CycleConfig" = TimingConfig(),
                    wall_time_s: float = 0.0) -> SmResult:
    """Assemble the SM aggregate from per-warp requests and results."""
    sched = interleave_cycle(
        [list(r.trace) for r in results],
        [np.asarray(q.program) for q in reqs], policy, timing_cfg)
    width = max(q.resolved_cfg().n_threads for q in reqs)
    steps = len(sched.order)
    return SmResult(
        mechanism="sm_interleave", inner=inner,
        policy=resolve_policy_name(policy),
        warps=tuple(results), sm_trace=tuple(sched.order),
        status=worst_status([r.status for r in results]),
        steps=steps, cycles=sched.cycles,
        thread_instructions=sched.thread_instructions,
        utilization=sched.thread_instructions / max(1, steps * width),
        requests=tuple(reqs),
        wall_time_s=wall_time_s,
        busy_cycles=sched.busy_cycles,
        issue_stall_cycles=sched.issue_stall_cycles,
        scoreboard_stall_cycles=sched.scoreboard_stall_cycles,
        memory_stall_cycles=sched.memory_stall_cycles)


def _sequence_len(programs) -> "int | None":
    """``len()`` of a *sequence of programs*, or ``None`` for one program.

    A single program is a 2-D instruction-row table (any ndarray of
    ``ndim != 3``), a ``Benchmark`` duck-type, or a ``SimRequest``; a
    sequence is a list/tuple, a 3-D ndarray of stacked row tables, or any
    other sized container.  Unsized iterables (generators) raise instead of
    silently desynchronizing the façade's cell width from the service's
    per-warp stats accounting.
    """
    if isinstance(programs, (list, tuple)):
        return len(programs)
    if isinstance(programs, np.ndarray):
        return int(programs.shape[0]) if programs.ndim == 3 else None
    if hasattr(programs, "program"):     # SimRequest / Benchmark duck-type
        return None
    if isinstance(programs, (str, bytes)):
        raise TypeError("programs must be a program or a sequence of "
                        f"programs, not {type(programs).__name__}")
    if hasattr(programs, "__len__"):
        return len(programs)
    if hasattr(programs, "__iter__"):
        raise TypeError(
            "programs must be a single program or a *sized* sequence of "
            "programs; got an unsized iterable — materialize it as a list")
    return None


def warp_count(programs, n_warps: "int | None") -> int:
    """Cell width for ``run_sm``/``submit_sm`` arguments — the ONE
    derivation both the façade and the service's warp-level stats use:
    one warp per entry of a program sequence (any sized sequence, including
    a 3-D ndarray of stacked programs), else ``n_warps``
    (default :data:`DEFAULT_WARPS`)."""
    n = _sequence_len(programs)
    if n is not None:
        return n
    return DEFAULT_WARPS if n_warps is None else int(n_warps)


def per_warp_programs(programs, n_warps: "int | None") -> list:
    """Normalize ``run_sm``/``submit_sm`` ``programs`` into one entry per
    warp, consistently with :func:`warp_count` (a conflict between an
    explicit ``n_warps`` and a sequence's own length is an error)."""
    n = _sequence_len(programs)
    if n is None:
        return [programs] * warp_count(programs, n_warps)
    if n_warps is not None and int(n_warps) != n:
        raise ValueError(f"n_warps={n_warps} conflicts with {n} "
                         f"per-warp programs")
    if isinstance(programs, np.ndarray):
        return [programs[i] for i in range(n)]
    return list(programs)


def _sm_options(req: SimRequest) -> tuple[int, str, str]:
    n_warps = int(req.meta.get("sm_warps", DEFAULT_WARPS))
    if n_warps < 1:
        raise ValueError(f"sm_warps must be >= 1, got {n_warps}")
    inner = str(req.meta.get("sm_inner", DEFAULT_INNER))
    policy = str(req.meta.get("sm_policy", DEFAULT_POLICY))
    return n_warps, inner, policy


@register_mechanism(
    "sm_interleave", backend="numpy", tags=("sm", "multi-warp", "composite"),
    description="per-SM model: time-multiplexes N identical warps through "
                "any registered single-warp mechanism (meta: sm_warps, "
                "sm_inner, sm_policy); SimResult carries warp-0 state, the "
                "interleaved SM trace, and meta['sm'] = SmResult")
def _run_sm_interleave(req: SimRequest) -> SimResult:
    n_warps, inner_name, policy = _sm_options(req)
    inner = get_mechanism(inner_name)
    if "composite" in inner.tags or inner.name == "sm_interleave":
        raise ValueError("sm_inner must be a single-warp mechanism, "
                         f"not the composite {inner.name!r}")
    stripped = {k: v for k, v in req.meta.items()
                if not k.startswith("sm_")}
    t0 = time.perf_counter()
    reqs = [dataclasses.replace(req, meta=stripped,
                                name=f"{req.name or 'warp'}/w{w}")
            for w in range(n_warps)]
    # dispatch the warps through the shared planner, not a serial Python
    # loop: an inner mechanism with a native batch_runner (sm_inner=
    # "hanoi_torch") executes the whole homogeneous cell as ONE batch
    # (one launch of K1 on the card)
    from repro_torch.service.planner import execute_plan  # lazy: no cycle
    results = execute_plan(inner, reqs)
    sm = build_sm_result(reqs, results, inner=inner.name, policy=policy,
                         wall_time_s=time.perf_counter() - t0)
    w0 = results[0]
    return SimResult(
        mechanism="sm_interleave", status=sm.status,
        regs=w0.regs, preds=w0.preds, mem=w0.mem, finished=w0.finished,
        steps=sm.steps, fuel_left=min(r.fuel_left for r in results),
        trace=tuple((pc, mask) for _, pc, mask in sm.sm_trace),
        utilization=sm.utilization,
        error=next((r.error for r in results if r.error), None),
        wall_time_s=sm.wall_time_s, meta={"sm": sm})


__all__ = ["SM_POLICIES", "DEFAULT_WARPS", "DEFAULT_INNER", "DEFAULT_POLICY",
           "interleave_cycle", "interleave_traces", "build_sm_result",
           "warp_count", "per_warp_programs"]
