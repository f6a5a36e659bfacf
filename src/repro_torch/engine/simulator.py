"""The Simulator façade: one entry point over every registered mechanism.

Port of ``repro.engine.simulator``: ``run``, ``run_batch``, ``run_sm`` and
``compare``, with static verification and annotation synthesis
(``verify=``, ``synthesize=``: :mod:`repro_torch.analysis`) and trace sinks
(``sink=``: :mod:`repro_torch.engine.sinks`).

``Simulator.run`` executes one request, ``run_batch`` many (one launch of
kernel K1 a batch on ``hanoi_torch``; sequential — or opt-in
thread-pooled — on the numpy engines), ``run_sm`` one SM of warps (through
``sm_torch``: one launch of K1 and one of K2, or ``sm_interleave``), and
``compare`` runs the same programs under several mechanisms and reports
per-pair trace discrepancy and IPC deltas — the paper's Fig 9 / Fig 10
evaluation as a one-call API.

Like every entry point of the port, the Simulator runs on the card unless
it is asked for the CPU: its default mechanism is ``hanoi_torch`` and
``run_sm``'s SM engine ``sm_torch``, and ``device="cpu"`` selects their
plain twins.  The numpy mechanisms run on the host when asked for by name.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.core.isa import MachineConfig
from repro_torch.core.timing import TimingConfig, ipc_delta, simulate
from repro_torch.core.trace import discrepancy

from .registry import Mechanism, get_mechanism
from .sinks import (TraceSink, feed_result, next_sm_cell_id, run_meta,
                    sm_run_meta, timing_meta)
from .types import SimRequest, SimResult, SmResult

ProgramLike = Any    # np.ndarray | Benchmark | SimRequest


def as_request(program: ProgramLike, cfg: MachineConfig | None = None,
               **kw) -> SimRequest:
    """Coerce an ndarray / Benchmark / SimRequest into a SimRequest.

    A SimRequest passes through untouched unless ``cfg`` or request kwargs
    are given, in which case they override the corresponding fields (so
    ``run(req, fuel=3)`` re-budgets an existing request instead of silently
    ignoring the override).
    """
    if isinstance(program, SimRequest):
        if cfg is None and not kw:
            return program
        if cfg is not None:
            kw.setdefault("cfg", cfg)
        return dataclasses.replace(program, **kw)
    if hasattr(program, "program"):          # programs.Benchmark duck-type
        b = program
        fields = dict(program=np.asarray(b.program),
                      cfg=cfg or MachineConfig(),
                      init_mem=getattr(b, "init_mem", None),
                      bsync_skip_pcs=tuple(getattr(b, "skip_bsync_pcs", ())),
                      name=getattr(b, "name", ""))
        fields.update(kw)                    # overrides win, never collide
        return SimRequest(**fields)
    return SimRequest(program=np.asarray(program),
                      cfg=cfg or MachineConfig(), **kw)


@dataclass(frozen=True)
class CompareRow:
    """One (program, mechanism pair) comparison cell."""

    program: str
    mech_a: str
    mech_b: str
    discrepancy: float           # Levenshtein(trace_a, trace_b)/len(trace_b)
    ipc_a: float
    ipc_b: float
    ipc_delta: float             # (ipc_a - ipc_b) / ipc_b
    util_a: float
    util_b: float
    status_a: str
    status_b: str
    trace_len_a: int
    trace_len_b: int

    @property
    def discrepancy_pct(self) -> float:
        return 100.0 * self.discrepancy

    @property
    def ipc_delta_pct(self) -> float:
        return 100.0 * self.ipc_delta


@dataclass(frozen=True)
class CompareReport:
    """All pairwise rows plus the per-mechanism raw results."""

    mechanisms: tuple[str, ...]
    rows: tuple[CompareRow, ...]
    results: dict = field(default_factory=dict)   # (program, mech) -> SimResult
    timing_results: dict = field(default_factory=dict)

    def pair(self, mech_a: str, mech_b: str) -> list[CompareRow]:
        """Rows for the ordered pair; raises KeyError for a pair that was
        never computed (a typo or swapped order would otherwise read as a
        perfect 0.0-discrepancy match)."""
        rows = [r for r in self.rows
                if r.mech_a == mech_a and r.mech_b == mech_b]
        if not rows:
            known = sorted({(r.mech_a, r.mech_b) for r in self.rows})
            raise KeyError(f"no comparison rows for pair ({mech_a!r}, "
                           f"{mech_b!r}); computed pairs: {known}")
        return rows

    def mean_discrepancy(self, mech_a: str, mech_b: str) -> float:
        return float(np.mean([r.discrepancy
                              for r in self.pair(mech_a, mech_b)]))

    def mean_abs_ipc_delta(self, mech_a: str, mech_b: str) -> float:
        return float(np.mean([abs(r.ipc_delta)
                              for r in self.pair(mech_a, mech_b)]))


class Simulator:
    """Façade over the mechanism registry.

    >>> sim = Simulator(device="cpu")
    >>> res = sim.run(program, cfg=MachineConfig(n_threads=8))
    >>> res.status
    <SimStatus.OK: 'ok'>

    A default mechanism is chosen at construction (``hanoi_torch``: kernel
    K1 on the card); ``run``/``run_batch`` accept ``mechanism=`` overrides,
    and ``compare`` takes an explicit list.
    A :class:`~repro_torch.engine.sinks.TraceSink` attached at construction
    (or per call) receives every normalized trace.

    ``device`` is where the torch mechanisms (``hanoi_torch``, ``sm_torch``)
    run: None means the card, resolved by :func:`repro_torch.device.resolve`
    when a run starts, which raises where there is none; ``"cpu"`` runs
    their plain twins.  It goes into each request's ``meta["device"]``
    unless the request names its own, so ``meta={"device": "cpu"}`` on a
    request does the same.

    ``max_workers`` opts numpy-mechanism batches into a thread pool.  The
    default (None) runs them sequentially: the reference interpreters are
    per-slot Python loops over tiny arrays, so they hold the GIL and a pool
    only adds contention.
    """

    def __init__(self, mechanism: str = "hanoi_torch", *, device=None,
                 sink: TraceSink | None = None,
                 max_workers: int | None = None,
                 verify: "bool | str" = False) -> None:
        self._default = get_mechanism(mechanism).name   # validate eagerly
        self._device = None if device is None else str(device)
        self._sink = sink
        self._max_workers = max_workers
        self._verify = verify

    @property
    def mechanism(self) -> str:
        return self._default

    def _request(self, program: ProgramLike, cfg: MachineConfig | None,
                 **request_kw) -> SimRequest:
        """``as_request``, with this Simulator's device in ``meta`` unless
        the request names its own."""
        req = as_request(program, cfg, **request_kw)
        if self._device is None or "device" in req.meta:
            return req
        return dataclasses.replace(req, meta={**req.meta,
                                              "device": self._device})

    def _check(self, reqs: "Iterable[SimRequest]",
               verify: "bool | str | None") -> None:
        """Static pre-admission verification (:mod:`repro_torch.analysis`).

        ``verify=True`` raises
        :class:`~repro_torch.analysis.StaticAnalysisError` for programs
        with ``error``-level diagnostics before any engine runs;
        ``"strict"`` also fails on warnings.  Default off: the façade is
        also the tool used to *study* broken programs (the volta_itps
        structural-deadlock experiments run them on purpose).
        """
        verify = self._verify if verify is None else verify
        if not verify:
            return
        from repro_torch.analysis import verify_program   # lazy: light path
        for req in reqs:
            verify_program(req.program, req.resolved_cfg(), name=req.name,
                           strict=(verify == "strict"))

    @staticmethod
    def _synthesize(reqs: "list[SimRequest]") -> "list[SimRequest]":
        """Rewrite each request's program through the annotation
        synthesizer (:func:`repro_torch.analysis.synthesize_annotations`):
        BSSY/BSYNC regions for unannotated divergent branches, BMOV
        spills past the Bx file, YIELD in spin-loops.

        Raises :class:`repro_torch.analysis.TransformError` when a program
        cannot be safely rewritten (CALL/RET-crossing regions,
        unstructured joins).  Note ``bsync_skip_pcs`` is *not* remapped —
        a request combining ``synthesize=True`` with oracle skip-pcs
        would point at stale pcs, so pick one or the other.
        """
        from repro_torch.analysis import synthesize_annotations  # lazy
        out = []
        for req in reqs:
            syn = synthesize_annotations(req.program, req.resolved_cfg(),
                                         name=req.name)
            out.append(dataclasses.replace(req, program=syn.program)
                       if syn.changed else req)
        return out

    # -- single run ---------------------------------------------------------

    def run(self, program: ProgramLike, cfg: MachineConfig | None = None, *,
            mechanism: str | None = None, sink: TraceSink | None = None,
            verify: "bool | str | None" = None, synthesize: bool = False,
            **request_kw) -> SimResult:
        mech = get_mechanism(mechanism or self._default)
        req = self._request(program, cfg, **request_kw)
        if synthesize:
            [req] = self._synthesize([req])
        self._check([req], verify)
        result = mech(req)
        self._feed_sink(sink or self._sink, mech, req, result)
        return result

    # -- batched run --------------------------------------------------------

    def run_batch(self, programs: Sequence[ProgramLike],
                  cfg: MachineConfig | None = None, *,
                  mechanism: str | None = None,
                  sink: TraceSink | None = None,
                  verify: "bool | str | None" = None,
                  synthesize: bool = False,
                  **request_kw) -> list[SimResult]:
        """Run many requests under one mechanism, preserving order.

        Grouping and routing are delegated to the service planner
        (:mod:`repro_torch.service.planner`): requests are grouped by
        execution signature, every signature-homogeneous group with a
        native ``batch_runner`` executes as one batch (``hanoi_torch``: one
        launch of K1), and the per-request remainder runs sequentially
        unless the Simulator was built with ``max_workers``.
        """
        mech = get_mechanism(mechanism or self._default)
        reqs = [self._request(p, cfg, **request_kw) for p in programs]
        if not reqs:
            return []
        if synthesize:
            reqs = self._synthesize(reqs)
        self._check(reqs, verify)
        from repro_torch.service.planner import execute_plan  # lazy: no
        results = execute_plan(mech, reqs,                   # import cycle
                               max_workers=self._max_workers)
        out_sink = sink or self._sink
        if out_sink is not None:
            for req, res in zip(reqs, results):
                self._feed_sink(out_sink, mech, req, res)
        return results

    # -- per-SM multi-warp execution ----------------------------------------

    def run_sm(self, programs: "ProgramLike | Sequence[ProgramLike]",
               cfg: MachineConfig | None = None, *,
               n_warps: int | None = None,
               inner: str | None = None,
               policy: str = "round_robin",
               timing_cfg: "TimingConfig | object" = TimingConfig(),
               sm_mechanism: str | None = None,
               sink: TraceSink | None = None,
               **request_kw) -> SmResult:
        """Run N warps on one SM through a single-warp mechanism.

        ``programs`` is either one program (replicated across ``n_warps``
        identical warps, default 4) or a sequence with one entry per warp
        (heterogeneous SMs — different programs and/or memory images; any
        sized sequence works, including a 3-D ndarray of stacked programs).
        Each warp executes under ``inner`` (default: this Simulator's
        mechanism, or ``hanoi_torch`` if that is a composite SM mechanism),
        then
        the per-warp traces are time-multiplexed through the SM issue
        scheduler under ``policy`` (``round_robin`` /
        ``greedy_then_oldest`` / ``oldest_first``).  The returned
        :class:`~repro_torch.engine.types.SmResult` carries the per-warp
        ``SimResult``s (and their ``SimRequest``s) plus the interleaved
        ``(warp, pc, mask)`` SM trace and its latency-aware cycle count.

        ``sm_mechanism`` selects the SM engine: ``"sm_torch"`` (the whole
        cell in one launch of K1 and one of K2 on the Simulator's device,
        the card unless it is ``"cpu"``, where their plain twins run;
        ``inner`` limited to the hanoi engines) or ``"sm_interleave"``
        (Python scheduler, any single-warp ``inner``); the two give
        bit-identical results.  The default, None, is ``sm_torch`` for a
        hanoi ``inner`` (``hanoi``, ``hanoi_torch``) and ``sm_interleave``
        for any other.

        A sink receives each warp as one normalized run whose begin event
        is the SM variant of the replay meta
        (:func:`~repro_torch.engine.sinks.sm_run_meta`: warp index, cell
        width, policy, cell id, full replay payload, and the cell's
        ``sm_timing`` stamp) — SM-cell archives replay offline exactly like
        single-warp ones.
        """
        from .mechanisms.sm import build_sm_result, per_warp_programs
        if sm_mechanism == "sm_jax":
            raise ValueError("sm_mechanism 'sm_jax' is the JAX package's; "
                             "the port's lane-parallel SM engine is "
                             "'sm_torch'")
        if sm_mechanism not in (None, "sm_interleave", "sm_torch"):
            raise ValueError(f"sm_mechanism must be 'sm_interleave' or "
                             f"'sm_torch', got {sm_mechanism!r}")
        if inner is None:
            inner_name = self._default
            if "composite" in get_mechanism(inner_name).tags:
                inner_name = "hanoi_torch"   # default fallback only:
        else:                                # nesting is an error below
            inner_mech = get_mechanism(inner)
            inner_name = inner_mech.name
            if "composite" in inner_mech.tags:
                raise ValueError("inner must be a single-warp mechanism, "
                                 f"not the composite {inner_name!r}")
        if sm_mechanism is None:
            from .mechanisms.sm_torch import _SUPPORTED_INNER
            sm_mechanism = ("sm_torch" if inner_name in _SUPPORTED_INNER
                            else "sm_interleave")
        per_warp = per_warp_programs(programs, n_warps)
        if not per_warp:
            raise ValueError("run_sm needs at least one warp")
        reqs = [self._request(p, cfg, **request_kw) for p in per_warp]
        if sm_mechanism == "sm_torch":
            from .mechanisms.sm_torch import run_cells
            sm = run_cells([reqs], policy=policy, timing_cfg=timing_cfg,
                           inner_label=inner_name)[0]
            results: Sequence[SimResult] = sm.warps
        else:
            # dispatch through the shared planner (the run_batch path) but
            # feed the sink ourselves: warps of an SM cell archive under
            # sm_run_meta, not the single-warp run_meta run_batch stamps
            from repro_torch.service.planner import execute_plan  # lazy
            mech = get_mechanism(inner_name)
            t0 = time.perf_counter()
            results = execute_plan(mech, reqs,
                                   max_workers=self._max_workers)
            wall = time.perf_counter() - t0
            sm = build_sm_result(reqs, results, inner=inner_name,
                                 policy=policy, timing_cfg=timing_cfg,
                                 wall_time_s=wall)
        out_sink = sink or self._sink
        if out_sink is not None:
            cell = next_sm_cell_id()
            tmeta = timing_meta(sm)
            for w, (req, res) in enumerate(zip(reqs, results)):
                feed_result(out_sink, res,
                            sm_run_meta(inner_name, req, warp=w,
                                        n_warps=len(reqs), policy=sm.policy,
                                        cell=cell, timing=tmeta))
        return sm

    # -- mechanism comparison (the paper's evaluation as an API) ------------

    def compare(self, mechanisms: "str | Sequence[str]",
                programs: Iterable[ProgramLike] | None = None,
                cfg: MachineConfig | None = None, *,
                baseline: str | None = None,
                pairs: Sequence[tuple[str, str]] | None = None,
                timing: "bool | str" = True,
                timing_warps: int = 4,
                timing_cfg: "TimingConfig | object" = TimingConfig(),
                **request_kw) -> CompareReport:
        """Run ``programs`` under each mechanism; diff every pair.

        For each program and ordered pair ``(a, b)`` the report carries the
        paper's two metrics: control-flow trace discrepancy (normalized
        Levenshtein, ``b`` as the reference — Fig 9) and the relative IPC
        delta from the GTO timing model (Fig 10, with ``timing_warps``
        identical warps per scheduler; the numpy
        :func:`~repro_torch.core.timing.simulate`, as in the reference).
        ``pairs`` defaults to all ordered pairs of ``mechanisms``.

        ``timing`` selects the IPC model:

        * ``True`` / ``"trace"`` — the legacy trace-conservative uniform
          model (every instruction depends on its predecessor);
        * ``"cycle"`` — the event-driven cycle engine
          (:mod:`repro_torch.timing`) with per-warp register scoreboards,
          the Fig 10 configuration the paper's 0.19%-IPC claim is judged
          under; per-schedule stall breakdowns land in
          ``report.timing_results``.  ``timing_cfg`` may be a
          :class:`~repro_torch.timing.CycleConfig` to also pick memory
          distributions / dual issue (a plain :class:`TimingConfig` is
          lifted onto the scoreboard model);
        * ``False`` — skip the timing model: IPC fields come back NaN and
          utilization is taken directly from the traces.

        Conveniences: ``mechanisms`` may be a single name, ``baseline``
        appends a reference mechanism and restricts ``pairs`` to
        ``(mech, baseline)``, and ``programs=None`` defaults to the paper's
        benchmark suite under the paper's evaluation config — so
        ``compare("hanoi_torch", baseline="turing_oracle")`` is a complete
        evaluation call.
        """
        if isinstance(timing, str) and timing not in ("trace", "cycle"):
            raise ValueError(f"timing must be True/False/'trace'/'cycle', "
                             f"got {timing!r}")
        if isinstance(mechanisms, str):
            mechanisms = [mechanisms]
        names = [get_mechanism(m).name for m in mechanisms]
        if baseline is not None:
            base = get_mechanism(baseline).name
            if pairs is None:
                pairs = [(m, base) for m in names if m != base]
            if base not in names:
                names.append(base)
        if programs is None:
            from repro_torch.core.programs import make_suite
            if cfg is None:     # the paper's evaluation config, not the
                cfg = MachineConfig(n_threads=32, mem_size=256,
                                    max_steps=60_000)   # 4096-fuel default
            programs = make_suite(cfg)
        reqs = [self._request(p, cfg, **request_kw) for p in programs]
        # unique program ids (anonymous ndarrays would otherwise collide)
        pids: list[str] = []
        for i, req in enumerate(reqs):
            pid = req.name or f"prog{i}"
            if pid in pids:
                pid = f"{pid}#{i}"
            pids.append(pid)
        results: dict[tuple[str, str], SimResult] = {}
        for mech_name in names:
            for pid, res in zip(pids,
                                self.run_batch(reqs, mechanism=mech_name)):
                results[(pid, mech_name)] = res

        if pairs is None:
            pairs = [(a, b) for a, b in itertools.permutations(names, 2)]
        rows = []
        timing_cache: dict[tuple[str, str], Any] = {}
        if timing == "cycle":
            from repro_torch.timing import CycleConfig
            run_cfg: Any = CycleConfig.from_timing(timing_cfg,
                                                   scoreboard=True)
        else:
            run_cfg = timing_cfg

        def timed(pid: str, req: SimRequest, mech_name: str):
            key = (pid, mech_name)
            if key not in timing_cache:
                res = results[key]
                timing_cache[key] = simulate(
                    [list(res.trace)] * timing_warps, req.program,
                    req.resolved_cfg().n_threads, run_cfg)
            return timing_cache[key]

        nan = float("nan")
        for pid, req in zip(pids, reqs):
            for a, b in pairs:
                ra, rb = results[(pid, a)], results[(pid, b)]
                if timing:
                    ta, tb = timed(pid, req, a), timed(pid, req, b)
                    ipc_a, ipc_b = ta.ipc, tb.ipc
                    delta = ipc_delta(ta, tb)
                    util_a, util_b = ta.simd_utilization, tb.simd_utilization
                else:
                    ipc_a = ipc_b = delta = nan
                    util_a, util_b = ra.utilization, rb.utilization
                rows.append(CompareRow(
                    program=pid, mech_a=a, mech_b=b,
                    discrepancy=discrepancy(list(ra.trace), list(rb.trace)),
                    ipc_a=ipc_a, ipc_b=ipc_b,
                    ipc_delta=delta,
                    util_a=util_a, util_b=util_b,
                    status_a=ra.status.value, status_b=rb.status.value,
                    trace_len_a=len(ra.trace), trace_len_b=len(rb.trace)))
        return CompareReport(mechanisms=tuple(names), rows=tuple(rows),
                             results=results, timing_results=timing_cache)

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _feed_sink(sink: TraceSink | None, mech: Mechanism,
                   req: SimRequest, result: SimResult) -> None:
        if sink is None:       # don't build the replay payload just to
            return             # throw it away — run/run_batch hot path
        feed_result(sink, result, run_meta(mech.name, req))
