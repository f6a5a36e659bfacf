"""The Simulator façade: one entry point over every registered mechanism.

Port of ``repro.engine.simulator``: ``run``, ``run_batch`` and ``compare``.
The paths whose modules are not ported yet raise ``NotImplementedError``
naming their ROADMAP.md item, and never fall back: static verification and
annotation synthesis (``verify=``, ``synthesize=``: ``repro.analysis``) and
trace sinks (``sink=``: ``engine.sinks`` needs ``analysis.fingerprint``),
item 13; ``run_sm`` (item 3) and ``compare(timing=...)`` other than ``False``
(the trace and cycle timing models run on ``repro.timing``, item 3).

``Simulator.run`` executes one request, ``run_batch`` many (one launch of
kernel K1 a batch on ``hanoi_torch``; sequential — or opt-in
thread-pooled — on the numpy engines), and ``compare`` runs the same
programs under several mechanisms and reports per-pair trace discrepancy —
the paper's Fig 9 evaluation as a one-call API.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.core.isa import MachineConfig
from repro_torch.core.timing import TimingConfig
from repro_torch.core.trace import discrepancy

from .registry import get_mechanism
from .types import SimRequest, SimResult

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
    """All pairwise rows plus the per-mechanism raw results.

    ``timing_results`` keeps the reference's field; it stays empty until
    the timing models are ported (``compare`` runs with ``timing=False``).
    """

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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, open items, "
        f"{item})")


class Simulator:
    """Façade over the mechanism registry.

    >>> sim = Simulator("hanoi")
    >>> res = sim.run(program, cfg=MachineConfig(n_threads=8))
    >>> res.status
    <SimStatus.OK: 'ok'>

    A default mechanism is chosen at construction; ``run``/``run_batch``
    accept ``mechanism=`` overrides, and ``compare`` takes an explicit list.

    ``max_workers`` opts numpy-mechanism batches into a thread pool.  The
    default (None) runs them sequentially: the reference interpreters are
    per-slot Python loops over tiny arrays, so they hold the GIL and a pool
    only adds contention.

    ``sink`` and ``verify`` are kept for the reference's signature and
    raise unless unset: trace sinks and the static verifier are not ported.
    """

    def __init__(self, mechanism: str = "hanoi", *, sink=None,
                 max_workers: int | None = None,
                 verify: "bool | str" = False) -> None:
        self._default = get_mechanism(mechanism).name   # validate eagerly
        self._max_workers = max_workers
        self._check_unported(sink, verify, False)

    @property
    def mechanism(self) -> str:
        return self._default

    @staticmethod
    def _check_unported(sink, verify, synthesize) -> None:
        if sink is not None:
            raise _not_ported("sink= (engine.sinks, whose replay meta needs "
                              "analysis.fingerprint)", "item 13")
        if verify:
            raise _not_ported("verify= (repro.analysis)", "item 13")
        if synthesize:
            raise _not_ported("synthesize= (repro.analysis)", "item 13")

    # -- single run ---------------------------------------------------------

    def run(self, program: ProgramLike, cfg: MachineConfig | None = None, *,
            mechanism: str | None = None, sink=None,
            verify: "bool | str | None" = None, synthesize: bool = False,
            **request_kw) -> SimResult:
        self._check_unported(sink, verify, synthesize)
        mech = get_mechanism(mechanism or self._default)
        return mech(as_request(program, cfg, **request_kw))

    # -- batched run --------------------------------------------------------

    def run_batch(self, programs: Sequence[ProgramLike],
                  cfg: MachineConfig | None = None, *,
                  mechanism: str | None = None, sink=None,
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
        self._check_unported(sink, verify, synthesize)
        mech = get_mechanism(mechanism or self._default)
        reqs = [as_request(p, cfg, **request_kw) for p in programs]
        if not reqs:
            return []
        from repro_torch.service.planner import execute_plan  # lazy: no
        return execute_plan(mech, reqs,                      # import cycle
                            max_workers=self._max_workers)

    # -- per-SM multi-warp execution ----------------------------------------

    def run_sm(self, *args, **kw):
        """The per-SM multi-warp model (``sm_interleave`` / ``sm_jax`` in
        the reference) is not ported yet: K2 and ``repro.timing``."""
        raise _not_ported("run_sm (the SM model, K2 and repro.timing)",
                          "item 3")

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
        paper's control-flow trace discrepancy (normalized Levenshtein,
        ``b`` as the reference — Fig 9).  ``pairs`` defaults to all ordered
        pairs of ``mechanisms``.

        ``timing`` selects the IPC model (Fig 10).  Both of the reference's
        models, ``True`` / ``"trace"`` and ``"cycle"``, run on the cycle
        engine ``repro.timing``, which is not ported yet: they raise.
        ``False`` skips timing: IPC fields come back NaN and utilization is
        taken directly from the traces.

        Conveniences: ``mechanisms`` may be a single name, ``baseline``
        appends a reference mechanism and restricts ``pairs`` to
        ``(mech, baseline)``, and ``programs=None`` defaults to the paper's
        benchmark suite under the paper's evaluation config — so
        ``compare("hanoi_torch", baseline="turing_oracle", timing=False)``
        is a complete Fig 9 evaluation call.
        """
        if isinstance(timing, str) and timing not in ("trace", "cycle"):
            raise ValueError(f"timing must be True/False/'trace'/'cycle', "
                             f"got {timing!r}")
        if timing:
            raise _not_ported(f"compare(timing={timing!r}) (the IPC models "
                              "run on repro.timing; pass timing=False)",
                              "item 3")
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
        reqs = [as_request(p, cfg, **request_kw) for p in programs]
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
        nan = float("nan")
        for pid, req in zip(pids, reqs):
            for a, b in pairs:
                ra, rb = results[(pid, a)], results[(pid, b)]
                rows.append(CompareRow(
                    program=pid, mech_a=a, mech_b=b,
                    discrepancy=discrepancy(list(ra.trace), list(rb.trace)),
                    ipc_a=nan, ipc_b=nan, ipc_delta=nan,
                    util_a=ra.utilization, util_b=rb.utilization,
                    status_a=ra.status.value, status_b=rb.status.value,
                    trace_len_a=len(ra.trace), trace_len_b=len(rb.trace)))
        return CompareReport(mechanisms=tuple(names), rows=tuple(rows),
                             results=results)
