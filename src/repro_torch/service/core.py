"""The queue-fed simulation service: admission, coalescing, sharded dispatch
(port of ``repro.service.core``).

Architecture (thread tier)::

    submit()/submit_sm()                 service threads
        |                                   |
        v                                   v
    BatchCoalescer --size flush--> dispatch queue --> worker pool
        |                              ^                 |
        +--deadline flush (flusher)----+                 v
                                             planner.run_group /
                                             Simulator.run_sm
                                                  |
                                                  v
                                      tickets resolved + archive sink

With ``procs=N`` the dispatch queue + worker pool is replaced by the
**process tier** (:mod:`repro_torch.service.procpool`): flushed groups and
SM cells route to N spawned shard processes — torch groups by signature
affinity, numpy groups chunked across shards — and one collector thread
resolves tickets from the reply queue.  ``warm_start=`` points both tiers
at a persistent :mod:`repro_torch.engine.compile_cache` directory that is
replayed before traffic is admitted.

The service runs where its ``device`` says: the card unless it is asked
for the CPU (``device="cpu"``: the plain twins of K1 and K2).  The device
goes to its :class:`~repro_torch.engine.Simulator`, to every admitted
request's ``meta["device"]`` as the Simulator stamps it, and to every
shard.  A group whose kernel fails to build or launch fails its tickets
with that error; nothing is run again elsewhere.

* **Admission**: ``submit`` coerces the request, derives its
  :class:`~repro_torch.service.signature.ExecSignature`, hands it to the
  :class:`~repro_torch.service.coalescer.BatchCoalescer`, and returns a
  :class:`SimTicket` immediately.
* **Coalescing**: a group flushes when it reaches ``max_batch`` (on the
  admitting thread) or when its oldest entry has waited ``max_wait_s``
  (the flusher thread) — see the coalescer module for the exact rules.
* **Dispatch**: workers execute flushed groups through
  :func:`repro_torch.service.planner.run_group` — the same routing the
  ``Simulator.run_batch`` façade uses — so signature-homogeneous
  ``hanoi_torch`` groups hit the native ``batch_runner``: one launch of K1
  a group.  Each worker thread launches on its own CUDA stream, so one
  group's ``wall_time_s`` never holds another's launch.
* **Sharding**: per-SM jobs bypass the coalescer; each ``submit_sm`` call
  is one (SM, policy) cell executed as a single ``Simulator.run_sm`` on
  the worker pool, and :meth:`SimulationService.run_sm_grid` fans a grid
  of cells out across it.
* **Archival**: every completed warp is replayed into the ``archive``
  sink (e.g. a :class:`~repro_torch.engine.sinks.RotatingJsonlSink`) under a
  lock, so any TraceSink — thread-safe or not — sees whole runs.
* **Metrics**: :meth:`SimulationService.stats` snapshots a frozen
  :class:`ServiceStats` (queue depth, latency percentiles, warps/s,
  batch-fill histogram, native-batch routing counters).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from repro_torch.core.isa import MachineConfig
from repro_torch.core.timing import TimingConfig
from repro_torch.core.trace import nearest_rank
from repro_torch.device import resolve
from repro_torch.engine.compile_cache import (compile_cache_stats,
                                              install_compile_cache)
from repro_torch.engine.registry import get_mechanism
from repro_torch.engine.simulator import ProgramLike, Simulator, as_request
from repro_torch.engine.sinks import (RotatingJsonlSink, TraceSink,
                                      feed_result, next_sm_cell_id, run_meta,
                                      sm_run_meta, timing_meta)
from repro_torch.engine.types import SimRequest, SimResult, SmResult

from .coalescer import BatchCoalescer, FlushedGroup
from .planner import group_is_native, run_group
from .procpool import ArchiveSpec, ProcPool, ServiceStopped
from .signature import ExecSignature, shard_of, signature_of

__all__ = ["ServiceStats", "ShardStats", "SimTicket", "SimulationService",
           "ServiceStopped"]

_SENTINEL = object()


class SimTicket:
    """Future-like handle for one admitted request (or one SM cell).

    ``result(timeout)`` blocks until the service resolves it; ``done()`` /
    ``exception()`` mirror :class:`concurrent.futures.Future`.
    """

    def __init__(self, signature: ExecSignature | None = None) -> None:
        self.signature = signature
        self.submitted_at = time.monotonic()
        self._future: "Future[Any]" = Future()

    def result(self, timeout: float | None = None):
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: float | None = None):
        return self._future.exception(timeout)


@dataclass(frozen=True)
class ShardStats:
    """Per-process view merged into :class:`ServiceStats` (process tier).

    Latency percentiles here are computed over *this shard's* reservoir;
    the service-level percentiles are nearest-rank over the merged union
    of every shard's reservoir — never an average of averages.
    """

    shard: int
    pid: int | None
    alive: bool
    jobs: int                     # jobs routed to this shard
    completed: int                # warps resolved from this shard
    failed: int
    latency_p50_s: float
    latency_p99_s: float
    cache_hits: int = 0
    cache_misses: int = 0         # kernel-cache misses in the shard
    cache_disk_hits: int = 0
    cache_entries: int = 0
    cache_evictions: int = 0
    cache_trace_time_s: float = 0.0
    # (kernel, count) pairs: the shard's K1 / K2 launches so far
    launches: tuple[tuple[str, int], ...] = ()


@dataclass(frozen=True)
class ServiceStats:
    """Frozen snapshot of service health and throughput.

    Latency percentiles cover admission -> resolution for the most recent
    requests (bounded window); ``warps_per_s`` is completed warp requests
    over service uptime.  ``submitted`` / ``completed`` / ``failed`` count
    *warps*: an (SM, policy) cell contributes one warp per member — so
    ``warps_per_s`` measures real SM traffic, not cells — while its cell
    latency is recorded once and ``sm_jobs`` counts the cell.
    ``batch_fill`` is the coalescing histogram: ``(batch_size, count)``
    pairs, ascending — a service soaking enough homogeneous traffic shows
    mass at ``max_batch``.

    The ``sm_*_cycles`` fields aggregate the cycle-level stall taxonomy
    (:mod:`repro_torch.timing`) over every SM cell this
    service executed — the fleet-level view of where issue slots went.
    """

    uptime_s: float
    submitted: int
    completed: int
    failed: int
    rejected: int                 # refused at admission by static analysis
    repaired: int                 # auto-annotate rewrites admitted (warps)
    queue_depth: int              # admitted, not yet flushed to dispatch
    inflight: int                 # flushed, not yet resolved
    batches: int                  # flushed groups executed
    native_batches: int           # groups routed to a native batch_runner
    native_warps: int             # requests executed inside native batches
    sm_jobs: int                  # (SM, policy) cells executed
    flush_size: int               # flushes triggered by max_batch
    flush_deadline: int           # flushes triggered by max_wait_s
    flush_manual: int             # flushes triggered by flush()/stop()
    batch_fill: tuple[tuple[int, int], ...]
    latency_p50_s: float
    latency_p99_s: float
    warps_per_s: float
    sm_cycles: int = 0                    # total SM-cell schedule cycles
    sm_busy_cycles: int = 0
    sm_issue_stall_cycles: int = 0
    sm_scoreboard_stall_cycles: int = 0
    sm_memory_stall_cycles: int = 0
    # process tier (0 shard processes = classic thread tier)
    procs: int = 0
    shards: tuple[ShardStats, ...] = ()
    # kernel-cache counters of the execution tier (every shard, or this
    # process): cache_misses counts first launches at a key (the warm-start
    # gate drives this to zero for hot signatures), cache_disk_hits keys
    # whose libraries the persistent cache found built, cache_trace_time_s
    # the seconds misses spent loading (or building) kernel libraries
    cache_hits: int = 0
    cache_misses: int = 0
    cache_disk_hits: int = 0
    cache_entries: int = 0
    cache_evictions: int = 0
    cache_trace_time_s: float = 0.0
    # warm-start replay outcome, summed across shards
    warm_signatures: int = 0
    warm_loaded: int = 0
    warm_retraced: int = 0

    @property
    def mean_fill(self) -> float:
        """Mean coalesced batch size (1.0 = no coalescing happening)."""
        n = sum(c for _, c in self.batch_fill)
        if n == 0:
            return float("nan")
        return sum(s * c for s, c in self.batch_fill) / n

    @property
    def sm_stall_breakdown(self) -> dict[str, int]:
        return {"issue": self.sm_issue_stall_cycles,
                "scoreboard": self.sm_scoreboard_stall_cycles,
                "memory": self.sm_memory_stall_cycles}


@dataclass
class _WarpEntry:
    ticket: SimTicket
    request: SimRequest


@dataclass
class _SmJob:
    ticket: SimTicket
    programs: Any
    cfg: MachineConfig | None
    kwargs: dict
    warps: int = 1      # cell width, counted into the warp-level stats


@dataclass
class _PendingGroup:
    """Parent-side context for one group job in flight on a shard."""

    entries: list                 # coalescer entries (ticket + request)
    mechanism: str
    native: bool
    shard: int


@dataclass
class _PendingSm:
    """Parent-side context for one SM cell in flight on a shard."""

    job: _SmJob
    shard: int


class SimulationService:
    """Queue-fed, coalescing, sharded control-flow simulation service.

    >>> with SimulationService(device="cpu") as svc:
    ...     tickets = [svc.submit(prog, cfg) for prog in programs]
    ...     svc.flush()
    ...     results = [t.result() for t in tickets]

    Parameters
    ----------
    default_mechanism:
        Mechanism for requests that do not name one (``submit(...,
        mechanism=...)`` overrides per request — the service is
        multi-mechanism by design; DARM-style plugins registered via
        ``register_mechanism`` are served with no service changes).
        Default ``hanoi_torch``: kernel K1 on the card.
    device:
        Where the torch mechanisms run: None means the card, and the
        service raises at construction without one; ``"cpu"`` runs their
        plain twins.  It goes to the service's Simulator, into each
        admitted request's ``meta["device"]`` (unless the request names
        one) and to every shard process.
    max_batch / max_wait_s:
        Coalescer flush thresholds (size / admission-latency deadline).
    workers:
        Worker threads executing flushed groups and SM cells.  Native torch
        batches release the GIL while K1 runs; numpy groups are
        pure-Python loops, so more workers mostly helps mixed/torch
        traffic.
    procs:
        Shard *processes* (the process tier; ``0`` = classic thread tier).
        Flushed groups and SM cells route to spawned shard processes:
        torch-backed groups by signature affinity (each shard keeps its own
        hot kernel cache), numpy groups split into per-shard chunks (no
        prepared state to keep local — spreading them is what breaks the
        GIL's single-core ceiling).
    warm_start:
        Directory of a persistent :class:`~repro_torch.engine.compile_cache.
        CompileCache`.  Kernel-cache misses are recorded there; at start-up
        the hot-signature manifest is replayed (each shard warms its
        affine slice: libraries loaded, one launch a key) *before* traffic
        is admitted, so restarts take no miss on the serving path.
    archive:
        Optional :class:`~repro_torch.engine.sinks.TraceSink` that receives
        every completed warp (whole runs, serialized under a service lock).
        In the process tier a
        :class:`~repro_torch.engine.sinks.RotatingJsonlSink`
        is re-homed per shard: shard K writes its own rotated
        ``{prefix}-shard{K}`` family into the same directory (the parent
        sink itself stays unwritten); any other sink type is fed
        parent-side from the returned results.
    annotate:
        Attach ``meta["service"]`` (batch size, native routing, flush
        cause, signature key — plus the shard id in the process tier) to
        every result — instrumentation for tests and callers;
        architectural fields are never touched.
    verify:
        Static pre-admission analysis (:mod:`repro_torch.analysis`, default
        on): programs with ``error``-level diagnostics are *rejected at
        admission* — the ticket resolves immediately with a
        :class:`~repro_torch.analysis.StaticAnalysisError` carrying the full
        diagnostic report, nothing is dispatched to a shard, and the
        ``rejected`` stats counter is bumped.  ``"strict"`` also rejects
        on warnings; ``False`` admits everything (the façade default —
        use it to study intentionally-broken programs).
    shard_init:
        Optional module-level callable, pickled by reference and invoked
        as ``shard_init(shard)`` inside every spawned shard before it
        serves — the hook for registering plugin mechanisms in shard
        processes (a parent-process ``register_mechanism`` call does not
        cross the spawn boundary).
    """

    def __init__(self, *, default_mechanism: str = "hanoi_torch",
                 device=None, max_batch: int = 64, max_wait_s: float = 0.005,
                 workers: int = 2, procs: int = 0,
                 warm_start: str | None = None,
                 archive: TraceSink | None = None,
                 annotate: bool = True,
                 verify: "bool | str" = True,
                 auto_annotate: bool = False,
                 shard_init=None) -> None:
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if procs < 0:
            raise ValueError(f"procs must be >= 0, got {procs}")
        self._default = get_mechanism(default_mechanism).name
        self._device = resolve(device)            # raises without a card
        device = None if device is None else str(device)
        self._coalescer: BatchCoalescer[_WarpEntry] = BatchCoalescer(
            max_batch=max_batch, max_wait_s=max_wait_s)
        # serializes admission against shutdown: stop() flips _stopping
        # under this lock, so no submit can slip an entry into the
        # coalescer (or a job behind the worker sentinels) after the final
        # flush/drain has begun — that entry's ticket would never resolve
        self._admission_lock = threading.Lock()
        self._n_workers = int(workers)
        self._archive = archive
        self._archive_lock = threading.Lock()
        self._annotate = annotate
        self._verify = verify
        self._auto_annotate = auto_annotate
        # SM cells / shared façade; stamps the device into every request
        self._sim = Simulator(self._default, device=device)
        self._device_arg = device
        self._dispatch: "queue.Queue[Any]" = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._flusher_wake = threading.Event()
        self._started = False
        self._stopping = False
        self._lock = threading.Lock()             # stats + lifecycle
        self._stats = {
            "submitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "repaired": 0, "inflight": 0,
            "batches": 0, "native_batches": 0, "native_warps": 0,
            "sm_jobs": 0, "flush_size": 0, "flush_deadline": 0,
            "flush_manual": 0,
            "sm_cycles": 0, "sm_busy_cycles": 0, "sm_issue_stall_cycles": 0,
            "sm_scoreboard_stall_cycles": 0, "sm_memory_stall_cycles": 0,
        }
        self._fill: Counter = Counter()
        self._latencies: deque = deque(maxlen=4096)
        self._started_at = time.monotonic()
        # process tier
        self._n_procs = int(procs)
        self._warm_start = warm_start
        self._shard_init = shard_init
        self._pool: ProcPool | None = None
        # per-shard latency reservoirs; stats() merges their union with
        # self._latencies and takes nearest-rank percentiles over the whole
        # merged sample — averaging per-shard percentiles would be wrong
        self._shard_latencies: dict[int, deque] = {}
        self._shard_counters: dict[int, Counter] = {}
        self._warm_reports: list[dict] = []       # thread-tier warm outcome
        self._last_shards: tuple[ShardStats, ...] = ()
        self._last_cache: dict[str, float] = {}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "SimulationService":
        with self._lock:
            if self._started:
                return self
            self._started = True
            self._stopping = False
            self._started_at = time.monotonic()
        if self._n_procs > 0:
            archive_spec = None
            if isinstance(self._archive, RotatingJsonlSink):
                # re-home the rotated archive per shard: shard K writes its
                # own {prefix}-shardK family into the same directory; the
                # parent's sink object stays unwritten
                archive_spec = ArchiveSpec(
                    directory=self._archive.directory,
                    prefix=self._archive.prefix,
                    max_bytes=self._archive.max_bytes)
            self._pool = ProcPool(
                self._n_procs, default_mechanism=self._default,
                device=self._device_arg,
                annotate=self._annotate, archive=archive_spec,
                warm_start=self._warm_start, shard_init=self._shard_init,
                on_reply=self._on_pool_reply)
            if self._warm_start:
                # warm-start contract: every shard replays its affine slice
                # of the hot-signature manifest *before* traffic is admitted
                if not self._pool.wait_ready(timeout=300.0):
                    stragglers = self._pool.stop(deadline=time.monotonic())
                    self._pool = None
                    with self._lock:
                        self._started = False
                    raise RuntimeError(
                        "SimulationService: shard processes not ready "
                        f"after warm start (terminated: {stragglers})")
        elif self._warm_start:
            cache = install_compile_cache(self._warm_start)
            self._warm_reports = [cache.warm(
                shard=0, n_shards=1, device=self._device).as_dict()]
        flusher = threading.Thread(target=self._flusher_loop, daemon=True,
                                   name="sim-service-flusher")
        flusher.start()
        self._threads.append(flusher)
        if self._pool is None:
            for i in range(self._n_workers):
                w = threading.Thread(target=self._worker_loop, daemon=True,
                                     name=f"sim-service-worker-{i}")
                w.start()
                self._threads.append(w)
        return self

    def stop(self, *, timeout: float = 30.0) -> list[str]:
        """Flush all pending work, drain it, and join the threads.

        ``timeout`` is ONE shared deadline across every join — not a
        per-thread/per-shard budget (which would make the worst-case
        shutdown ``(workers + 1) x timeout``).  Returns the names of
        threads — and, in the process tier, shard processes — still alive
        when the deadline expired (empty list = clean shutdown).  A shard
        that misses the deadline is **terminated**, and every ticket still
        in flight on the pool resolves with :class:`ServiceStopped`
        instead of hanging forever.
        """
        with self._admission_lock:
            with self._lock:
                if not self._started:
                    return []
                self._stopping = True
        self.flush()
        deadline = time.monotonic() + timeout
        stragglers: list[str] = []
        if self._pool is not None:
            self._flusher_wake.set()
            stragglers += self._pool.stop(deadline=deadline)
            self._snapshot_pool()
            self._pool = None
        else:
            self._dispatch.join()                 # drain in-flight jobs
            for _ in range(self._n_workers):
                self._dispatch.put(_SENTINEL)
            self._flusher_wake.set()
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        stragglers += [t.name for t in self._threads if t.is_alive()]
        self._threads.clear()
        with self._lock:
            self._started = False
        return stragglers

    def __enter__(self) -> "SimulationService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _ensure_started(self) -> None:
        if not self._started:
            self.start()
        if self._stopping:
            raise RuntimeError("SimulationService is stopping")

    # -- admission ----------------------------------------------------------

    def _admission_error(self, req: SimRequest):
        """The :class:`~repro_torch.analysis.StaticAnalysisError` for
        ``req``, or None when it passes (or verification is off)."""
        if not self._verify:
            return None
        from repro_torch.analysis import StaticAnalysisError, verify_program
        try:
            verify_program(req.program, req.resolved_cfg(), name=req.name,
                           strict=(self._verify == "strict"))
        except StaticAnalysisError as exc:
            return exc
        return None

    def _repair(self, req: SimRequest) -> "SimRequest | None":
        """``auto_annotate`` path: a synthesized copy of ``req`` that
        passes admission, or None when the synthesizer refuses
        (CALL/RET-crossing regions), changes nothing, or the rewrite
        still fails verification (e.g. ``reconvergence`` errors the
        synthesizer cannot undo)."""
        from repro_torch.analysis import (TransformError,
                                          synthesize_annotations)
        try:
            syn = synthesize_annotations(req.program, req.resolved_cfg(),
                                         name=req.name)
        except TransformError:
            return None
        if not syn.changed:
            return None
        fixed = dataclasses.replace(req, program=syn.program)
        if self._admission_error(fixed) is not None:
            return None
        return fixed

    def _reject(self, ticket: SimTicket, exc: Exception, warps: int) -> None:
        """Resolve a ticket with a rejection — nothing is dispatched."""
        with self._lock:
            self._stats["submitted"] += warps
            self._stats["rejected"] += warps
        ticket._future.set_exception(exc)

    def submit(self, program: ProgramLike,
               cfg: MachineConfig | None = None, *,
               mechanism: str | None = None, **request_kw) -> SimTicket:
        """Admit one warp request; returns immediately with a ticket.

        Statically-invalid programs (see the ``verify`` constructor knob)
        are rejected here: the ticket carries the analysis report as its
        exception and no shard ever sees the request.  With
        ``auto_annotate=True`` a rejection is first routed through the
        annotation synthesizer — repaired programs are admitted (and
        counted in ``ServiceStats.repaired``); only programs the
        synthesizer cannot fix are rejected.
        """
        mech = get_mechanism(mechanism or self._default)
        req = self._sim._request(program, cfg, **request_kw)
        exc = self._admission_error(req)
        repaired = False
        if exc is not None and self._auto_annotate:
            fixed = self._repair(req)
            if fixed is not None:
                req, exc, repaired = fixed, None, True
        # signature after repair: the admitted program is what coalesces
        sig = signature_of(mech, req)
        ticket = SimTicket(sig)
        if exc is not None:
            self._reject(ticket, exc, 1)
            return ticket
        with self._admission_lock:
            self._ensure_started()
            with self._lock:
                self._stats["submitted"] += 1
                if repaired:
                    self._stats["repaired"] += 1
            full, created = self._coalescer.add(sig, _WarpEntry(ticket, req))
            if full is not None:
                self._enqueue_group(full)
            elif created:
                self._flusher_wake.set()          # new earliest deadline
        return ticket

    def submit_many(self, programs: Sequence[ProgramLike],
                    cfg: MachineConfig | None = None, *,
                    mechanism: str | None = None,
                    **request_kw) -> list[SimTicket]:
        return [self.submit(p, cfg, mechanism=mechanism, **request_kw)
                for p in programs]

    def submit_sm(self, programs: "ProgramLike | Sequence[ProgramLike]",
                  cfg: MachineConfig | None = None, *,
                  n_warps: int | None = None, inner: str | None = None,
                  policy: str = "round_robin",
                  timing_cfg: TimingConfig = TimingConfig(),
                  **request_kw) -> SimTicket:
        """Admit one (SM, policy) cell — executed as a single sharded
        ``Simulator.run_sm`` call on the worker pool, bypassing the
        coalescer (an SM cell is already a batch of warps).

        Stats count the cell's *warps* into ``submitted`` / ``completed``
        (``warps_per_s`` measures SM traffic, not cells); ``sm_jobs`` and
        the latency window record the cell once.
        """
        from repro_torch.engine.mechanisms.sm import (per_warp_programs,
                                                      warp_count)
        warps = warp_count(programs, n_warps)
        ticket = SimTicket()
        if self._verify:
            try:
                per_warp = per_warp_programs(programs, n_warps)
            except ValueError:
                # programs/n_warps conflict: not a static-analysis matter —
                # admit and let run_sm fail it per warp, as without verify
                per_warp = ()
            fixed_warps: list = []
            n_repaired = 0
            for p in per_warp:
                req = as_request(p, cfg, **request_kw)
                exc = self._admission_error(req)
                if exc is not None and self._auto_annotate:
                    fixed = self._repair(req)
                    if fixed is not None:
                        fixed_warps.append(fixed.program)
                        n_repaired += 1
                        continue
                if exc is not None:
                    self._reject(ticket, exc, max(1, warps))
                    return ticket
                fixed_warps.append(p)
            if n_repaired:
                # admit the repaired cell: the per-warp expansion *is*
                # the program list now, so pin n_warps to its length
                programs, n_warps = fixed_warps, len(fixed_warps)
        else:
            n_repaired = 0
        job = _SmJob(ticket=ticket, programs=programs, cfg=cfg,
                     kwargs=dict(n_warps=n_warps, inner=inner, policy=policy,
                                 timing_cfg=timing_cfg, **request_kw),
                     warps=max(1, warps))
        with self._admission_lock:
            self._ensure_started()
            with self._lock:
                self._stats["submitted"] += job.warps
                self._stats["inflight"] += job.warps
                self._stats["repaired"] += n_repaired
            if self._pool is not None:
                # cell-shape affinity: cells sharing (inner, policy, cfg,
                # width) land on one shard and reuse its compiled SM state
                token = (f"sm|{job.kwargs.get('inner') or self._default}"
                         f"|{job.kwargs.get('policy')}|{job.cfg!r}"
                         f"|w{job.warps}")
                shard = self._pool.shard_for_token(token)
                self._pool.submit_sm(
                    shard, programs=job.programs, cfg=job.cfg,
                    kwargs=job.kwargs, ctx=_PendingSm(job=job, shard=shard))
            else:
                self._dispatch.put(job)
        return ticket

    # -- synchronous conveniences -------------------------------------------

    def run(self, requests: Sequence[ProgramLike],
            cfg: MachineConfig | None = None, *,
            mechanism: str | None = None, timeout: float | None = None,
            **request_kw) -> list[SimResult]:
        """Submit a batch, flush, and wait — results in submission order.

        Mixed batches are fine: requests are coalesced by signature and may
        execute out of order across groups, but the returned list always
        matches the order of ``requests``.
        """
        tickets = self.submit_many(requests, cfg, mechanism=mechanism,
                                   **request_kw)
        self.flush()
        return [t.result(timeout) for t in tickets]

    def run_sm_grid(self, cells: Sequence[Mapping[str, Any]], *,
                    timeout: float | None = None) -> list[SmResult]:
        """Fan a grid of (SM, policy) cells out over the worker pool.

        Each cell is a mapping of :meth:`submit_sm` arguments, e.g.
        ``{"programs": bench, "cfg": cfg, "n_warps": 8, "policy":
        "greedy_then_oldest"}`` — one ``run_sm`` call per cell, the
        ROADMAP's sharding unit.
        """
        tickets = [self.submit_sm(**dict(cell)) for cell in cells]
        return [t.result(timeout) for t in tickets]

    def flush(self) -> None:
        """Force-flush every pending coalescer group to the dispatcher."""
        for group in self._coalescer.flush_all():
            self._enqueue_group(group)

    # -- metrics ------------------------------------------------------------

    def _shard_stats_snapshot(self) -> tuple[ShardStats, ...]:
        """Live per-shard views (process tier); saved snapshot after stop."""
        pool = self._pool
        if pool is None:
            return self._last_shards
        out = []
        for info in pool.shard_info():
            k = info["shard"]
            with self._lock:
                lat = sorted(self._shard_latencies.get(k, ()))
                counters = self._shard_counters.get(k, Counter())
            cache = info["cache"]
            out.append(ShardStats(
                shard=k, pid=info["pid"], alive=info["alive"],
                jobs=info["jobs"],
                completed=int(counters.get("completed", 0)),
                failed=int(counters.get("failed", 0)),
                latency_p50_s=nearest_rank(lat, 0.50),
                latency_p99_s=nearest_rank(lat, 0.99),
                cache_hits=int(cache.get("hits", 0)),
                cache_misses=int(cache.get("misses", 0)),
                cache_disk_hits=int(cache.get("disk_hits", 0)),
                cache_entries=int(cache.get("entries", 0)),
                cache_evictions=int(cache.get("evictions", 0)),
                cache_trace_time_s=float(cache.get("trace_time_s", 0.0)),
                launches=tuple(sorted(info["launches"].items()))))
        return tuple(out)

    def _snapshot_pool(self) -> None:
        """Preserve shard + cache views so stats() stays truthful post-stop."""
        self._last_shards = self._shard_stats_snapshot()
        if self._pool is not None:
            self._last_cache = self._pool.cache_totals()
            self._warm_reports = self._pool.warm_reports()

    def stats(self) -> ServiceStats:
        now = time.monotonic()
        with self._lock:
            s = dict(self._stats)
            # merged latency sample: the parent reservoir plus every
            # shard's reservoir — percentiles are nearest-rank over the
            # union, never an average of per-shard percentiles
            merged = list(self._latencies)
            for d in self._shard_latencies.values():
                merged.extend(d)
            lat = sorted(merged)
            fill = tuple(sorted(self._fill.items()))
            uptime = max(1e-9, now - self._started_at)

        shards = self._shard_stats_snapshot()
        # compile-cache counters of the *execution tier*: the shard
        # processes in the process tier (the parent executes nothing
        # there — mixing in its unrelated cache history would corrupt the
        # zero-miss gate), this process's own caches otherwise
        keys = ("hits", "misses", "disk_hits", "entries", "evictions",
                "trace_time_s")
        if self._pool is not None:
            pooled = self._pool.cache_totals()
        elif self._last_shards:
            pooled = self._last_cache
        else:
            pooled = compile_cache_stats()
        cache = {k: pooled.get(k, 0) for k in keys}
        warm = {"signatures": 0, "loaded": 0, "retraced": 0}
        warm_reports = (self._pool.warm_reports() if self._pool is not None
                        else self._warm_reports)
        for rep in warm_reports:
            for k in warm:
                warm[k] += int(rep.get(k, 0))

        return ServiceStats(
            uptime_s=uptime,
            submitted=s["submitted"], completed=s["completed"],
            failed=s["failed"], rejected=s["rejected"],
            repaired=s["repaired"],
            queue_depth=self._coalescer.depth(),
            inflight=s["inflight"],
            batches=s["batches"], native_batches=s["native_batches"],
            native_warps=s["native_warps"], sm_jobs=s["sm_jobs"],
            flush_size=s["flush_size"], flush_deadline=s["flush_deadline"],
            flush_manual=s["flush_manual"],
            batch_fill=fill,
            latency_p50_s=nearest_rank(lat, 0.50),
            latency_p99_s=nearest_rank(lat, 0.99),
            warps_per_s=s["completed"] / uptime,
            sm_cycles=s["sm_cycles"], sm_busy_cycles=s["sm_busy_cycles"],
            sm_issue_stall_cycles=s["sm_issue_stall_cycles"],
            sm_scoreboard_stall_cycles=s["sm_scoreboard_stall_cycles"],
            sm_memory_stall_cycles=s["sm_memory_stall_cycles"],
            procs=self._n_procs if (self._pool is not None
                                    or self._last_shards) else 0,
            shards=shards,
            cache_hits=int(cache["hits"]),
            cache_misses=int(cache["misses"]),
            cache_disk_hits=int(cache["disk_hits"]),
            cache_entries=int(cache["entries"]),
            cache_evictions=int(cache["evictions"]),
            cache_trace_time_s=float(cache["trace_time_s"]),
            warm_signatures=warm["signatures"], warm_loaded=warm["loaded"],
            warm_retraced=warm["retraced"])

    # -- internals: flusher -------------------------------------------------

    def _enqueue_group(self, group: FlushedGroup[_WarpEntry]) -> None:
        with self._lock:
            self._stats[f"flush_{group.cause}"] += 1
            self._stats["inflight"] += group.size
        if self._pool is not None:
            self._route_group_to_pool(group)
        else:
            self._dispatch.put(group)

    def _route_group_to_pool(self, group: FlushedGroup[_WarpEntry]) -> None:
        """Process-tier routing of one flushed group.

        Torch-backed groups go whole to their signature-affine shard — the
        shard that owns (and stays hot on) that signature's kernel-cache
        state.  Numpy groups have no prepared state to keep local
        and would serialize on one core if pinned, so they split into
        per-shard chunks (round-robin base so successive groups cover
        different shards even when the pool is wider than the group).
        """
        mech = get_mechanism(group.signature.mechanism)
        native = group_is_native(mech, group.signature)
        entries = list(group.entries)
        with self._lock:
            # coalesced fill is recorded per flushed group (pre-chunking):
            # the histogram measures coalescing quality, not shard fan-out
            self._fill[group.size] += 1
        if mech.backend == "numpy" and len(entries) > 1 and self._pool.n > 1:
            n_chunks = min(self._pool.n, len(entries))
            base = self._pool.next_chunk_base()
            for j in range(n_chunks):
                chunk = entries[j::n_chunks]
                shard = (base + j) % self._pool.n
                self._pool.submit_group(
                    shard, mechanism=mech.name, native=False,
                    cause=group.cause, sig_key=group.signature.key,
                    requests=[e.payload.request for e in chunk],
                    ctx=_PendingGroup(entries=chunk, mechanism=mech.name,
                                      native=False, shard=shard))
        else:
            shard = shard_of(group.signature, self._pool.n)
            self._pool.submit_group(
                shard, mechanism=mech.name, native=native,
                cause=group.cause, sig_key=group.signature.key,
                requests=[e.payload.request for e in entries],
                ctx=_PendingGroup(entries=entries, mechanism=mech.name,
                                  native=native, shard=shard))

    def _on_pool_reply(self, ctx, payload, error) -> None:
        """Collector-thread resolution of one shard reply (or abandonment).

        Mirrors the thread tier's ``_execute_group`` / ``_execute_sm``
        bookkeeping: stats, per-shard latency reservoirs, parent-side
        archival for sink types that cannot be re-homed per shard, and
        ticket resolution — success, the rebuilt shard exception, or
        :class:`ServiceStopped` at shutdown.
        """
        now = time.monotonic()
        if isinstance(ctx, _PendingSm):
            job = ctx.job
            counters = self._shard_counters.setdefault(ctx.shard, Counter())
            if error is not None:
                with self._lock:
                    self._stats["failed"] += job.warps
                    self._stats["inflight"] -= job.warps
                    counters["failed"] += job.warps
                job.ticket._future.set_exception(error)
                return
            sm = payload
            if self._archive is not None and not self._pool.shard_archival:
                cell = next_sm_cell_id()
                tmeta = timing_meta(sm)
                for w, (wreq, wres) in enumerate(zip(sm.requests, sm.warps)):
                    self._archive_result(
                        wres, sm.inner,
                        meta=sm_run_meta(sm.inner, wreq, warp=w,
                                         n_warps=sm.n_warps,
                                         policy=sm.policy, cell=cell,
                                         timing=tmeta))
            job.ticket._future.set_result(sm)
            with self._lock:
                self._stats["completed"] += job.warps
                self._stats["inflight"] -= job.warps
                self._stats["sm_jobs"] += 1
                self._stats["sm_cycles"] += sm.cycles
                self._stats["sm_busy_cycles"] += sm.busy_cycles
                self._stats["sm_issue_stall_cycles"] += sm.issue_stall_cycles
                self._stats["sm_scoreboard_stall_cycles"] += \
                    sm.scoreboard_stall_cycles
                self._stats["sm_memory_stall_cycles"] += sm.memory_stall_cycles
                counters["completed"] += job.warps
                self._shard_latencies.setdefault(
                    ctx.shard, deque(maxlen=4096)).append(
                        now - job.ticket.submitted_at)
            return
        # group reply
        n = len(ctx.entries)
        counters = self._shard_counters.setdefault(ctx.shard, Counter())
        if error is not None:
            with self._lock:
                self._stats["failed"] += n
                self._stats["inflight"] -= n
                counters["failed"] += n
            for e in ctx.entries:
                e.payload.ticket._future.set_exception(error)
            return
        results = payload
        if self._archive is not None and not self._pool.shard_archival:
            for e, res in zip(ctx.entries, results):
                self._archive_result(res, ctx.mechanism, e.payload.request)
        for e, res in zip(ctx.entries, results):
            e.payload.ticket._future.set_result(res)
        with self._lock:
            self._stats["completed"] += n
            self._stats["inflight"] -= n
            self._stats["batches"] += 1
            if ctx.native:
                self._stats["native_batches"] += 1
                self._stats["native_warps"] += n
            counters["completed"] += n
            lat = self._shard_latencies.setdefault(ctx.shard,
                                                   deque(maxlen=4096))
            for e in ctx.entries:
                lat.append(now - e.submitted_at)

    def _flusher_loop(self) -> None:
        while True:
            deadline = self._coalescer.next_deadline()
            if deadline is None:
                self._flusher_wake.wait()
            else:
                self._flusher_wake.wait(
                    timeout=max(0.0, deadline - time.monotonic()))
            self._flusher_wake.clear()
            # the admission lock makes pop->enqueue atomic w.r.t. stop():
            # without it, a group popped by due() here could be enqueued
            # *behind* the worker sentinels (stop's flush_all sees an empty
            # coalescer, join() returns, sentinels go in, workers exit) and
            # its tickets would never resolve
            with self._admission_lock:
                with self._lock:
                    if self._stopping:
                        return
                for group in self._coalescer.due():
                    self._enqueue_group(group)

    # -- internals: workers -------------------------------------------------

    def _worker_loop(self) -> None:
        if self._device.type == "cuda":
            # this worker's own stream: its launches and its timing
            # synchronizes never wait on another worker's group
            import torch
            torch.cuda.set_stream(torch.cuda.Stream(self._device))
        while True:
            job = self._dispatch.get()
            try:
                if job is _SENTINEL:
                    return
                if isinstance(job, _SmJob):
                    self._execute_sm(job)
                else:
                    self._execute_group(job)
            finally:
                self._dispatch.task_done()

    def _execute_group(self, group: FlushedGroup[_WarpEntry]) -> None:
        mech = get_mechanism(group.signature.mechanism)
        native = group_is_native(mech, group.signature)
        reqs = [e.payload.request for e in group.entries]
        try:
            results = run_group(mech, reqs, native=native)
        except Exception as exc:                  # resolve the whole group
            with self._lock:
                self._stats["failed"] += group.size
                self._stats["inflight"] -= group.size
            for e in group.entries:
                e.payload.ticket._future.set_exception(exc)
            return
        now = time.monotonic()
        if self._annotate:
            svc_meta = {"batch_size": group.size, "native": native,
                        "flush": group.cause, "signature":
                        group.signature.key}
            results = [dataclasses.replace(
                r, meta={**r.meta, "service": svc_meta}) for r in results]
        for entry, req, res in zip(group.entries, reqs, results):
            self._archive_result(res, mech.name, req)
            entry.payload.ticket._future.set_result(res)
        with self._lock:
            self._stats["completed"] += group.size
            self._stats["inflight"] -= group.size
            self._stats["batches"] += 1
            if native:
                self._stats["native_batches"] += 1
                self._stats["native_warps"] += group.size
            self._fill[group.size] += 1
            for e in group.entries:
                self._latencies.append(now - e.submitted_at)

    def _execute_sm(self, job: _SmJob) -> None:
        try:
            sm = self._sim.run_sm(job.programs, job.cfg, **job.kwargs)
        except Exception as exc:
            with self._lock:
                self._stats["failed"] += job.warps
                self._stats["inflight"] -= job.warps
            job.ticket._future.set_exception(exc)
            return
        now = time.monotonic()
        # archive each warp through the same replayable meta builder the
        # façade uses (sm_run_meta: replay payload + cell coordinates) —
        # a service-archived SM cell replays bit-equal to a live run
        cell = next_sm_cell_id()
        tmeta = timing_meta(sm)
        for w, (warp_req, warp_res) in enumerate(zip(sm.requests, sm.warps)):
            self._archive_result(
                warp_res, sm.inner,
                meta=sm_run_meta(sm.inner, warp_req, warp=w,
                                 n_warps=sm.n_warps, policy=sm.policy,
                                 cell=cell, timing=tmeta))
        job.ticket._future.set_result(sm)
        with self._lock:
            self._stats["completed"] += job.warps
            self._stats["inflight"] -= job.warps
            self._stats["sm_jobs"] += 1
            self._stats["sm_cycles"] += sm.cycles
            self._stats["sm_busy_cycles"] += sm.busy_cycles
            self._stats["sm_issue_stall_cycles"] += sm.issue_stall_cycles
            self._stats["sm_scoreboard_stall_cycles"] += \
                sm.scoreboard_stall_cycles
            self._stats["sm_memory_stall_cycles"] += sm.memory_stall_cycles
            self._latencies.append(now - job.ticket.submitted_at)

    def _archive_result(self, result: SimResult, mechanism: str,
                        req: SimRequest | None = None,
                        meta: Mapping[str, Any] | None = None) -> None:
        if self._archive is None:
            return
        if meta is None:
            assert req is not None
            meta = run_meta(mechanism, req)   # replayable begin event
        from repro_torch.engine.compile_cache import installed_cache
        if installed_cache() is not None:
            # warm-start deployments stamp the kernel-cache counters onto
            # every archived run, so an operator can read miss behavior
            # straight off the archive
            from repro_torch.engine.adapters import batch_cache_stats
            s = batch_cache_stats()
            meta = {**meta, "compile_cache": {
                "hits": s["hits"], "misses": s["misses"],
                "disk_hits": s["disk_hits"],
                "trace_time_s": round(s["trace_time_s"], 6)}}
        with self._archive_lock:
            feed_result(self._archive, result, meta)
