"""Process-backed execution tier: signature-affine shard processes (port
of ``repro.service.procpool``).

The thread-based worker pool has a hard ceiling: torch batches release the
GIL while K1 runs on the card, but the five numpy mechanisms
(``simt_stack``, ``hanoi``, ``dualpath``, ``turing_oracle``, ``volta_itps``)
are pure-Python loops that serialize behind it, so no ``workers=`` setting
buys the service more than ~1 core for them.  :class:`ProcPool` breaks that
ceiling with N **spawned** worker processes (spawn, never fork — forking a
process with a live CUDA context is unsafe) and a routing discipline that
preserves what made the single process fast:

* **Signature-affine routing** — torch-backed groups hash their
  :meth:`~repro_torch.service.signature.ExecSignature.token` (mechanism +
  canonical cfg + scheduling flavor + padding class) to one shard via a
  stable crc32, so each process accumulates its *own* hot kernel cache
  and pad-class locality instead of every shard preparing every
  signature.  SM cells route the same way on a cell-shape token.
* **One device a shard** — each shard builds its ``Simulator`` on the
  service's device: the card unless the service was asked for the CPU, so
  two shards on one card each hold their own CUDA context.
* **Chunked spreading for cacheless work** — a numpy group has no compiled
  state to keep warm, and affine routing would pin a homogeneous numpy mix
  to ONE shard (exactly the single-core ceiling again).  The service
  splits such groups into per-shard chunks instead — that is where the
  ≥1.5x 1→2 process scaling gate in ``bench_service.py --smoke`` comes
  from.
* **Picklable envelopes** — jobs (:class:`GroupJob` / :class:`SmJob`) and
  replies (:class:`Reply`) carry the frozen request/result dataclasses,
  which pickle via ``_PicklableMeta``; exceptions cross the boundary as
  :class:`RemoteError` and are rebuilt parent-side.  Results hold numpy
  arrays, never a torch tensor.
* **Cross-boundary tickets** — the parent keeps a ``job_id -> pending``
  registry; one collector thread drains the shared reply queue and hands
  each reply to the service's resolution callback, so
  :class:`~repro_torch.service.core.SimTicket` futures resolve exactly as
  in the thread tier.
* **Per-shard archives** — each shard owns a
  ``{prefix}-shard{K}-NNNNN.jsonl`` rotated family written by its own
  :class:`~repro_torch.engine.sinks.RotatingJsonlSink`, with disjoint
  SM-cell id ranges, so archival needs no cross-process lock and every family
  replays independently.
* **Warm start** — a shard with a ``warm_start`` cache directory replays
  *its* slice of the persistent kernel-cache manifest (same affinity
  hash) before signalling ready, so a restarted pool prepares hot
  signatures off the serving path.

Shutdown (:meth:`ProcPool.stop`) honors one shared deadline: sentinels, a
bounded join, then ``terminate()`` for stragglers — which are reported by
process name — and every ticket still pending resolves with
:class:`ServiceStopped` instead of hanging forever.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core.isa import MachineConfig
from repro_torch.engine.compile_cache import shard_of_token

__all__ = ["ServiceStopped", "ArchiveSpec", "GroupJob", "SmJob", "Reply",
           "RemoteError", "ProcPool"]


class ServiceStopped(RuntimeError):
    """The service shut down before this ticket's work completed.

    Raised from :meth:`SimTicket.result` for jobs that were in flight on a
    shard which missed the stop deadline (and was terminated), or that
    were still queued when the pool went down.
    """


@dataclass(frozen=True)
class ArchiveSpec:
    """Rotated-archive coordinates a shard can rebuild a sink from."""

    directory: str
    prefix: str = "traces"
    max_bytes: int = 8 << 20

    def shard_prefix(self, shard: int) -> str:
        return f"{self.prefix}-shard{shard}"


@dataclass(frozen=True)
class _ShardSpec:
    """Everything a spawned shard needs to reconstruct its serving env."""

    shard: int
    n_shards: int
    default_mechanism: str
    device: str | None                    # None: the card
    annotate: bool
    archive: ArchiveSpec | None
    warm_start: str | None
    init: Callable[[int], None] | None    # module-level fn, pickled by ref


@dataclass
class GroupJob:
    """One flushed (or chunked) signature-homogeneous group."""

    job_id: int
    mechanism: str
    native: bool
    cause: str
    sig_key: str
    requests: list            # list[SimRequest]


@dataclass
class SmJob:
    """One (SM, policy) cell, executed as a single ``Simulator.run_sm``."""

    job_id: int
    programs: Any
    cfg: MachineConfig | None
    kwargs: dict


@dataclass
class RemoteError:
    """A shard-side exception, flattened for the trip home."""

    type_name: str
    message: str
    tb: str

    @staticmethod
    def from_exception(exc: BaseException) -> "RemoteError":
        return RemoteError(type_name=type(exc).__name__, message=str(exc),
                           tb=traceback.format_exc())

    def to_exception(self) -> Exception:
        import builtins
        et = getattr(builtins, self.type_name, None)
        if isinstance(et, type) and issubclass(et, Exception):
            try:
                return et(self.message)
            except Exception:
                pass
        return RuntimeError(f"{self.type_name}: {self.message}\n{self.tb}")


@dataclass
class Reply:
    job_id: int
    shard: int
    payload: Any = None               # list[SimResult] | SmResult
    error: RemoteError | None = None
    cache: dict | None = None         # adapters.batch_cache_stats snapshot
    launches: dict | None = None      # kernel -> the shard's launch count


@dataclass
class _Ready:
    shard: int
    pid: int
    warm: dict | None = None          # WarmReport.as_dict()


@dataclass
class _Bye:
    shard: int
    cache: dict | None = None
    launches: dict | None = None


def _launch_counts() -> dict:
    """This process's K1 and K2 launch counts (``ops`` wrappers)."""
    from repro_torch.kernels import ops
    return {"hanoi_run": ops.hanoi_run.launches,
            "sm_schedule": ops.sm_schedule.launches}


# ---------------------------------------------------------------------------
# shard process main
# ---------------------------------------------------------------------------

def _shard_main(spec: _ShardSpec, job_q, result_q) -> None:
    """Entry point of one spawned shard process."""
    import dataclasses

    import repro_torch.engine  # noqa: F401  registers the mechanisms
    from repro_torch.engine import sinks as sinks_mod
    from repro_torch.engine.adapters import batch_cache_stats
    from repro_torch.engine.registry import get_mechanism
    from repro_torch.engine.simulator import Simulator
    from repro_torch.engine.sinks import (RotatingJsonlSink, feed_result,
                                          next_sm_cell_id, run_meta,
                                          sm_run_meta, timing_meta)
    from repro_torch.service.planner import run_group

    # disjoint per-shard SM-cell id ranges: two shards archiving cells
    # concurrently must never collide on (cell, warp) coordinates
    sinks_mod._sm_cell_ids = itertools.count(spec.shard * 1_000_000)

    if spec.init is not None:
        spec.init(spec.shard)

    sink = None
    if spec.archive is not None:
        sink = RotatingJsonlSink(spec.archive.directory,
                                 prefix=spec.archive.shard_prefix(spec.shard),
                                 max_bytes=spec.archive.max_bytes)

    warm = None
    if spec.warm_start:
        from repro_torch.engine.compile_cache import install_compile_cache
        cache = install_compile_cache(spec.warm_start)
        warm = cache.warm(shard=spec.shard, n_shards=spec.n_shards,
                          device=spec.device).as_dict()

    result_q.put(_Ready(shard=spec.shard, pid=os.getpid(), warm=warm))
    sim = Simulator(spec.default_mechanism, device=spec.device)

    def _cache_stamp() -> dict:
        s = batch_cache_stats()
        return {"hits": s["hits"], "misses": s["misses"],
                "disk_hits": s["disk_hits"],
                "trace_time_s": round(s["trace_time_s"], 6)}

    def _exec_group(job: GroupJob) -> list:
        mech = get_mechanism(job.mechanism)
        results = run_group(mech, job.requests, native=job.native)
        if spec.annotate:
            svc_meta = {"batch_size": len(job.requests), "native": job.native,
                        "flush": job.cause, "signature": job.sig_key,
                        "shard": spec.shard}
            results = [dataclasses.replace(r, meta={**r.meta,
                                                    "service": svc_meta})
                       for r in results]
        if sink is not None:
            stamp = _cache_stamp()
            for req, res in zip(job.requests, results):
                meta = {**run_meta(mech.name, req), "shard": spec.shard,
                        "compile_cache": stamp}
                feed_result(sink, res, meta)
        return results

    def _exec_sm(job: SmJob):
        sm = sim.run_sm(job.programs, job.cfg, **job.kwargs)
        if sink is not None:
            cell = next_sm_cell_id()
            tmeta = timing_meta(sm)
            stamp = _cache_stamp()
            for w, (wreq, wres) in enumerate(zip(sm.requests, sm.warps)):
                meta = {**sm_run_meta(sm.inner, wreq, warp=w,
                                      n_warps=sm.n_warps, policy=sm.policy,
                                      cell=cell, timing=tmeta),
                        "shard": spec.shard, "compile_cache": stamp}
                feed_result(sink, wres, meta)
        return sm

    try:
        while True:
            job = job_q.get()
            if job is None:
                break
            try:
                payload = (_exec_sm(job) if isinstance(job, SmJob)
                           else _exec_group(job))
                reply = Reply(job_id=job.job_id, shard=spec.shard,
                              payload=payload, cache=batch_cache_stats(),
                              launches=_launch_counts())
            except Exception as exc:
                reply = Reply(job_id=job.job_id, shard=spec.shard,
                              error=RemoteError.from_exception(exc),
                              cache=batch_cache_stats(),
                              launches=_launch_counts())
            result_q.put(reply)
    finally:
        if sink is not None:
            sink.close()
        result_q.put(_Bye(shard=spec.shard, cache=batch_cache_stats(),
                          launches=_launch_counts()))


# ---------------------------------------------------------------------------
# parent-side pool
# ---------------------------------------------------------------------------

@dataclass
class _ShardState:
    proc: Any
    job_q: Any
    pid: int | None = None
    ready: bool = False
    warm: dict | None = None
    cache: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    jobs: int = 0


class ProcPool:
    """N spawned shard processes + one collector thread.

    ``on_reply(ctx, payload, error)`` is the service's resolution hook: it
    runs on the collector thread with the pending context registered at
    submit time, ``payload`` the shard's result (or ``None``), and
    ``error`` an :class:`Exception` (or ``None``).  The pool never touches
    tickets or stats itself — ownership of those stays with the service.
    """

    def __init__(self, n_procs: int, *, default_mechanism: str,
                 annotate: bool, device: str | None = None,
                 archive: ArchiveSpec | None = None,
                 warm_start: str | None = None,
                 shard_init: Callable[[int], None] | None = None,
                 on_reply: Callable[[Any, Any, Exception | None], None]
                 = lambda ctx, payload, error: None) -> None:
        if n_procs < 1:
            raise ValueError(f"procs must be >= 1, got {n_procs}")
        self.n = int(n_procs)
        self.shard_archival = archive is not None
        self._on_reply = on_reply
        self._ctx = mp.get_context("spawn")
        self._result_q = self._ctx.Queue()
        self._job_ids = itertools.count()
        self._pending: dict[int, Any] = {}
        self._pending_lock = threading.Lock()
        self._cursor = itertools.count()      # round-robin base for chunks
        self._ready_event = threading.Event()
        self._stop_event = threading.Event()
        self._shards: list[_ShardState] = []
        for k in range(self.n):
            spec = _ShardSpec(shard=k, n_shards=self.n,
                              default_mechanism=default_mechanism,
                              device=device, annotate=annotate,
                              archive=archive,
                              warm_start=warm_start, init=shard_init)
            job_q = self._ctx.Queue()
            proc = self._ctx.Process(
                target=_shard_main, args=(spec, job_q, self._result_q),
                name=f"sim-shard-{k}", daemon=True)
            proc.start()
            self._shards.append(_ShardState(proc=proc, job_q=job_q))
        self._collector = threading.Thread(target=self._collect,
                                           daemon=True,
                                           name="sim-shard-collector")
        self._collector.start()

    # -- routing ---------------------------------------------------------

    def shard_for_token(self, token: str) -> int:
        return shard_of_token(token, self.n)

    def next_chunk_base(self) -> int:
        return next(self._cursor) % self.n

    # -- submission ------------------------------------------------------

    def submit_group(self, shard: int, *, mechanism: str, native: bool,
                     cause: str, sig_key: str, requests: list,
                     ctx: Any) -> int:
        job_id = next(self._job_ids)
        job = GroupJob(job_id=job_id, mechanism=mechanism, native=native,
                       cause=cause, sig_key=sig_key, requests=requests)
        self._put(shard, job, ctx)
        return job_id

    def submit_sm(self, shard: int, *, programs: Any,
                  cfg: MachineConfig | None, kwargs: dict, ctx: Any) -> int:
        job_id = next(self._job_ids)
        job = SmJob(job_id=job_id, programs=programs, cfg=cfg, kwargs=kwargs)
        self._put(shard, job, ctx)
        return job_id

    def _put(self, shard: int, job, ctx: Any) -> None:
        st = self._shards[shard % self.n]
        with self._pending_lock:
            self._pending[job.job_id] = ctx
            st.jobs += 1
        try:
            st.job_q.put(job)
        except Exception:
            with self._pending_lock:
                self._pending.pop(job.job_id, None)
            raise

    # -- collection ------------------------------------------------------

    def _collect(self) -> None:
        while True:
            try:
                msg = self._result_q.get(timeout=0.1)
            except queue.Empty:
                if self._stop_event.is_set():
                    return
                continue
            except (OSError, EOFError, ValueError):
                return                        # queue torn down under us
            if isinstance(msg, _Ready):
                st = self._shards[msg.shard]
                st.pid, st.ready, st.warm = msg.pid, True, msg.warm
                if all(s.ready for s in self._shards):
                    self._ready_event.set()
                continue
            if msg.cache:
                self._shards[msg.shard].cache = msg.cache
            if msg.launches:
                self._shards[msg.shard].launches = msg.launches
            if isinstance(msg, _Bye):
                continue
            with self._pending_lock:
                ctx = self._pending.pop(msg.job_id, None)
            if ctx is None:
                continue                       # already resolved by stop()
            error = msg.error.to_exception() if msg.error else None
            try:
                self._on_reply(ctx, msg.payload, error)
            except Exception:
                traceback.print_exc()          # keep the collector alive

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until every shard signalled ready (warm-start complete);
        False at the timeout, or as soon as a shard died before it was
        ready."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._ready_event.wait(0.1):
            if any(not st.ready and not st.proc.is_alive()
                   for st in self._shards):
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
        return True

    # -- introspection ---------------------------------------------------

    def pending_count(self) -> int:
        with self._pending_lock:
            return len(self._pending)

    def shard_info(self) -> list[dict[str, Any]]:
        out = []
        for k, st in enumerate(self._shards):
            out.append({"shard": k, "pid": st.pid,
                        "alive": st.proc.is_alive(), "jobs": st.jobs,
                        "warm": st.warm, "cache": dict(st.cache),
                        "launches": dict(st.launches)})
        return out

    def warm_reports(self) -> list[dict[str, Any]]:
        return [dict(st.warm) for st in self._shards if st.warm]

    def cache_totals(self) -> dict[str, float]:
        tot = {"hits": 0, "misses": 0, "disk_hits": 0, "entries": 0,
               "evictions": 0, "trace_time_s": 0.0}
        for st in self._shards:
            for k in tot:
                tot[k] += st.cache.get(k, 0)
        return tot

    # -- shutdown --------------------------------------------------------

    def stop(self, *, deadline: float) -> list[str]:
        """Drain against one shared deadline; terminate and report shards
        that miss it; resolve every still-pending ticket with
        :class:`ServiceStopped`.  Returns the terminated shards' names."""
        for st in self._shards:
            try:
                st.job_q.put(None)             # sentinel: drain then exit
            except Exception:
                pass
        for st in self._shards:
            st.proc.join(timeout=max(0.0, deadline - time.monotonic()))
        # a cleanly-exited shard has replied to everything it ran, but the
        # collector may still be draining the reply queue — give it the
        # remaining budget before declaring tickets abandoned
        while self.pending_count() and time.monotonic() < deadline:
            time.sleep(0.005)
        stragglers = []
        for st in self._shards:
            if st.proc.is_alive():
                stragglers.append(st.proc.name)
                st.proc.terminate()
        for st in self._shards:
            if st.proc.is_alive():
                st.proc.join(timeout=0.5)
        self._stop_event.set()
        self._collector.join(timeout=1.0)
        with self._pending_lock:
            leftover = list(self._pending.items())
            self._pending.clear()
        for _job_id, ctx in leftover:
            try:
                self._on_reply(ctx, None, ServiceStopped(
                    "service stopped before this job completed"))
            except Exception:
                traceback.print_exc()
        for st in self._shards:
            st.job_q.cancel_join_thread()
            st.job_q.close()
        self._result_q.cancel_join_thread()
        self._result_q.close()
        return stragglers
