"""Pluggable trace sinks: one consumer protocol for every engine's trace.

Port of ``repro.engine.sinks`` (numpy only, copied), with one difference:
:func:`replay_payload` leaves the request meta's ``device`` key out, so an
archive does not depend on where it was written (a CPU test's archive
carries no ``"device": "cpu"`` that would pull a replay off the card) and
is line for line the reference's.  Where a replay runs is decided by the
replaying :class:`~repro_torch.engine.Simulator` alone.

Each engine has its own trace format (python list of pairs in the numpy
interpreters, trace buffers in the Hanoi state on the card, int64 token
vectors for Levenshtein).  A :class:`TraceSink` receives the *normalized* stream —
``begin(meta)`` once, ``emit(pc, mask)`` per issued scheduler slot, and
``end(result)`` with the finished :class:`~repro_torch.engine.types.SimResult` —
regardless of which mechanism produced it.

Built-ins:

* :class:`MemorySink`     — accumulates complete runs in memory (the default
  for tests and notebooks);
* :class:`JsonlSink`      — streams one JSON object per event to a file, the
  archival format for offline diffing at service scale;
* :class:`RingBufferSink` — keeps only the last ``capacity`` slots, the
  flight-recorder mode for long-running / high-traffic simulation where full
  traces would be unbounded;
* :class:`RotatingJsonlSink` — the durable service archive: buffered,
  written by a background thread, rotated across ``prefix-NNNNN.jsonl``
  files by size, and safe for concurrent producers (whole runs are
  enqueued atomically, so events from different workers never interleave).

:func:`feed_result` replays a finished :class:`SimResult` into any sink as
the normalized ``begin``/``emit``/``end`` stream — the one feeding path the
Simulator façade and the simulation service both use.
"""
from __future__ import annotations

import codecs
import itertools
import json
import os
import queue
import threading
from collections import deque
from typing import Any, IO, Mapping

import numpy as np

from .types import SimRequest, SimResult


class TraceSink:
    """Base class; all hooks are optional no-ops."""

    def begin(self, meta: Mapping[str, Any]) -> None:
        pass

    def emit(self, pc: int, mask: int) -> None:
        pass

    def end(self, result: SimResult) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "TraceSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MemorySink(TraceSink):
    """Collects ``(meta, trace, result)`` triples for every run."""

    def __init__(self) -> None:
        self.runs: list[dict[str, Any]] = []
        self._cur: dict[str, Any] | None = None

    def begin(self, meta: Mapping[str, Any]) -> None:
        self._cur = {"meta": dict(meta), "trace": [], "result": None}

    def emit(self, pc: int, mask: int) -> None:
        if self._cur is not None:
            self._cur["trace"].append((pc, mask))

    def end(self, result: SimResult) -> None:
        if self._cur is not None:
            self._cur["result"] = result
            self.runs.append(self._cur)
            self._cur = None

    @property
    def traces(self) -> list[list[tuple[int, int]]]:
        return [r["trace"] for r in self.runs]


# One encoder per archival event shape, shared by JsonlSink and
# RotatingJsonlSink so the two writers can never fork the format the
# offline diffing tools read.

def begin_event(meta: Mapping[str, Any]) -> dict[str, Any]:
    return {"event": "begin", **dict(meta)}


def issue_event(pc: int, mask: int) -> dict[str, Any]:
    return {"event": "issue", "pc": int(pc), "mask": int(mask)}


def end_event(result: SimResult) -> dict[str, Any]:
    return {"event": "end", "mechanism": result.mechanism,
            "status": result.status.value, "steps": result.steps,
            "fuel_left": result.fuel_left,
            "finished": int(result.finished),
            "utilization": result.utilization,
            "error": result.error}


def _sanitize(value: Any) -> Any:
    """Best-effort coercion to JSON-able types; raises TypeError otherwise."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    if isinstance(value, Mapping):
        return {str(k): _sanitize(v) for k, v in value.items()}
    raise TypeError(f"not JSON-serializable: {type(value).__name__}")


def replay_payload(req: SimRequest) -> dict[str, Any]:
    """JSON-able encoding of everything needed to re-run ``req``.

    This is the write half of the archive round trip:
    ``repro_torch.archive.ArchiveReader`` decodes it back into a
    :class:`~repro_torch.engine.types.SimRequest` (``request_from_meta``) so
    archived runs can be replayed offline under any registered mechanism.
    Request ``meta`` entries that cannot be serialized are dropped and
    listed under ``meta_dropped`` rather than failing the write path.  The
    ``device`` key, where the port ran the request, is not archived.
    """
    def arr(x: Any) -> Any:
        return None if x is None else np.asarray(x).tolist()

    meta: dict[str, Any] = {}
    dropped: list[str] = []
    for k, v in req.meta.items():
        if k == "device":
            continue
        try:
            meta[str(k)] = _sanitize(v)
        except TypeError:
            dropped.append(str(k))
    payload: dict[str, Any] = {
        "program": np.asarray(req.program).tolist(),
        "cfg": dict(req.cfg._asdict()),
        "init_regs": arr(req.init_regs),
        "init_mem": arr(req.init_mem),
        "lane_ids": arr(req.lane_ids),
        "active0": None if req.active0 is None else int(req.active0),
        "fuel": None if req.fuel is None else int(req.fuel),
        "record_trace": bool(req.record_trace),
        "majority_first": bool(req.majority_first),
        "bsync_skip_pcs": [int(p) for p in req.bsync_skip_pcs],
        "name": req.name,
        "meta": meta,
    }
    if dropped:
        payload["meta_dropped"] = sorted(dropped)
    return payload


def run_meta(mechanism: str, req: SimRequest) -> dict[str, Any]:
    """The canonical begin-event meta for one request.

    Human-readable identification (mechanism, program name, shape), the
    program's static CFG fingerprint (``cfg_fp`` — what ``python -m
    repro_torch.archive similar`` ranks on without replaying; see
    :mod:`repro_torch.analysis.fingerprint`), plus the ``replay`` payload that
    makes the archive round-trippable — the one meta builder the Simulator
    façade and the simulation service share.
    """
    from repro_torch.analysis.fingerprint import fingerprint_meta   # lazy; cached
    return {"mechanism": mechanism, "program": req.name,
            "n_threads": req.resolved_cfg().n_threads,
            "program_len": int(np.asarray(req.program).shape[0]),
            "cfg_fp": fingerprint_meta(req.program, req.resolved_cfg()),
            "replay": replay_payload(req)}


# Per-process SM-cell ids: every archived warp of one run_sm/submit_sm cell
# carries the same ``sm_cell`` so offline tooling can group the warps back
# into the cell they executed in.  itertools.count().__next__ is atomic
# under the GIL, so concurrent service workers never share an id.
_sm_cell_ids = itertools.count()


def next_sm_cell_id() -> int:
    """A process-unique id for one (SM, policy) cell's archived warps."""
    return next(_sm_cell_ids)


def timing_meta(sched: Any) -> dict[str, Any]:
    """JSON-able cycle/stall summary of a timed schedule.

    Accepts anything with the cycle-engine accounting fields (``SmResult``,
    ``CycleResult``, extended ``TimingResult``).  Archived alongside the
    replay payload so offline tooling can read the stall taxonomy and
    re-derive IPC (= ``thread_instructions / cycles``) without re-running
    the timing model — and cross-check it against a re-run when it does
    (:meth:`repro_torch.archive.Replayer.rederive_timing`).
    """
    return {"cycles": int(sched.cycles),
            "thread_instructions": int(sched.thread_instructions),
            "busy_cycles": int(getattr(sched, "busy_cycles", 0)),
            "issue_stall_cycles": int(getattr(sched, "issue_stall_cycles", 0)),
            "scoreboard_stall_cycles":
                int(getattr(sched, "scoreboard_stall_cycles", 0)),
            "memory_stall_cycles":
                int(getattr(sched, "memory_stall_cycles", 0))}


def sm_run_meta(inner: str, req: SimRequest, *, warp: int, n_warps: int,
                policy: str, cell: int,
                timing: "Mapping[str, Any] | None" = None) -> dict[str, Any]:
    """The canonical begin-event meta for one warp of an SM cell.

    The SM variant of :func:`run_meta`: the same replayable payload (the
    warp re-runs standalone under ``inner`` — warps are architecturally
    independent, so a standalone replay is bit-equal to its in-cell
    execution) plus the cell coordinates — ``sm_warp`` (index within the
    cell), ``sm_warps`` (cell width), ``sm_policy`` (issue scheduler) and
    ``sm_cell`` (grouping id) — so :class:`repro_torch.archive.Replayer` can
    reassemble per-cell and per-policy discrepancy breakdowns.  ``timing``
    (usually :func:`timing_meta` of the cell's schedule) lands under
    ``sm_timing`` so archives carry the cycle/stall breakdown.
    """
    meta = run_meta(inner, req)
    meta.update({"sm_warp": int(warp), "sm_warps": int(n_warps),
                 "sm_policy": str(policy), "sm_cell": int(cell)})
    if timing is not None:
        meta["sm_timing"] = dict(timing)
    return meta


class JsonlSink(TraceSink):
    """Streams events as JSON lines to ``path`` (or an open file object)."""

    def __init__(self, path_or_file: "str | IO[str]") -> None:
        if isinstance(path_or_file, str):
            self._fh: IO[str] = open(path_or_file, "w", encoding="utf-8")
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        # native UTF-8 (not \uXXXX escapes) — but only when the handle can
        # take it: a caller-supplied file opened with a legacy encoding
        # would raise UnicodeEncodeError mid-stream, so fall back to
        # ASCII-escaped output there
        enc = getattr(self._fh, "encoding", None)
        self._ensure_ascii = (enc is not None
                              and codecs.lookup(enc).name != "utf-8")
        self.events_written = 0

    def _write(self, obj: Mapping[str, Any]) -> None:
        self._fh.write(json.dumps(obj, separators=(",", ":"),
                                  ensure_ascii=self._ensure_ascii) + "\n")
        self.events_written += 1

    def begin(self, meta: Mapping[str, Any]) -> None:
        self._write(begin_event(meta))

    def emit(self, pc: int, mask: int) -> None:
        self._write(issue_event(pc, mask))

    def end(self, result: SimResult) -> None:
        self._write(end_event(result))
        self._fh.flush()

    def close(self) -> None:
        if self._owns and not self._fh.closed:
            self._fh.close()


def feed_result(sink: "TraceSink | None", result: SimResult,
                meta: Mapping[str, Any]) -> None:
    """Replay one finished result into ``sink`` as the normalized stream."""
    if sink is None:
        return
    sink.begin(meta)
    for pc, mask in result.trace:
        sink.emit(pc, mask)
    sink.end(result)


class RotatingJsonlSink(TraceSink):
    """Durable archival writer: buffered, background-flushed, size-rotated.

    Events for the current run are buffered in memory (per producer thread)
    and enqueued as one atomic chunk at ``end()``; a single writer thread
    drains the queue, appending to ``{directory}/{prefix}-NNNNN.jsonl`` and
    starting a new file once the current one would exceed ``max_bytes``
    (a single run larger than ``max_bytes`` still lands in one file — runs
    are never split across rotations).

    Because the unit of writing is a whole run, multiple service workers
    can drive one sink through the ordinary ``begin``/``emit``/``end``
    protocol without interleaving each other's events.  ``flush()`` blocks
    until every enqueued run is on disk; ``close()`` flushes and joins the
    writer.

    IO failures (disk full, directory removed) never wedge producers: the
    writer records the first exception in ``write_error``, then keeps
    draining and *dropping* chunks (counted in ``runs_dropped``) so
    ``end()``/``flush()`` stay non-blocking.  Callers that need durability
    guarantees check ``write_error`` after ``flush()``.

    Protocol violations degrade the same way — counted, never enqueued:
    an ``end()`` with no matching ``begin()`` on that thread is dropped
    (``runs_malformed``; the chunk would be unreadable by
    ``repro_torch.archive.ArchiveReader``), an ``emit()`` outside a run is
    dropped (``events_orphaned``), and a ``begin()`` over a stale buffer
    left by a producer that errored between ``begin`` and ``end`` discards
    the unfinished run (``runs_stale``) before starting the new one.

    ``max_bytes`` and ``bytes_written`` are measured in *encoded UTF-8
    bytes* (what actually lands on disk), not characters — non-ASCII
    request meta rotates at the same on-disk size as ASCII.
    """

    def __init__(self, directory: str, *, prefix: str = "traces",
                 max_bytes: int = 8 << 20, queue_size: int = 1024) -> None:
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.prefix = prefix
        self.max_bytes = int(max_bytes)
        self.paths: list[str] = []
        self.runs_written = 0
        self.runs_dropped = 0                 # chunks dropped after an error
        self.runs_malformed = 0               # end() with no matching begin()
        self.runs_stale = 0                   # begin() over an unfinished run
        self.events_orphaned = 0              # emit() outside begin()..end()
        self.bytes_written = 0                # encoded UTF-8 bytes on disk
        self.write_error: Exception | None = None   # first writer failure
        # protocol-violation counters are bumped from producer threads;
        # a bare += is a non-atomic read-modify-write and loses counts
        self._counter_lock = threading.Lock()
        self._local = threading.local()
        self._q: "queue.Queue[str | None]" = queue.Queue(maxsize=queue_size)
        self._fh: IO[str] | None = None
        self._cur_bytes = 0
        self._closed = False
        self._writer = threading.Thread(target=self._drain, daemon=True,
                                        name="rotating-jsonl-writer")
        self._writer.start()

    # -- producer side (per-thread run buffers) -----------------------------

    def _lines(self) -> list[str]:
        lines = getattr(self._local, "lines", None)
        if lines is None:
            lines = self._local.lines = []
        return lines

    def _append(self, obj: Mapping[str, Any]) -> None:
        if self._closed:
            raise RuntimeError("RotatingJsonlSink is closed")
        self._lines().append(json.dumps(obj, separators=(",", ":"),
                                        ensure_ascii=False) + "\n")

    def _active(self) -> bool:
        return getattr(self._local, "active", False)

    def begin(self, meta: Mapping[str, Any]) -> None:
        if self._active():
            with self._counter_lock:     # producer died between begin/end
                self.runs_stale += 1
        self._lines().clear()
        self._local.active = False
        self._append(begin_event(meta))
        self._local.active = True

    def emit(self, pc: int, mask: int) -> None:
        if not self._active():
            with self._counter_lock:
                self.events_orphaned += 1
            return
        self._append(issue_event(pc, mask))

    def end(self, result: SimResult) -> None:
        if not self._active():
            # no matching begin(): enqueuing would archive an unreadable
            # chunk — drop it and count instead
            with self._counter_lock:
                self.runs_malformed += 1
            self._lines().clear()
            return
        self._append(end_event(result))
        self._local.active = False
        lines = self._lines()
        self._q.put("".join(lines))
        lines.clear()

    # -- writer thread ------------------------------------------------------

    def _rotate(self) -> None:
        if self._fh is not None:
            self._fh.close()
        path = os.path.join(self.directory,
                            f"{self.prefix}-{len(self.paths):05d}.jsonl")
        self._fh = open(path, "w", encoding="utf-8")
        self._cur_bytes = 0
        self.paths.append(path)

    def _drain(self) -> None:
        while True:
            chunk = self._q.get()
            try:
                if chunk is None:
                    break
                if self.write_error is not None:
                    self.runs_dropped += 1       # degraded: ack + drop
                    continue
                # measure what hits the disk: encoded bytes, not characters
                # (len(chunk) undercounts non-ASCII meta and would let
                # files overshoot max_bytes)
                nbytes = len(chunk.encode("utf-8"))
                if (self._fh is None
                        or (self._cur_bytes > 0
                            and self._cur_bytes + nbytes
                            > self.max_bytes)):
                    self._rotate()
                self._fh.write(chunk)
                self._fh.flush()
                self._cur_bytes += nbytes
                self.bytes_written += nbytes
                self.runs_written += 1
            except Exception as exc:             # disk full, dir deleted, ...
                # the writer must keep draining and acking chunks: dying
                # here would wedge flush() in _q.join() and, once the queue
                # fills, block every producer inside end()
                self.write_error = exc
                self.runs_dropped += 1
            finally:
                self._q.task_done()
        try:
            if self._fh is not None:
                self._fh.close()
        except Exception as exc:
            self.write_error = self.write_error or exc
        self._fh = None

    # -- control ------------------------------------------------------------

    def flush(self) -> None:
        """Block until every enqueued run has been written to disk."""
        self._q.join()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._writer.join(timeout=30)


class RingBufferSink(TraceSink):
    """Flight recorder: keeps the last ``capacity`` issued slots only."""

    def __init__(self, capacity: int = 1024) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.buffer: deque[tuple[int, int]] = deque(maxlen=capacity)
        self.total_emitted = 0
        self.last_result: SimResult | None = None

    def emit(self, pc: int, mask: int) -> None:
        self.buffer.append((pc, mask))
        self.total_emitted += 1

    def end(self, result: SimResult) -> None:
        self.last_result = result

    def snapshot(self) -> list[tuple[int, int]]:
        return list(self.buffer)
