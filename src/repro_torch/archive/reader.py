"""Reading rotated JSONL trace archives back into structured runs.

Port of ``repro.archive.reader`` (numpy only, copied; it imports nothing of
``repro``).

The write path (:class:`repro_torch.engine.sinks.RotatingJsonlSink`, fed through
:func:`repro_torch.engine.sinks.run_meta`) appends whole runs — ``begin`` /
``issue``* / ``end`` event lines — to ``{directory}/{prefix}-NNNNN.jsonl``
files, rotating by size.  :class:`ArchiveReader` is the read half: it walks
the rotated files in order and reassembles every run into an
:class:`ArchivedRun` — the ``(pc, mask)`` control-flow trace, the begin-event
meta (JSON lists normalized back to tuples), and the end-event summary.

Degradation is *reported, never raised*: a archive whose writer crashed or
degraded mid-stream (truncated tail line, file ending inside a run, orphan
events from pre-fix writers) yields every intact run and accounts for the
rest in :class:`ReadReport` — ``reader.report`` after an iteration.  A
fleet-scale replay job must not die on the one shard whose node was lost.

Runs archived through :func:`~repro_torch.engine.sinks.run_meta` carry a
``replay`` payload in their begin event; :func:`request_from_meta` decodes
it back into a :class:`~repro_torch.engine.types.SimRequest` so the run can be
re-executed (see :mod:`repro_torch.archive.replay`).  Runs archived with
hand-built meta (e.g. per-warp SM-cell archives) read back fine but are not
replayable — ``ArchivedRun.replayable`` distinguishes the two.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Any, Iterator, Mapping

import numpy as np

from repro_torch.core.isa import MachineConfig
from repro_torch.engine.types import SimRequest

__all__ = ["ArchivedRun", "ArchiveReader", "ReadReport", "parse_run",
           "request_from_meta"]


def _tuplize(value: Any) -> Any:
    """JSON round-trip normalization: lists back to tuples, recursively."""
    if isinstance(value, list):
        return tuple(_tuplize(v) for v in value)
    if isinstance(value, dict):
        return {k: _tuplize(v) for k, v in value.items()}
    return value


def request_from_meta(meta: Mapping[str, Any]) -> SimRequest | None:
    """Decode a begin-event meta's ``replay`` payload into a SimRequest.

    Returns ``None`` when the run is not replayable — no payload (hand-built
    meta, e.g. SM-cell warp archives), a payload this reader cannot decode,
    or a payload whose writer had to drop request-meta entries
    (``meta_dropped``): replaying without those mechanism options could
    silently execute differently from the archived run, so such runs are
    counted as unreplayable rather than diffed unfaithfully.  Unknown
    ``cfg`` fields from a newer writer are ignored.
    """
    payload = meta.get("replay")
    if not isinstance(payload, Mapping):
        return None
    if payload.get("meta_dropped"):
        return None

    def arr(x: Any) -> Any:
        return None if x is None else np.asarray(x, dtype=np.int32)

    try:
        cfg = MachineConfig(**{k: int(v) for k, v in payload["cfg"].items()
                               if k in MachineConfig._fields})
        req_meta = payload.get("meta") or {}
        return SimRequest(
            program=np.asarray(payload["program"], dtype=np.int32),
            cfg=cfg,
            init_regs=arr(payload.get("init_regs")),
            init_mem=arr(payload.get("init_mem")),
            lane_ids=arr(payload.get("lane_ids")),
            active0=(None if payload.get("active0") is None
                     else int(payload["active0"])),
            fuel=(None if payload.get("fuel") is None
                  else int(payload["fuel"])),
            record_trace=bool(payload.get("record_trace", True)),
            majority_first=bool(payload.get("majority_first", True)),
            bsync_skip_pcs=tuple(int(p) for p in
                                 (payload.get("bsync_skip_pcs") or ())),
            name=str(payload.get("name") or ""),
            meta={str(k): _tuplize(v) for k, v in req_meta.items()})
    except (KeyError, TypeError, ValueError):
        return None


@dataclass(frozen=True)
class ArchivedRun:
    """One reassembled ``begin`` → ``issue``* → ``end`` run.

    ``meta`` is the begin-event payload (minus the ``event`` tag) with JSON
    lists normalized back to tuples; the remaining fields mirror the end
    event.  ``path``/``line`` locate the begin event for diagnostics.
    """

    meta: Mapping[str, Any]
    trace: tuple[tuple[int, int], ...]
    mechanism: str
    status: str
    steps: int
    fuel_left: int
    finished: int
    utilization: float
    error: str | None
    path: str
    line: int

    @property
    def program(self) -> str:
        return str(self.meta.get("program") or "")

    @property
    def replayable(self) -> bool:
        return isinstance(self.meta.get("replay"), Mapping)

    @property
    def traced(self) -> bool:
        """Whether the archived run recorded its control-flow trace (an
        untraced run replays to an equally empty trace — nothing to diff)."""
        payload = self.meta.get("replay")
        if isinstance(payload, Mapping):
            return bool(payload.get("record_trace", True))
        return bool(self.trace) or self.steps == 0

    def request(self) -> SimRequest | None:
        """The re-runnable request, or ``None`` if not replayable."""
        return request_from_meta(self.meta)

    @property
    def sm_cell(self) -> int | None:
        """The (SM, policy) cell this warp belonged to, if any (stamped by
        :func:`repro_torch.engine.sinks.sm_run_meta` on archived SM-cell warps)."""
        cell = self.meta.get("sm_cell")
        return None if cell is None else int(cell)


def parse_run(lines: "list[str] | tuple[str, ...]", *, path: str = "",
              begin_line: int = 0) -> ArchivedRun:
    """Reassemble one contiguous, well-formed ``begin``/``issue``*/``end``
    event-line sequence into an :class:`ArchivedRun`.

    This is the random-access counterpart of :meth:`ArchiveReader.__iter__`
    — :meth:`ArchiveReader.get` reads exactly one indexed run's bytes and
    decodes them here.  Unlike iteration, damage is *raised* (ValueError):
    a malformed indexed span means the sidecar index is stale, and the
    caller should rebuild it rather than silently skip.
    """
    events = []
    for line in lines:
        line = line.strip()
        if line:
            events.append(json.loads(line))
    if (not events or events[0].get("event") != "begin"
            or events[-1].get("event") != "end"):
        raise ValueError("not a whole begin..end run")
    meta_ev = dict(events[0])
    meta_ev.pop("event", None)
    trace = []
    for ev in events[1:-1]:
        if ev.get("event") != "issue":
            raise ValueError(f"unexpected {ev.get('event')!r} event "
                             f"inside a run")
        trace.append((int(ev["pc"]), int(ev["mask"])))
    end = events[-1]
    return ArchivedRun(
        meta=_tuplize(meta_ev), trace=tuple(trace),
        mechanism=str(end.get("mechanism") or ""),
        status=str(end.get("status") or ""),
        steps=int(end.get("steps") or 0),
        fuel_left=int(end.get("fuel_left", -1)),
        finished=int(end.get("finished") or 0),
        utilization=float(end.get("utilization") or 0.0),
        error=end.get("error"),
        path=path, line=begin_line)


@dataclass
class ReadReport:
    """Accounting for one archive iteration (``ArchiveReader.report``).

    ``clean`` archives have every counter at zero: nothing truncated,
    interrupted, orphaned, or corrupt.  A crashed writer leaves exactly a
    ``truncated_tail`` (the partial final line / unfinished final run of
    the last file); anything else indicates a damaged or pre-fix archive.

    ``complete`` records whether the iteration that produced this report
    *walked the whole archive*: a partial walk (``runs(limit=N)``, or any
    caller that breaks out of iteration early) leaves the unscanned tail
    unvalidated, so its counters — and ``clean`` — speak only for the
    prefix that was read.  Integrity gates must require ``complete``
    (``python -m repro_torch.archive --expect-zero`` refuses a ``--limit`` walk).
    """

    files: tuple[str, ...] = ()
    runs: int = 0                    # intact runs yielded
    events: int = 0                  # well-formed event lines seen
    truncated_tail: str | None = None   # last file ends mid-line / mid-run
    truncated_runs: int = 0          # runs lost to the truncated tail
    interrupted_runs: int = 0        # begin without end, *not* at the tail
    orphan_events: int = 0           # issue/end outside a run
    corrupt_lines: int = 0           # undecodable lines not at the tail
    complete: bool = False           # the walk reached the archive's end

    @property
    def clean(self) -> bool:
        return (self.truncated_tail is None and self.truncated_runs == 0
                and self.interrupted_runs == 0 and self.orphan_events == 0
                and self.corrupt_lines == 0)


class ArchiveReader:
    """Iterates whole runs across the rotated files of one archive.

    >>> reader = ArchiveReader("sim-archive")
    >>> runs = reader.runs()
    >>> reader.report.clean, reader.report.runs
    (True, 128)

    Iteration is streaming (one file's lines in memory at a time) and
    re-entrant: each ``__iter__`` resets ``report`` and re-walks the
    directory, so a reader can watch a live, still-growing archive.
    """

    def __init__(self, directory: str, *, prefix: str = "traces") -> None:
        if not os.path.isdir(directory):
            raise FileNotFoundError(f"archive directory {directory!r} "
                                    f"does not exist")
        self.directory = directory
        self.prefix = prefix
        self.report = ReadReport(files=tuple(self.paths()))
        self._index = None          # cached sidecar index (see get())

    def paths(self) -> list[str]:
        """The archive's files, ordered by rotation index."""
        pat = re.compile(rf"^{re.escape(self.prefix)}-(\d+)\.jsonl$")
        found = []
        for fn in os.listdir(self.directory):
            m = pat.match(fn)
            if m:
                found.append((int(m.group(1)),
                              os.path.join(self.directory, fn)))
        return [p for _, p in sorted(found)]

    def runs(self, limit: int | None = None) -> list[ArchivedRun]:
        """The archive's runs, in order (at most ``limit`` of them).

        A limited walk stops mid-iteration, so the resulting ``report``
        has ``complete == False``: the unscanned tail was never validated
        and the damage counters speak only for the prefix read.
        """
        out = []
        for run in self:
            out.append(run)
            if limit is not None and len(out) >= limit:
                break
        return out

    def get(self, run_id: str) -> ArchivedRun:
        """Fetch one run by id through the sidecar index — O(1), no scan.

        The index (``{prefix}.index.jsonl``, see :mod:`repro_torch.archive.index`)
        is loaded on first use and automatically rebuilt when its
        fingerprint no longer matches the on-disk files (new runs appended,
        archive compacted).  Raises ``KeyError`` for an unknown id.
        """
        from .index import ArchiveIndex       # local: index imports reader
        idx = self._index
        if idx is None or not idx.fresh():
            idx = ArchiveIndex.ensure(self.directory, prefix=self.prefix)
            self._index = idx
        entry = idx.lookup(run_id)
        path = os.path.join(self.directory, entry.file)
        with open(path, "rb") as fh:
            fh.seek(entry.offset)
            data = fh.read(entry.length)
        try:
            return parse_run(data.decode("utf-8").splitlines(), path=path,
                             begin_line=entry.line)
        except (ValueError, KeyError, TypeError) as exc:
            # the fingerprint matched but the span no longer parses: the
            # file was mutated in place (same size).  Distinct from an
            # unknown id — surface it as corruption, not a lookup miss
            raise ValueError(
                f"indexed span for {run_id!r} at {entry.file}:"
                f"{entry.offset} no longer parses ({exc}); the archive "
                f"was modified in place — rebuild the index") from exc

    def __iter__(self) -> Iterator[ArchivedRun]:
        paths = self.paths()
        report = ReadReport(files=tuple(paths))
        self.report = report
        for fi, path in enumerate(paths):
            last_file = fi == len(paths) - 1
            with open(path, encoding="utf-8") as fh:
                raw = fh.read()
            # a well-formed file ends with a newline; a missing one means
            # the writer (or its node) died mid-line
            complete_tail = raw == "" or raw.endswith("\n")
            lines = raw.split("\n")
            if lines and lines[-1] == "":
                lines.pop()
            meta: Mapping[str, Any] | None = None
            trace: list[tuple[int, int]] = []
            begin_line = 0
            for li, line in enumerate(lines, start=1):
                at_tail = last_file and li == len(lines)
                try:
                    if at_tail and not complete_tail:
                        raise ValueError("partial tail line")
                    ev = json.loads(line)
                    kind = ev.get("event")
                    if kind == "begin":
                        if meta is not None:
                            report.interrupted_runs += 1
                        ev.pop("event", None)
                        meta = _tuplize(ev)
                        trace = []
                        begin_line = li
                        report.events += 1
                        continue
                    if kind == "issue":
                        report.events += 1
                        if meta is None:
                            report.orphan_events += 1
                            continue
                        trace.append((int(ev["pc"]), int(ev["mask"])))
                        continue
                    if kind == "end":
                        report.events += 1
                        if meta is None:
                            report.orphan_events += 1
                            continue
                        run = ArchivedRun(
                            meta=meta, trace=tuple(trace),
                            mechanism=str(ev.get("mechanism") or ""),
                            status=str(ev.get("status") or ""),
                            steps=int(ev.get("steps") or 0),
                            fuel_left=int(ev.get("fuel_left", -1)),
                            finished=int(ev.get("finished") or 0),
                            utilization=float(ev.get("utilization") or 0.0),
                            error=ev.get("error"),
                            path=path, line=begin_line)
                        meta = None
                        trace = []
                        report.runs += 1
                        yield run
                        continue
                    raise ValueError(f"unknown event kind {kind!r}")
                except (ValueError, KeyError, TypeError):
                    # undecodable or semantically broken line.  Only a
                    # *partial* tail line fingerprints a crashed writer;
                    # a newline-terminated line that fails to parse is
                    # data corruption wherever it sits
                    if at_tail and not complete_tail:
                        report.truncated_tail = path
                        if meta is not None:
                            report.truncated_runs += 1
                            meta = None
                    else:
                        report.corrupt_lines += 1
                        if meta is not None:   # the run it belonged to is gone
                            report.interrupted_runs += 1
                            meta = None
            if meta is not None:               # file ended inside a run
                if last_file:
                    report.truncated_tail = report.truncated_tail or path
                    report.truncated_runs += 1
                else:
                    report.interrupted_runs += 1
        # only a walk that reaches this point validated the whole archive;
        # a consumer that breaks early (runs(limit=N)) leaves it False
        report.complete = True
