"""Incremental byte-offset tailing of a live, rotating JSONL archive.

Port of ``repro.archive.tail`` (numpy only, copied; it imports nothing of
``repro``).

:meth:`repro_torch.archive.Replayer.watch` used to re-walk the *whole* archive
directory on every poll — O(archive) work per tick, unbounded as the fleet
appends.  :class:`ArchiveTailer` keeps a per-file byte offset (advanced
only through the last complete line) and per-file partial-run buffers, so
a poll costs exactly the newly appended bytes: an unchanged file is
``stat``-ed and skipped without even being opened, and a poll over an
unchanged archive reads zero bytes (:class:`TailStats` proves it — a
regression test pins this).

Why per-file buffers are safe: the write path
(:class:`repro_torch.engine.sinks.RotatingJsonlSink`) rotates only at run
boundaries — runs never span files — so a ``begin`` whose ``end`` has not
arrived yet always completes in the *same* file, and a file that is no
longer the newest can be finalized (its dangling tail force-parsed, its
unfinished run counted as interrupted) without ever touching it again.

The tailer re-walks from scratch only on the events that invalidate
offsets: a tracked file shrank, disappeared, or the rotation order
changed under us (compaction).  Already-emitted runs are not re-emitted
across a rescan.

Damage accounting matches :class:`~repro_torch.archive.reader.ArchiveReader`
semantics, with one tailing-specific refinement: an unterminated tail
line (or unfinished tail run) of the *newest* file is not damage — it is
a run the writer has not finished flushing, and it stays buffered until
the next poll.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

from .reader import ArchivedRun, ReadReport, _tuplize

__all__ = ["ArchiveTailer", "TailStats"]


@dataclass
class TailStats:
    """I/O accounting across polls (the no-re-read regression surface)."""

    polls: int = 0
    files_opened: int = 0        # open() calls — unchanged files do none
    bytes_read: int = 0          # appended bytes consumed (plus partial-
    runs: int = 0                # tail re-reads, which are O(one line))
    full_rescans: int = 0


@dataclass
class _FileState:
    offset: int = 0              # bytes consumed through last complete line
    line_no: int = 0             # 1-based line counter at ``offset``
    meta: "Mapping[str, Any] | None" = None    # open run's begin meta
    trace: list = field(default_factory=list)
    begin_line: int = 0
    finalized: bool = False      # rotated-away file, fully drained


class ArchiveTailer:
    """Stateful incremental reader over one rotating archive directory.

    ``poll()`` returns the runs appended since the previous poll (in
    archive order).  ``report`` is a :class:`ReadReport`-shaped snapshot of
    everything consumed so far, suitable for the rolling watch display.
    """

    def __init__(self, directory: str, *, prefix: str = "traces") -> None:
        if not os.path.isdir(directory):
            raise FileNotFoundError(f"archive directory {directory!r} "
                                    f"does not exist")
        self.directory = directory
        self.prefix = prefix
        self.stats = TailStats()
        self._files: dict[str, _FileState] = {}
        self._order: list[str] = []
        self._emitted = 0
        self._events = 0
        self._interrupted = 0
        self._orphans = 0
        self._corrupt = 0

    # -- directory listing --------------------------------------------------

    def _paths(self) -> list[str]:
        import re
        pat = re.compile(rf"^{re.escape(self.prefix)}-(\d+)\.jsonl$")
        found = []
        for fn in os.listdir(self.directory):
            m = pat.match(fn)
            if m:
                found.append((int(m.group(1)),
                              os.path.join(self.directory, fn)))
        return [p for _, p in sorted(found)]

    # -- event machine (one file's stream) ----------------------------------

    def _feed_line(self, st: _FileState, line: str,
                   path: str) -> "ArchivedRun | None":
        st.line_no += 1
        self_events_before = self._events
        try:
            ev = json.loads(line)
            kind = ev.get("event")
            if kind == "begin":
                if st.meta is not None:
                    self._interrupted += 1
                ev.pop("event", None)
                st.meta = _tuplize(ev)
                st.trace = []
                st.begin_line = st.line_no
                self._events += 1
                return None
            if kind == "issue":
                self._events += 1
                if st.meta is None:
                    self._orphans += 1
                    return None
                st.trace.append((int(ev["pc"]), int(ev["mask"])))
                return None
            if kind == "end":
                self._events += 1
                if st.meta is None:
                    self._orphans += 1
                    return None
                run = ArchivedRun(
                    meta=st.meta, trace=tuple(st.trace),
                    mechanism=str(ev.get("mechanism") or ""),
                    status=str(ev.get("status") or ""),
                    steps=int(ev.get("steps") or 0),
                    fuel_left=int(ev.get("fuel_left", -1)),
                    finished=int(ev.get("finished") or 0),
                    utilization=float(ev.get("utilization") or 0.0),
                    error=ev.get("error"),
                    path=path, line=st.begin_line)
                st.meta = None
                st.trace = []
                return run
            raise ValueError(f"unknown event kind {kind!r}")
        except (ValueError, KeyError, TypeError):
            self._events = self_events_before
            self._corrupt += 1
            if st.meta is not None:      # the run it belonged to is gone
                self._interrupted += 1
                st.meta = None
            return None

    # -- polling ------------------------------------------------------------

    def _needs_rescan(self, paths: list[str]) -> bool:
        if self._order and paths[:len(self._order)] != self._order:
            return True                  # rotation order changed / removal
        for path, st in self._files.items():
            try:
                if os.stat(path).st_size < st.offset:
                    return True          # file shrank (compaction/rewrite)
            except OSError:
                return True              # file disappeared
        return False

    def _drain_file(self, path: str, st: _FileState,
                    is_last: bool) -> list[ArchivedRun]:
        """Consume bytes appended to ``path`` past ``st.offset``."""
        size = os.stat(path).st_size
        out: list[ArchivedRun] = []
        if size > st.offset:
            with open(path, "rb") as fh:
                fh.seek(st.offset)
                chunk = fh.read(size - st.offset)
            self.stats.files_opened += 1
            self.stats.bytes_read += len(chunk)
            cut = chunk.rfind(b"\n") + 1        # consume whole lines only
            consumed, leftover = chunk[:cut], chunk[cut:]
            if not is_last and leftover:
                # the writer rotated away: this dangling final line will
                # never get its newline — finalize it (the reader yields
                # such a line when it parses; see test_index_scan_*)
                consumed, leftover = chunk, b""
            for line in consumed.decode("utf-8").split("\n"):
                if not line:
                    continue
                run = self._feed_line(st, line, path)
                if run is not None:
                    out.append(run)
            st.offset += len(consumed)
        if not is_last and not st.finalized and st.offset >= size:
            # fully drained a rotated-away file: a still-open run in it
            # will never end — account it as interrupted, then stop
            # tracking content (the offset check above still guards it)
            if st.meta is not None:
                self._interrupted += 1
                st.meta = None
            st.finalized = True
        return out

    def poll(self) -> list[ArchivedRun]:
        """Runs appended since the last poll, in archive order."""
        self.stats.polls += 1
        paths = self._paths()
        if self._needs_rescan(paths):
            return self._rescan(paths)
        out: list[ArchivedRun] = []
        for path in paths:
            st = self._files.get(path)
            if st is None:
                st = self._files[path] = _FileState()
            if st.finalized:
                continue
            out.extend(self._drain_file(path, st, is_last=path == paths[-1]))
        self._order = paths
        self._emitted += len(out)
        self.stats.runs += len(out)
        return out

    def _rescan(self, paths: list[str]) -> list[ArchivedRun]:
        """Full re-walk after compaction/rewrite; already-emitted runs (by
        archive position) are not re-emitted."""
        self.stats.full_rescans += 1
        already = self._emitted
        self._files = {}
        self._order = []
        self._events = self._interrupted = self._orphans = self._corrupt = 0
        runs: list[ArchivedRun] = []
        for path in paths:
            st = self._files[path] = _FileState()
            runs.extend(self._drain_file(path, st, is_last=path == paths[-1]))
        self._order = paths
        new = runs[already:]
        self._emitted = len(runs[:already]) + len(new)
        self.stats.runs += len(new)
        return new

    # -- reporting ----------------------------------------------------------

    @property
    def pending(self) -> bool:
        """Whether any file holds a buffered, not-yet-complete run (or an
        unterminated tail line the writer has not finished flushing)."""
        for path, st in self._files.items():
            if st.meta is not None:
                return True
            try:
                if not st.finalized and os.stat(path).st_size > st.offset:
                    return True
            except OSError:
                return True
        return False

    @property
    def report(self) -> ReadReport:
        """Snapshot of everything consumed so far, reader-shaped.

        ``complete`` is True when the tailer has drained every known file
        through its current end with no run left buffered — the watch
        analogue of "the walk reached the archive's end".
        """
        return ReadReport(
            files=tuple(self._order), runs=self.stats.runs,
            events=self._events, truncated_tail=None, truncated_runs=0,
            interrupted_runs=self._interrupted,
            orphan_events=self._orphans, corrupt_lines=self._corrupt,
            complete=not self.pending)
