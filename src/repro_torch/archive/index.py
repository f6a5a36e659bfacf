"""Sidecar index + compaction for rotated JSONL trace archives.

Port of ``repro.archive.index`` (numpy only, copied; it imports nothing of
``repro``).

A multi-GB archive answers "give me run ``run-000123``" only by scanning
every rotated file from the start — O(archive) per lookup.  The sidecar
index is the O(1) path: one scan of the archive writes
``{directory}/{prefix}.index.jsonl`` mapping every intact run's id to its
exact byte span, and :meth:`repro_torch.archive.ArchiveReader.get` then seeks
straight to the run (read ``length`` bytes at ``offset``, decode with
:func:`~repro_torch.archive.reader.parse_run`) without touching the rest of the
archive.

Run ids are ordinal in archive order (``run-000000``, ``run-000001``, ...):
deterministic for a given archive content, so tooling can address runs
without a discovery step.  They are *archive coordinates* — rewriting the
archive (compaction) renumbers them, and the index is rebuilt alongside.

Sidecar format (JSONL): a header line

    {"kind": "repro-archive-index", "version": 2, "prefix": ...,
     "files": [[name, bytes], ...], "runs": N}

followed by one entry line per run (``id``, ``file``, ``offset``,
``length``, ``line``, ``mechanism``, ``program``, ``status``, ``fp`` —
the run's static CFG fingerprint, see
:mod:`repro_torch.analysis.fingerprint`; it is what ``python -m repro_torch.archive
similar`` ranks on without opening the archive files at all).  The
``files`` fingerprint — (name, size) of every rotated file at build time —
is how staleness is detected: a grown, rotated, or compacted archive no
longer matches, and :meth:`ArchiveIndex.ensure` (and ``ArchiveReader.get``)
transparently rebuild.  The sidecar is written atomically (tmp +
``os.replace``) so a concurrent reader never sees a torn index.

:func:`compact` is the repair pass: it rewrites each rotated file keeping
only the byte spans of intact runs — corrupt lines, interrupted runs, and
a crashed writer's truncated tail are dropped — and preserves those spans
*verbatim* (replay fidelity is bit-exact: the surviving runs' lines are
untouched).  Files left empty are removed; the index is rebuilt.  Compact
only a quiescent archive: a live writer appending mid-compaction would
race the rewrite.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Mapping

from .reader import ArchiveReader

__all__ = ["ArchiveIndex", "CompactReport", "IndexEntry", "compact",
           "index_path", "scan_archive"]

INDEX_KIND = "repro-archive-index"
# v2 added the per-run "fp" CFG fingerprint; older sidecars load as None
# and ensure() transparently rebuilds them with fingerprints filled in.
INDEX_VERSION = 2


def index_path(directory: str, prefix: str = "traces") -> str:
    """The sidecar's path: ``{directory}/{prefix}.index.jsonl``."""
    return os.path.join(directory, f"{prefix}.index.jsonl")


@dataclass(frozen=True)
class IndexEntry:
    """One intact run's coordinates + identification."""

    run_id: str
    file: str           # basename of the rotated file holding the run
    offset: int         # byte offset of the begin line within that file
    length: int         # bytes from begin through the end line (inclusive)
    line: int           # 1-based line number of the begin line
    mechanism: str      # begin-meta mechanism (what the run was served as)
    program: str
    status: str
    fp: tuple[float, ...] | None = None   # CFG fingerprint (None: unknown)

    def to_json(self) -> dict[str, Any]:
        out = {"id": self.run_id, "file": self.file, "offset": self.offset,
               "length": self.length, "line": self.line,
               "mechanism": self.mechanism, "program": self.program,
               "status": self.status}
        if self.fp is not None:
            out["fp"] = [round(float(x), 6) for x in self.fp]
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "IndexEntry":
        fp = obj.get("fp")
        return cls(run_id=str(obj["id"]), file=str(obj["file"]),
                   offset=int(obj["offset"]), length=int(obj["length"]),
                   line=int(obj["line"]),
                   mechanism=str(obj.get("mechanism") or ""),
                   program=str(obj.get("program") or ""),
                   status=str(obj.get("status") or ""),
                   fp=None if fp is None else tuple(float(x) for x in fp))


def _begin_fp(ev: Mapping[str, Any]) -> tuple[float, ...] | None:
    """The run's CFG fingerprint from its begin event, best effort.

    Prefers the stamped ``cfg_fp`` (current :data:`~repro_torch.analysis.
    fingerprint.FP_VERSION` only — a stamp from an older format is
    recomputed, never compared across versions); falls back to computing
    from the archived ``replay.program`` for pre-fingerprint archives.
    Never raises: a malformed stamp must not void an otherwise-intact run.
    """
    from repro_torch.analysis.fingerprint import FP_VERSION, fingerprint
    try:
        stamp = ev.get("cfg_fp")
        if isinstance(stamp, Mapping) and stamp.get("v") == FP_VERSION:
            return tuple(float(x) for x in stamp["f"])
    except (KeyError, TypeError, ValueError):
        pass
    try:
        program = (ev.get("replay") or {}).get("program")
        if program:
            import numpy as np
            return fingerprint(np.asarray(program, dtype=np.int32))
    except Exception:
        pass
    return None


def scan_archive(directory: str, prefix: str = "traces",
                 ) -> tuple[list[tuple[str, int]], list[IndexEntry]]:
    """One pass over the rotated files: byte-accurate run coordinates.

    Returns ``(files, entries)`` — ``files`` is the fingerprint
    (``(basename, size_bytes)`` per rotated file, in rotation order) and
    ``entries`` the intact runs with ordinal ids.  Intactness matches
    :class:`~repro_torch.archive.reader.ArchiveReader` exactly: a run survives
    only if its begin line, every issue line, and its end line all decode
    and nothing interleaves — corrupt lines, a begin over an unfinished
    run, and a partial tail line all void the run in progress, just as the
    reader drops it.
    """
    files: list[tuple[str, int]] = []
    entries: list[IndexEntry] = []
    ordinal = 0
    paths = ArchiveReader(directory, prefix=prefix).paths()
    for fi, path in enumerate(paths):
        last_file = fi == len(paths) - 1
        name = os.path.basename(path)
        files.append((name, os.path.getsize(path)))
        with open(path, "rb") as fh:
            offset = 0
            lineno = 0
            # (begin offset, begin lineno, mechanism, program, fp) of the
            # run in progress, or None outside a run
            cur: tuple[int, int, str, str,
                       tuple[float, ...] | None] | None = None
            for raw in fh:
                lineno += 1
                start = offset
                offset += len(raw)
                try:
                    # a missing trailing newline fingerprints a crashed
                    # writer only in the LAST file (the reader's rule: a
                    # complete-parse final line elsewhere is a normal event)
                    if last_file and not raw.endswith(b"\n"):
                        raise ValueError("partial tail line")
                    ev = json.loads(raw.decode("utf-8"))
                    kind = ev.get("event")
                    if kind == "begin":
                        cur = (start, lineno,
                               str(ev.get("mechanism") or ""),
                               str(ev.get("program") or ""),
                               _begin_fp(ev))
                        continue
                    if kind == "issue":
                        # same field validation the reader applies: an
                        # issue line whose pc/mask are missing or non-int
                        # is corruption and voids the run in progress
                        int(ev["pc"]), int(ev["mask"])
                        continue
                    if kind == "end":
                        # mirror the reader's end-event casts exactly
                        int(ev.get("steps") or 0)
                        int(ev.get("fuel_left", -1))
                        int(ev.get("finished") or 0)
                        float(ev.get("utilization") or 0.0)
                        if cur is not None:
                            entries.append(IndexEntry(
                                run_id=f"run-{ordinal:06d}", file=name,
                                offset=cur[0], length=offset - cur[0],
                                line=cur[1],
                                mechanism=cur[2] or str(ev.get("mechanism")
                                                        or ""),
                                program=cur[3],
                                status=str(ev.get("status") or ""),
                                fp=cur[4]))
                            ordinal += 1
                        cur = None
                        continue
                    raise ValueError(f"unknown event kind {kind!r}")
                except (ValueError, KeyError, TypeError,
                        UnicodeDecodeError):
                    cur = None                  # corruption voids the run
    return files, entries


@dataclass(frozen=True)
class ArchiveIndex:
    """A loaded (or freshly built) sidecar index for one archive."""

    directory: str
    prefix: str
    files: tuple[tuple[str, int], ...]      # fingerprint at build time
    entries: tuple[IndexEntry, ...]

    @property
    def path(self) -> str:
        return index_path(self.directory, self.prefix)

    def __len__(self) -> int:
        return len(self.entries)

    def run_ids(self) -> list[str]:
        return [e.run_id for e in self.entries]

    def lookup(self, run_id: str) -> IndexEntry:
        """The entry for ``run_id``; raises KeyError with the id range."""
        entry = self._by_id().get(run_id)
        if entry is None:
            span = (f"{self.entries[0].run_id} .. {self.entries[-1].run_id}"
                    if self.entries else "<empty archive>")
            raise KeyError(f"unknown run id {run_id!r}; indexed: {span}")
        return entry

    def _by_id(self) -> dict[str, IndexEntry]:
        cache = self.__dict__.get("_by_id_cache")
        if cache is None:
            cache = {e.run_id: e for e in self.entries}
            self.__dict__["_by_id_cache"] = cache
        return cache

    def rank_similar(self, query_fp, *, top: int | None = None,
                     ) -> list[tuple[str, float]]:
        """Archived runs ranked by ascending control-flow distance to
        ``query_fp`` (see :func:`repro_torch.analysis.fingerprint.distance`) —
        ``(run_id, distance)`` pairs, computed from the sidecar alone (no
        archive file is opened, nothing is replayed).  Entries without a
        fingerprint (undecodable pre-fingerprint begin meta) are skipped.
        A query taken from an indexed run ranks that run first at exactly
        0.0."""
        from repro_torch.analysis.fingerprint import rank
        return rank(query_fp, ((e.run_id, e.fp) for e in self.entries),
                    top=top)

    def fresh(self) -> bool:
        """Whether the fingerprint still matches the on-disk files."""
        try:
            current = [(os.path.basename(p), os.path.getsize(p))
                       for p in ArchiveReader(self.directory,
                                              prefix=self.prefix).paths()]
        except FileNotFoundError:
            return False
        return tuple(current) == self.files

    # -- build / load / ensure ----------------------------------------------

    @classmethod
    def build(cls, directory: str, prefix: str = "traces") -> "ArchiveIndex":
        """Scan the archive and (atomically) write the sidecar."""
        files, entries = scan_archive(directory, prefix)
        idx = cls(directory=directory, prefix=prefix, files=tuple(files),
                  entries=tuple(entries))
        header = {"kind": INDEX_KIND, "version": INDEX_VERSION,
                  "prefix": prefix, "files": [list(f) for f in files],
                  "runs": len(entries)}
        tmp = idx.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(header, separators=(",", ":")) + "\n")
            for e in entries:
                fh.write(json.dumps(e.to_json(), separators=(",", ":"))
                         + "\n")
        os.replace(tmp, idx.path)      # atomic: no torn sidecar
        return idx

    @classmethod
    def load(cls, directory: str,
             prefix: str = "traces") -> "ArchiveIndex | None":
        """The sidecar as written, or ``None`` if missing/undecodable
        (an undecodable sidecar is treated like a missing one — rebuilt,
        never fatal)."""
        path = index_path(directory, prefix)
        try:
            with open(path, encoding="utf-8") as fh:
                lines = fh.read().splitlines()
            header = json.loads(lines[0])
            if (header.get("kind") != INDEX_KIND
                    or header.get("version") != INDEX_VERSION):
                return None
            entries = tuple(IndexEntry.from_json(json.loads(ln))
                            for ln in lines[1:] if ln)
            files = tuple((str(n), int(b)) for n, b in header["files"])
        except (OSError, ValueError, KeyError, TypeError, IndexError):
            return None
        return cls(directory=directory, prefix=prefix, files=files,
                   entries=entries)

    @classmethod
    def ensure(cls, directory: str,
               prefix: str = "traces") -> "ArchiveIndex":
        """Load the sidecar, rebuilding when missing or stale
        (fingerprint mismatch: the archive grew, rotated, or compacted)."""
        idx = cls.load(directory, prefix)
        if idx is None or not idx.fresh():
            idx = cls.build(directory, prefix)
        return idx


@dataclass(frozen=True)
class CompactReport:
    """Accounting for one :func:`compact` pass."""

    runs_kept: int
    bytes_before: int
    bytes_after: int
    files_rewritten: tuple[str, ...]
    files_removed: tuple[str, ...]          # rewritten down to zero runs

    @property
    def bytes_dropped(self) -> int:
        return self.bytes_before - self.bytes_after

    def render(self) -> str:
        return (f"kept {self.runs_kept} run(s); dropped "
                f"{self.bytes_dropped} byte(s) of debris "
                f"({len(self.files_rewritten)} file(s) rewritten, "
                f"{len(self.files_removed)} removed)")


def compact(directory: str, prefix: str = "traces", *,
            reindex: bool = True) -> CompactReport:
    """Rewrite rotated files keeping only intact runs, byte-for-byte.

    Corrupt lines, interrupted runs, orphan events, and a crashed writer's
    truncated tail are dropped; every surviving run's lines are copied
    *verbatim* (same bytes → bit-identical replay).  Already-clean files
    are left untouched; files with no surviving runs are removed (rotation
    numbering may gain gaps — the reader orders by index, not contiguity).
    Rebuilds the sidecar index afterwards unless ``reindex=False``.

    Only compact a quiescent archive: a live writer appending to the last
    file would race the rewrite.
    """
    files, entries = scan_archive(directory, prefix)
    by_file: dict[str, list[IndexEntry]] = {}
    for e in entries:
        by_file.setdefault(e.file, []).append(e)
    bytes_before = sum(size for _, size in files)
    bytes_after = 0
    rewritten: list[str] = []
    removed: list[str] = []
    for name, size in files:
        keep = by_file.get(name, [])
        kept_bytes = sum(e.length for e in keep)
        path = os.path.join(directory, name)
        if kept_bytes == size:                  # nothing to drop
            bytes_after += size
            continue
        if not keep:
            os.remove(path)
            removed.append(name)
            continue
        with open(path, "rb") as fh:
            data = fh.read()
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            for e in keep:
                fh.write(data[e.offset:e.offset + e.length])
        os.replace(tmp, path)
        rewritten.append(name)
        bytes_after += kept_bytes
    if reindex:
        ArchiveIndex.build(directory, prefix)
    return CompactReport(runs_kept=len(entries), bytes_before=bytes_before,
                         bytes_after=bytes_after,
                         files_rewritten=tuple(rewritten),
                         files_removed=tuple(removed))
