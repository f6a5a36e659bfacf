"""repro_torch.archive — offline reading, replay, and indexing of trace archives.

Port of ``repro.archive`` (numpy only, copied; it imports nothing of
``repro``).

The simulation service writes every completed warp to rotated JSONL files
through :class:`~repro_torch.engine.sinks.RotatingJsonlSink`; this package is the
matching read path, closing the write-path/read-path asymmetry:

* :class:`ArchiveReader` — iterates whole runs across the rotated
  ``{prefix}-NNNNN.jsonl`` files, reassembling ``begin``/``issue``/``end``
  events into ``(pc, mask)`` traces plus request meta, tolerating (and
  accounting for, via :class:`ReadReport`) a truncated tail from a crashed
  or degraded writer; :meth:`ArchiveReader.get` fetches one run by id in
  O(1) through the sidecar index;
* :class:`ArchiveIndex` / :func:`compact` (:mod:`repro_torch.archive.index`) —
  the sidecar ``{prefix}.index.jsonl`` mapping run id → byte span
  (rebuilt automatically on fingerprint mismatch) and the compaction pass
  that rewrites rotated files dropping corrupt/interrupted debris while
  preserving intact runs byte-for-byte; each entry also carries the run's
  static CFG fingerprint (:mod:`repro_torch.analysis.fingerprint`), so
  :meth:`ArchiveIndex.rank_similar` — CLI ``python -m repro_torch.archive
  similar DIR --to <run_id|file.asm>`` — ranks archived runs by
  control-flow similarity from the sidecar alone, replaying nothing;
* :class:`Replayer` — reconstructs each run's
  :class:`~repro_torch.engine.types.SimRequest`, re-executes it under any
  registered mechanism (batched through ``Simulator.run_batch`` or a
  running ``SimulationService``), and emits a :class:`ReplayReport` of
  per-run Levenshtein discrepancies with aggregate / per-mechanism /
  per-program / per-SM-cell / per-policy breakdowns — the paper's Fig 9
  at archive scale.  :meth:`Replayer.watch` tails a still-growing archive
  and replays new runs incrementally with a rolling aggregate.

SM-cell warps archived through the service (or ``Simulator.run_sm`` with a
sink) carry the full replay payload plus their cell coordinates
(``sm_cell``/``sm_warp``/``sm_warps``/``sm_policy``) — they replay exactly
like single-warp runs and group back into cells in the report.

Quick start::

    from repro_torch.archive import ArchiveReader, Replayer

    report = Replayer().replay("sim-archive")        # self-replay: 0.0
    assert report.mean_discrepancy() == 0.0

    fig9 = Replayer("hanoi").replay("oracle-archive")  # offline Fig 9
    print(fig9.render())

    run = ArchiveReader("sim-archive").get("run-000042")  # O(1), indexed

CLI: ``python -m repro_torch.archive DIR [--mechanism NAME] [--expect-zero]
[--watch] [--device cpu]`` or ``python -m repro_torch.archive
index|get|compact|similar DIR ...``.
"""
from .index import ArchiveIndex, CompactReport, IndexEntry, compact
from .reader import (ArchivedRun, ArchiveReader, ReadReport, parse_run,
                     request_from_meta)
from .replay import (Aggregate, Replayer, ReplayReport, ReplayRow,
                     TimingRederivation, nearest_rank)
from .tail import ArchiveTailer, TailStats

__all__ = [
    "Aggregate", "ArchiveIndex", "ArchiveReader", "ArchiveTailer",
    "ArchivedRun", "CompactReport", "IndexEntry", "ReadReport", "Replayer",
    "ReplayReport", "ReplayRow", "TailStats", "TimingRederivation",
    "compact", "nearest_rank", "parse_run", "request_from_meta",
]
