"""Replaying archived runs and diffing them — the paper's Fig 9 offline.

Port of ``repro.archive.replay`` (it imports nothing of ``repro``).  The
replays run on the port's :class:`~repro_torch.engine.Simulator`, the card
unless it was built with ``device="cpu"``: ``Replayer()`` self-replays a
``hanoi_torch`` archive through kernel K1.  An archived request's
``device`` key, which the port's sinks never write, is dropped before the
replay, so where a replay runs is decided by the Replayer's Simulator
alone, or by the running simulation service it is given (``service=``).

The live evaluation (`Simulator.compare`) runs two mechanisms side by side
and reports the normalized Levenshtein discrepancy between their
control-flow traces.  The :class:`Replayer` produces the *same numbers from
the durable archive*: each archived run's request is reconstructed
(:func:`~repro_torch.archive.reader.request_from_meta`), re-executed under a
registered mechanism, and the replayed trace is diffed against the archived
one with the archived trace in the hardware-reference role — so

* ``Replayer()`` (no override) is the **integrity check**: every mechanism
  is deterministic, so self-replay must be bit-equal (0.0 discrepancy);
* ``Replayer("some_mechanism")`` is **Fig 9 at archive scale**: diff a fleet
  of archived reference traces against any mechanism without re-running the
  reference — e.g. archive ``turing_oracle`` (the hardware proxy) once,
  then replay under ``hanoi`` to reproduce the paper's headline metric.

Replay executes through :meth:`repro_torch.engine.Simulator.run_batch`
(grouped per mechanism, so signature-homogeneous ``hanoi_torch`` groups take
the native batch runner: one launch of K1 a group) or, when a running
:class:`~repro_torch.service.SimulationService` is supplied, through its
queue — the fleet path.  The Levenshtein
itself is the bit-parallel Myers implementation in
:mod:`repro_torch.core.trace`, which is what makes million-warp archives
tractable.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping

import numpy as np

# the one nearest-rank percentile the service latency stats also use
from repro_torch.core.trace import levenshtein, nearest_rank, trace_tokens
from repro_torch.engine.registry import get_mechanism
from repro_torch.engine.simulator import Simulator

from .reader import ArchivedRun, ArchiveReader, ReadReport
from .tail import ArchiveTailer

__all__ = ["Aggregate", "Replayer", "ReplayReport", "ReplayRow",
           "TimingRederivation", "nearest_rank"]


@dataclass(frozen=True)
class TimingRederivation:
    """One archived SM cell's IPC, re-derived offline from its warp traces.

    ``result`` is the re-run of the cycle engine over the archived traces
    and replay-payload programs under the archived ``sm_policy``;
    ``archived`` is the ``sm_timing`` summary stamped at execution time
    (``None`` for pre-timing archives).  When the same timing config is
    used, ``matches_archive`` cross-checks the stamp bit-for-bit — the
    archive-integrity analogue of the replay discrepancy being 0.0.
    """

    cell: int
    policy: str
    n_warps: int
    result: Any                       # extended TimingResult
    archived: "Mapping[str, Any] | None" = None

    @property
    def ipc(self) -> float:
        return self.result.ipc

    @property
    def matches_archive(self) -> bool:
        if self.archived is None:
            return False
        return (int(self.archived.get("cycles", -1)) == self.result.cycles
                and int(self.archived.get("thread_instructions", -1))
                == self.result.thread_instructions)


@dataclass(frozen=True)
class ReplayRow:
    """One archived run diffed against its replay."""

    index: int                   # ordinal of the run in the archive
    program: str
    archived_mechanism: str
    replay_mechanism: str
    edit_distance: int
    discrepancy: float           # edit_distance / len(archived trace)
    archived_trace_len: int
    replayed_trace_len: int
    archived_status: str
    replayed_status: str
    # SM-cell coordinates (sm_run_meta archives); None for single-warp runs
    sm_cell: int | None = None
    sm_warp: int | None = None
    sm_policy: str | None = None

    @property
    def discrepancy_pct(self) -> float:
        return 100.0 * self.discrepancy

    @property
    def pair(self) -> str:
        """Breakdown key: replayed mechanism vs the archived reference."""
        return f"{self.replay_mechanism} vs {self.archived_mechanism}"

    @property
    def cell_key(self) -> str | None:
        """Breakdown key grouping this warp back into its SM cell."""
        if self.sm_cell is None:
            return None
        return f"cell{self.sm_cell} ({self.sm_policy or '?'})"


@dataclass(frozen=True)
class Aggregate:
    """Count / mean / nearest-rank percentiles over one slice of rows."""

    count: int
    mean: float
    p50: float
    p90: float
    p99: float
    max: float

    @classmethod
    def of(cls, values: Iterable[float]) -> "Aggregate":
        vals = sorted(float(v) for v in values)
        if not vals:
            nan = float("nan")
            return cls(0, nan, nan, nan, nan, nan)
        return cls(len(vals), float(np.mean(vals)),
                   nearest_rank(vals, 0.50), nearest_rank(vals, 0.90),
                   nearest_rank(vals, 0.99), vals[-1])

    def render(self) -> str:
        return (f"n={self.count} mean={100 * self.mean:.2f}% "
                f"p50={100 * self.p50:.2f}% p90={100 * self.p90:.2f}% "
                f"p99={100 * self.p99:.2f}% max={100 * self.max:.2f}%")


@dataclass(frozen=True)
class ReplayReport:
    """Fleet-scale discrepancy report over one archive replay.

    ``rows`` hold every replayed run in archive order; the aggregates are
    the paper's Fig 9 summary statistics over whatever slice you ask for.
    ``skipped_unreplayable`` counts runs with no (or undecodable) replay
    payload — e.g. per-warp SM-cell archives; ``skipped_untraced`` counts
    runs archived with ``record_trace=False`` (their replay would diff one
    empty trace against another); ``skipped_unknown_mechanism`` counts
    runs whose archived mechanism is not registered in this process (a
    plugin archive replayed without the plugin — the rest of the fleet
    still replays).  ``read`` is the reader's accounting for the iteration
    that produced the rows (``None`` when the replayer was handed pre-read
    runs instead of an archive).
    """

    rows: tuple[ReplayRow, ...]
    skipped_unreplayable: int
    skipped_untraced: int
    skipped_unknown_mechanism: int = 0
    read: ReadReport | None = None

    @property
    def replayed(self) -> int:
        return len(self.rows)

    def overall(self) -> Aggregate:
        return Aggregate.of(r.discrepancy for r in self.rows)

    def mean_discrepancy(self) -> float:
        return self.overall().mean

    def _slices(self, key) -> dict[str, Aggregate]:
        groups: dict[str, list[float]] = {}
        for r in self.rows:
            groups.setdefault(key(r), []).append(r.discrepancy)
        return {k: Aggregate.of(v) for k, v in sorted(groups.items())}

    def by_mechanism(self) -> dict[str, Aggregate]:
        """Per (replay vs archived) mechanism pair."""
        return self._slices(lambda r: r.pair)

    def by_program(self) -> dict[str, Aggregate]:
        return self._slices(lambda r: r.program or "<anonymous>")

    def _sm_rows(self) -> list[ReplayRow]:
        return [r for r in self.rows if r.sm_cell is not None]

    def by_sm_cell(self) -> dict[str, Aggregate]:
        """Archived SM-cell warps grouped back into their cells (empty for
        archives with no SM-cell runs)."""
        groups: dict[str, list[float]] = {}
        for r in self._sm_rows():
            groups.setdefault(r.cell_key, []).append(r.discrepancy)
        return {k: Aggregate.of(v) for k, v in sorted(groups.items())}

    def by_sm_policy(self) -> dict[str, Aggregate]:
        """Per SM warp-scheduler policy, over the SM-cell warps only."""
        groups: dict[str, list[float]] = {}
        for r in self._sm_rows():
            groups.setdefault(r.sm_policy or "?", []).append(r.discrepancy)
        return {k: Aggregate.of(v) for k, v in sorted(groups.items())}

    def render(self) -> str:
        """Human-readable report (the CLI surface prints exactly this)."""
        out = []
        if self.read is not None:
            rd = self.read
            health = ("clean" if rd.clean else
                      f"truncated_tail={bool(rd.truncated_tail)} "
                      f"truncated={rd.truncated_runs} "
                      f"interrupted={rd.interrupted_runs} "
                      f"orphans={rd.orphan_events} "
                      f"corrupt={rd.corrupt_lines}")
            if not rd.complete:
                health += ", partial walk"
            out.append(f"[archive] {len(rd.files)} file(s), {rd.runs} "
                       f"run(s) read ({health})")
        skips = (f"skipped: {self.skipped_unreplayable} unreplayable, "
                 f"{self.skipped_untraced} untraced")
        if self.skipped_unknown_mechanism:
            skips += (f", {self.skipped_unknown_mechanism} "
                      f"unknown-mechanism")
        out.append(f"[replay] {self.replayed} run(s) replayed ({skips})")
        if self.rows:
            out.append(f"[replay] overall: {self.overall().render()}")
            by_pair = self.by_mechanism()
            if by_pair:
                out.append("[replay] by mechanism pair:")
                width = max(len(k) for k in by_pair)
                for k, agg in by_pair.items():
                    out.append(f"    {k:<{width}}  {agg.render()}")
            by_prog = self.by_program()
            if len(by_prog) > 1:
                out.append("[replay] by program:")
                width = max(len(k) for k in by_prog)
                for k, agg in by_prog.items():
                    out.append(f"    {k:<{width}}  {agg.render()}")
            by_cell = self.by_sm_cell()
            if by_cell:
                out.append("[replay] by SM cell:")
                width = max(len(k) for k in by_cell)
                for k, agg in by_cell.items():
                    out.append(f"    {k:<{width}}  {agg.render()}")
                by_pol = self.by_sm_policy()
                if by_pol:
                    out.append("[replay] by SM policy:")
                    width = max(len(k) for k in by_pol)
                    for k, agg in by_pol.items():
                        out.append(f"    {k:<{width}}  {agg.render()}")
        return "\n".join(out)


class Replayer:
    """Re-executes archived runs and diffs replayed vs archived traces.

    Parameters
    ----------
    mechanism:
        ``None`` replays each run under its *archived* mechanism (the
        self-replay integrity check — deterministic mechanisms must come
        back bit-equal).  A registry name replays every run under that
        mechanism instead: the offline Fig 9, with the archive as the
        reference side of the diff.
    simulator:
        The :class:`~repro_torch.engine.Simulator` used for batch replay
        (a default one, on the card, is built when omitted; pass
        ``Simulator(device="cpu")`` to replay on the CPU).  Replay requests
        are grouped per mechanism, so homogeneous ``hanoi_torch`` groups
        take one launch of K1 each.
    service:
        A *running* :class:`~repro_torch.service.SimulationService` to
        replay through instead of the simulator — the queue-fed fleet
        path, on the service's device.
    """

    def __init__(self, mechanism: str | None = None, *,
                 simulator: Simulator | None = None,
                 service: Any = None) -> None:
        self._override = (get_mechanism(mechanism).name
                          if mechanism else None)
        self._sim = simulator or Simulator()
        self._service = service

    def replay(self, source: "str | ArchiveReader | Iterable[ArchivedRun]",
               *, limit: int | None = None) -> ReplayReport:
        """Replay ``source`` (a directory, reader, or pre-read runs)."""
        reader: ArchiveReader | None = None
        if isinstance(source, str):
            reader = ArchiveReader(source)
        elif isinstance(source, ArchiveReader):
            reader = source
        runs = (reader.runs(limit) if reader is not None
                else list(source)[:limit] if limit is not None
                else list(source))

        skipped_unreplayable = skipped_untraced = skipped_unknown = 0
        by_mech: dict[str, list[tuple[int, ArchivedRun, Any]]] = {}
        for idx, run in enumerate(runs):
            req = run.request()
            if req is None:
                skipped_unreplayable += 1
                continue
            if "device" in req.meta:      # the Replayer's Simulator decides
                req = dataclasses.replace(req, meta={
                    k: v for k, v in req.meta.items() if k != "device"})
            if not run.traced:
                skipped_untraced += 1
                continue
            # the begin meta records what the run was *served* under; the
            # end event's mechanism is whatever the runner returned (a
            # delegating plugin reports its inner engine there)
            mech = self._override or \
                str(run.meta.get("mechanism") or "") or run.mechanism
            try:
                mech = get_mechanism(mech).name
            except KeyError:
                # a plugin archive replayed in a process without the
                # plugin: skip this run, keep the fleet going
                skipped_unknown += 1
                continue
            by_mech.setdefault(mech, []).append((idx, run, req))

        rows: list[ReplayRow] = []
        for mech, items in by_mech.items():
            reqs = [req for _, _, req in items]
            if self._service is not None:
                tickets = [self._service.submit(r, mechanism=mech)
                           for r in reqs]
                self._service.flush()
                results = [t.result() for t in tickets]
            else:
                results = self._sim.run_batch(reqs, mechanism=mech)
            for (idx, run, req), res in zip(items, results):
                archived = trace_tokens(list(run.trace))
                replayed = trace_tokens(list(res.trace))
                dist = int(levenshtein(replayed, archived))
                sm_warp = run.meta.get("sm_warp")
                rows.append(ReplayRow(
                    index=idx, program=run.program or req.name,
                    archived_mechanism=run.mechanism,
                    replay_mechanism=mech,
                    edit_distance=dist,
                    discrepancy=dist / max(1, len(archived)),
                    archived_trace_len=len(archived),
                    replayed_trace_len=len(replayed),
                    archived_status=run.status,
                    replayed_status=res.status.value,
                    sm_cell=run.sm_cell,
                    sm_warp=None if sm_warp is None else int(sm_warp),
                    sm_policy=(None if run.sm_cell is None
                               else str(run.meta.get("sm_policy") or ""))))
        rows.sort(key=lambda r: r.index)
        return ReplayReport(rows=tuple(rows),
                            skipped_unreplayable=skipped_unreplayable,
                            skipped_untraced=skipped_untraced,
                            skipped_unknown_mechanism=skipped_unknown,
                            read=reader.report if reader is not None
                            else None)

    def rederive_timing(self, source:
                        "str | ArchiveReader | Iterable[ArchivedRun]", *,
                        timing_cfg: Any = None,
                        limit: int | None = None
                        ) -> list[TimingRederivation]:
        """Re-derive cycle-level SM timing from the archive, offline.

        Archived SM-cell warps (stamped by
        :func:`repro_torch.engine.sinks.sm_run_meta`) carry everything the cycle
        engine needs: per-warp traces, replay-payload programs, and the
        cell's issue policy.  This regroups each cell's warps and re-runs
        :func:`repro_torch.engine.mechanisms.sm.interleave_cycle` over them —
        IPC and the full stall taxonomy without re-executing any warp.

        ``timing_cfg`` (a :class:`~repro_torch.core.timing.TimingConfig` or
        :class:`~repro_torch.timing.CycleConfig`) defaults to the live path's
        default, in which case each rederivation's ``matches_archive``
        cross-checks the ``sm_timing`` stamp written at execution time.
        Passing a different config is the offline what-if: re-price an
        archived fleet under new latency assumptions.  Cells with
        unreplayable warps are skipped.
        """
        from repro_torch.core.timing import TimingConfig
        from repro_torch.engine.mechanisms.sm import interleave_cycle
        if isinstance(source, str):
            source = ArchiveReader(source)
        runs = (source.runs(limit) if isinstance(source, ArchiveReader)
                else list(source)[:limit] if limit is not None
                else list(source))
        cells: dict[int, list[ArchivedRun]] = {}
        for run in runs:
            if run.sm_cell is not None:
                cells.setdefault(run.sm_cell, []).append(run)
        cfg = timing_cfg if timing_cfg is not None else TimingConfig()
        out: list[TimingRederivation] = []
        for cell, warps in sorted(cells.items()):
            warps.sort(key=lambda r: int(r.meta.get("sm_warp", 0)))
            traces, programs = [], []
            for r in warps:
                req = r.request()
                if req is None:
                    break
                traces.append(list(r.trace))
                programs.append(req.program)
            else:
                policy = str(warps[0].meta.get("sm_policy")
                             or "greedy_then_oldest")
                sched = interleave_cycle(traces, programs, policy, cfg)
                archived = warps[0].meta.get("sm_timing")
                out.append(TimingRederivation(
                    cell=cell, policy=policy, n_warps=len(warps),
                    result=sched.to_timing_result(),
                    archived=(dict(archived)
                              if isinstance(archived, Mapping) else None)))
        return out

    def watch(self, source: "str | ArchiveReader", *,
              poll_s: float = 0.25,
              idle_timeout_s: float | None = None,
              max_runs: int | None = None,
              progress: "Callable[[ReplayReport, int], None] | None" = None,
              ) -> ReplayReport:
        """Tail a growing archive, replaying runs as they are appended.

        Polls ``source`` every ``poll_s`` seconds through an incremental
        :class:`~repro_torch.archive.tail.ArchiveTailer` — per-file byte offsets
        carried between polls, so a tick costs only the newly appended
        bytes (an unchanged archive is not even re-opened; a full re-walk
        happens only when a file shrinks/disappears or the rotation order
        changes).  Replays only the runs not yet seen, and calls
        ``progress(report, n_new)`` with the *rolling cumulative*
        :class:`ReplayReport` after each batch of new runs — the live
        Fig 9 aggregate of everything replayed so far.

        Returns the final report when ``max_runs`` archived runs have been
        processed (replayed or skipped), or when no new runs have appeared
        for ``idle_timeout_s`` seconds.  With neither bound the watch runs
        until interrupted.  Truncated-tail debris at the end of the live
        file is tolerated per poll exactly as in a one-shot read — a run
        the writer has not finished flushing is simply not yielded yet.
        """
        if isinstance(source, ArchiveReader):
            tailer = ArchiveTailer(source.directory, prefix=source.prefix)
        else:
            tailer = ArchiveTailer(source)
        rows: list[ReplayRow] = []
        skipped = {"unreplayable": 0, "untraced": 0, "unknown": 0}
        seen = 0
        last_new = time.monotonic()

        def rolling() -> ReplayReport:
            return ReplayReport(
                rows=tuple(rows),
                skipped_unreplayable=skipped["unreplayable"],
                skipped_untraced=skipped["untraced"],
                skipped_unknown_mechanism=skipped["unknown"],
                read=tailer.report)

        while True:
            new = tailer.poll()
            if max_runs is not None:
                new = new[:max(0, max_runs - seen)]
            if new:
                part = self.replay(new)
                rows.extend(dataclasses.replace(r, index=r.index + seen)
                            for r in part.rows)
                skipped["unreplayable"] += part.skipped_unreplayable
                skipped["untraced"] += part.skipped_untraced
                skipped["unknown"] += part.skipped_unknown_mechanism
                seen += len(new)
                last_new = time.monotonic()
                if progress is not None:
                    progress(rolling(), len(new))
            if max_runs is not None and seen >= max_runs:
                break
            if (idle_timeout_s is not None
                    and time.monotonic() - last_new >= idle_timeout_s):
                break
            time.sleep(poll_s)
        return rolling()
