"""CLI: replay, index, compact, and query RotatingJsonlSink archives.

Port of ``repro.archive.__main__`` (numpy only, copied; it imports nothing of
``repro``).

Usage::

    python -m repro_torch.archive DIR                    # self-replay integrity
    python -m repro_torch.archive DIR --mechanism hanoi_torch  # offline Fig 9
    python -m repro_torch.archive DIR --expect-zero      # CI gate: bit-equal
    python -m repro_torch.archive DIR --watch --watch-idle-s 5  # tail + replay
    python -m repro_torch.archive DIR --device cpu       # replay on the CPU

    python -m repro_torch.archive index DIR              # (re)build the sidecar
    python -m repro_torch.archive get DIR run-000042     # O(1) indexed lookup
    python -m repro_torch.archive get DIR run-000042 --json  # run as JSON
    python -m repro_torch.archive compact DIR            # drop debris, reindex
    python -m repro_torch.archive similar DIR --to run-000042  # CF neighbors
    python -m repro_torch.archive similar DIR --to prog.asm --top 5

Replays run on the card unless ``--device cpu`` is given, where
``hanoi_torch`` runs its plain twin.  ``--watch`` tails a growing archive
and replays new runs as they are appended, as the reference's ``serve
--mode replay --watch`` does (in the port: ``python -m
repro_torch.launch.serve --mode replay --archive-dir DIR --watch``).

``--expect-zero`` exits non-zero unless at least one run replayed and every
replayed run came back with exactly 0.0 discrepancy — the self-replay
integrity gate CI runs against a freshly written archive.  It refuses to
gate a *partial* walk (``--limit``): an unscanned tail could hide
truncation or corruption the walked prefix never sees.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.engine import Simulator

from .index import ArchiveIndex, compact
from .reader import ArchiveReader
from .replay import Replayer

_SUBCOMMANDS = ("index", "compact", "get", "similar")


def _main_replay(argv: "list[str]") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.archive",
        description="Replay a rotated JSONL trace archive and report "
                    "control-flow discrepancy (the paper's Fig 9, offline). "
                    "Subcommands: index DIR / get DIR RUN_ID / compact DIR.")
    ap.add_argument("directory", help="archive directory "
                                      "(RotatingJsonlSink output)")
    ap.add_argument("--prefix", default="traces",
                    help="archive file prefix (default: traces)")
    ap.add_argument("--mechanism", default="",
                    help="replay mechanism override (default: replay each "
                         "run under its archived mechanism)")
    ap.add_argument("--limit", type=int, default=0,
                    help="replay at most N runs (0 = all; a limited walk "
                         "cannot be gated with --expect-zero)")
    ap.add_argument("--expect-zero", action="store_true",
                    help="exit 1 unless >=1 run replayed, every run has "
                         "exactly 0.0 discrepancy, and the whole archive "
                         "was walked (self-replay gate)")
    ap.add_argument("--device", default=None,
                    help="torch device the replays run on (default: the "
                         "GPU; 'cpu' runs hanoi_torch's plain twin)")
    ap.add_argument("--watch", action="store_true",
                    help="streaming mode: tail a growing archive and "
                         "replay newly appended runs incrementally (with "
                         "--limit, stop after N runs)")
    ap.add_argument("--watch-poll-ms", type=float, default=250.0,
                    help="--watch poll interval (ms)")
    ap.add_argument("--watch-idle-s", type=float, default=0.0,
                    help="exit --watch after this long with no new runs "
                         "(0 = watch until --limit/interrupt)")
    ap.add_argument("--rederive-timing", action="store_true",
                    help="also re-derive cycle-level IPC + stall breakdown "
                         "for archived SM cells from their traces and "
                         "cross-check the stamped sm_timing meta")
    args = ap.parse_args(argv)

    reader = ArchiveReader(args.directory, prefix=args.prefix)
    replayer = Replayer(args.mechanism or None,
                        simulator=Simulator(device=args.device))
    if args.watch:
        def progress(rolling, n_new):
            print(f"[watch] +{n_new} run(s) -> {rolling.replayed} replayed; "
                  f"rolling {rolling.overall().render()}", flush=True)
        report = replayer.watch(
            reader, poll_s=args.watch_poll_ms / 1000.0,
            idle_timeout_s=args.watch_idle_s or None,
            max_runs=args.limit or None, progress=progress)
    else:
        report = replayer.replay(reader, limit=args.limit or None)
    print(report.render())

    if args.rederive_timing:
        cells = replayer.rederive_timing(reader, limit=args.limit or None)
        if not cells:
            print("[timing] no SM cells in archive")
        for td in cells:
            t = td.result
            stamp = ("stamp=match" if td.matches_archive else
                     "stamp=MISMATCH" if td.archived is not None else
                     "stamp=absent")
            print(f"[timing] cell{td.cell} ({td.policy}, "
                  f"{td.n_warps} warps): ipc={t.ipc:.3f} "
                  f"cycles={t.cycles} stalls(i/s/m)="
                  f"{t.issue_stall_cycles}/{t.scoreboard_stall_cycles}/"
                  f"{t.memory_stall_cycles} {stamp}")

    if args.expect_zero:
        if report.read is not None and not report.read.complete:
            print("[archive] expect-zero FAILED: partial walk (--limit) "
                  "left the archive tail unvalidated; drop --limit to "
                  "gate integrity", file=sys.stderr)
            return 1
        bad = [r for r in report.rows if r.discrepancy != 0.0]
        if not report.rows:
            print("[archive] expect-zero FAILED: no runs replayed",
                  file=sys.stderr)
            return 1
        if bad:
            worst = max(bad, key=lambda r: r.discrepancy)
            print(f"[archive] expect-zero FAILED: {len(bad)} run(s) with "
                  f"non-zero discrepancy (worst: {worst.program} "
                  f"{worst.discrepancy_pct:.2f}%)", file=sys.stderr)
            return 1
    return 0


def _main_index(argv: "list[str]") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.archive index",
        description="(Re)build the sidecar index: one scan writes "
                    "{prefix}.index.jsonl mapping run id -> byte span "
                    "for O(1) `get` lookups.")
    ap.add_argument("directory")
    ap.add_argument("--prefix", default="traces")
    args = ap.parse_args(argv)
    idx = ArchiveIndex.build(args.directory, args.prefix)
    print(f"[index] {len(idx)} run(s) across {len(idx.files)} file(s) "
          f"-> {idx.path}")
    if idx.entries:
        print(f"[index] ids {idx.entries[0].run_id} .. "
              f"{idx.entries[-1].run_id}")
    return 0


def _main_get(argv: "list[str]") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.archive get",
        description="Fetch one archived run by id through the sidecar "
                    "index (built/rebuilt on demand) — no archive scan.")
    ap.add_argument("directory")
    ap.add_argument("run_id", help="e.g. run-000042 (see `index`)")
    ap.add_argument("--prefix", default="traces")
    ap.add_argument("--json", action="store_true",
                    help="print the full run (meta + trace + end fields) "
                         "as one JSON object")
    args = ap.parse_args(argv)
    reader = ArchiveReader(args.directory, prefix=args.prefix)
    try:
        run = reader.get(args.run_id)
    except (KeyError, ValueError) as exc:        # unknown id / stale span
        print(f"[get] {exc.args[0]}", file=sys.stderr)
        return 1
    if args.json:
        def listify(v):
            if isinstance(v, tuple):
                return [listify(x) for x in v]
            if isinstance(v, dict):
                return {k: listify(x) for k, x in v.items()}
            return v
        print(json.dumps({
            "id": args.run_id, "file": run.path, "line": run.line,
            "meta": listify(dict(run.meta)),
            "trace": [[pc, mask] for pc, mask in run.trace],
            "mechanism": run.mechanism, "status": run.status,
            "steps": run.steps, "fuel_left": run.fuel_left,
            "finished": run.finished, "utilization": run.utilization,
            "error": run.error}))
    else:
        cell = "" if run.sm_cell is None else (
            f" sm_cell={run.sm_cell} sm_warp={run.meta.get('sm_warp')} "
            f"sm_policy={run.meta.get('sm_policy')}")
        print(f"[get] {args.run_id}: program={run.program or '<anonymous>'} "
              f"mechanism={run.meta.get('mechanism') or run.mechanism} "
              f"status={run.status} steps={run.steps} "
              f"trace={len(run.trace)} slot(s) "
              f"replayable={run.replayable}{cell}")
    return 0


def _main_compact(argv: "list[str]") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.archive compact",
        description="Rewrite rotated files dropping corrupt/interrupted "
                    "debris (intact runs are preserved byte-for-byte) and "
                    "rebuild the sidecar index.  Only compact an archive "
                    "with no live writer.")
    ap.add_argument("directory")
    ap.add_argument("--prefix", default="traces")
    args = ap.parse_args(argv)
    report = compact(args.directory, args.prefix)
    print(f"[compact] {report.render()}")
    return 0


def _main_similar(argv: "list[str]") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.archive similar",
        description="Rank archived runs by static control-flow similarity "
                    "to a query — a run id or a .asm file — using the CFG "
                    "fingerprints in the sidecar index (built/rebuilt on "
                    "demand).  Nothing is replayed and no archive file is "
                    "opened: the ranking reads the sidecar alone.")
    ap.add_argument("directory")
    ap.add_argument("--to", required=True, metavar="RUN_ID|FILE.asm",
                    help="query: an indexed run id (e.g. run-000042) or a "
                         "path to a SASS-lite .asm file")
    ap.add_argument("--top", type=int, default=10,
                    help="show the N nearest runs (default 10; 0 = all)")
    ap.add_argument("--prefix", default="traces")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the ranking as one JSON object")
    args = ap.parse_args(argv)

    idx = ArchiveIndex.ensure(args.directory, args.prefix)
    if args.to.endswith(".asm"):
        from repro_torch.analysis import fingerprint
        from repro_torch.core.asm import AsmError, assemble
        try:
            query_fp = fingerprint(assemble(open(args.to).read()))
        except OSError as exc:
            print(f"[similar] cannot read {args.to}: {exc}", file=sys.stderr)
            return 1
        except AsmError as exc:
            print(f"[similar] {args.to}: assembly failed\n{exc}",
                  file=sys.stderr)
            return 1
    else:
        try:
            entry = idx.lookup(args.to)
        except KeyError as exc:
            print(f"[similar] {exc.args[0]}", file=sys.stderr)
            return 1
        if entry.fp is None:
            print(f"[similar] {args.to} has no fingerprint (undecodable "
                  f"begin meta); re-archive or query by .asm file",
                  file=sys.stderr)
            return 1
        query_fp = entry.fp

    ranked = idx.rank_similar(query_fp, top=args.top or None)
    if args.as_json:
        print(json.dumps({"query": args.to,
                          "ranked": [{"id": rid, "distance": round(d, 6)}
                                     for rid, d in ranked]}))
        return 0
    if not ranked:
        print("[similar] no fingerprinted runs in the index")
        return 0
    print(f"[similar] {len(idx)} indexed run(s); "
          f"{len(ranked)} nearest to {args.to}:")
    by_id = {e.run_id: e for e in idx.entries}
    for rank_i, (rid, d) in enumerate(ranked, start=1):
        e = by_id[rid]
        print(f"  {rank_i:3d}. {rid}  d={d:.4f}  "
              f"program={e.program or '<anonymous>'} "
              f"mechanism={e.mechanism} status={e.status}")
    return 0


def main(argv: "list[str] | None" = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _SUBCOMMANDS:
        return {"index": _main_index, "get": _main_get,
                "compact": _main_compact,
                "similar": _main_similar}[argv[0]](argv[1:])
    return _main_replay(argv)


if __name__ == "__main__":
    raise SystemExit(main())
