"""Archive-path benchmarks: Levenshtein, write/read/replay, indexed lookup.

Three sections:

* **levenshtein** — the Myers bit-parallel edit distance
  (``repro_torch.core.trace.levenshtein``) against the classic DP
  (``levenshtein_dp``) on token streams shaped like real control-flow
  traces (long runs of matching prefix with scattered divergence, plus a
  worst-case random pair).  The acceptance gate asserts a >=5x
  speedup at trace length >= 2k — this is what makes offline Fig 9 diffing
  tractable over millions of archived warps.
* **archive** — end-to-end throughput of the durable path: write runs
  through ``RotatingJsonlSink``, read them back with ``ArchiveReader``,
  self-replay with ``Replayer`` (asserting 0.0 discrepancy), reporting
  runs/s per stage.
* **index** — ``ArchiveReader.get(run_id)`` through the sidecar index
  versus locating the same run by scanning.  The acceptance gate
  asserts the indexed lookup is >=10x faster than the full scan on a
  1k-run archive — i.e. ``get`` really seeks instead of scanning.

Port of the repo's ``benchmarks/bench_archive.py`` over
:mod:`repro_torch.archive`, with its gates unchanged.  The archived runs
are ``hanoi_torch``'s and replay under it on ``--device``: the card by
default (one launch of kernel K1 a replay batch), its plain twin with
``--device cpu``.

Run:   PYTHONPATH=src python -m repro_torch.benchmarks.bench_archive
CI:    PYTHONPATH=src python -m repro_torch.benchmarks.bench_archive \
           --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.archive import ArchiveIndex, ArchiveReader, Replayer
from repro_torch.core import MachineConfig
from repro_torch.core.programs import make_suite
from repro_torch.core.trace import levenshtein, levenshtein_dp
from repro_torch.engine import (RotatingJsonlSink, Simulator, as_request,
                                feed_result, run_meta)

GATE_LEN = 2048          # acceptance: >=5x speedup at traces >= 2k tokens
GATE_SPEEDUP = 5.0
INDEX_GATE_RUNS = 1000   # acceptance: >=10x indexed get vs full scan at 1k
INDEX_GATE_SPEEDUP = 10.0


def _trace_like_pair(rng: np.random.Generator, n: int,
                     mutate: float) -> tuple[np.ndarray, np.ndarray]:
    """Two token streams with trace statistics: mostly-shared content with
    ``mutate`` fraction of substitutions/indels (a mechanism pair diverges
    locally, not uniformly)."""
    base = rng.integers(0, 200, size=n).astype(np.int64)
    other = base.copy()
    n_mut = max(1, int(mutate * n))
    idx = rng.choice(n, size=n_mut, replace=False)
    other[idx] = rng.integers(200, 400, size=n_mut)
    drop = rng.choice(n, size=n_mut // 2, replace=False)
    other = np.delete(other, drop)
    return base, other


def bench_levenshtein(lengths: tuple[int, ...], *, repeats: int = 3) -> None:
    rng = np.random.default_rng(0)
    print("== levenshtein: Myers bit-parallel vs DP ==")
    print(f"{'len':>6} {'kind':>8} {'dist':>7} {'myers_s':>9} "
          f"{'dp_s':>9} {'speedup':>8}")
    gate_ok = []
    for n in lengths:
        for kind, (a, b) in (
                ("trace", _trace_like_pair(rng, n, mutate=0.05)),
                ("random", (rng.integers(0, 1000, n).astype(np.int64),
                            rng.integers(0, 1000, n).astype(np.int64)))):
            t_my = _timed(levenshtein, a, b, repeats=repeats)
            t_dp = _timed(levenshtein_dp, a, b, repeats=1)
            d_my, d_dp = levenshtein(a, b), levenshtein_dp(a, b)
            assert d_my == d_dp, (n, kind, d_my, d_dp)
            speedup = t_dp / max(t_my, 1e-9)
            print(f"{n:>6} {kind:>8} {d_my:>7} {t_my:>9.4f} "
                  f"{t_dp:>9.4f} {speedup:>7.1f}x")
            if n >= GATE_LEN:
                gate_ok.append(speedup)
    assert gate_ok and min(gate_ok) >= GATE_SPEEDUP, (
        f"acceptance gate: Myers must be >={GATE_SPEEDUP}x the DP at "
        f"length >={GATE_LEN}; measured {gate_ok}")
    print(f"gate OK: >= {GATE_SPEEDUP}x at length >= {GATE_LEN} "
          f"(worst {min(gate_ok):.1f}x)")


def _timed(fn, *args, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_archive(n_runs: int, *, device: "str | None" = None) -> None:
    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    suite = make_suite(cfg, datasets=1)
    sim = Simulator(device=device)
    # pre-run once per program; archival replays results into the sink, so
    # the write benchmark measures the sink, not the interpreter
    results = list(zip(suite, sim.run_batch(suite, cfg)))
    print(f"\n== archive: write -> read -> self-replay "
          f"({n_runs} runs over {len(results)} programs) ==")
    with tempfile.TemporaryDirectory() as tmp:
        sink = RotatingJsonlSink(tmp, max_bytes=1 << 20)
        t0 = time.perf_counter()
        for i in range(n_runs):
            bench, res = results[i % len(results)]
            feed_result(sink, res,
                        run_meta("hanoi_torch", as_request(bench, cfg)))
        sink.flush()
        t_write = time.perf_counter() - t0
        sink.close()

        reader = ArchiveReader(tmp)
        t0 = time.perf_counter()
        runs = reader.runs()
        t_read = time.perf_counter() - t0
        assert len(runs) == n_runs and reader.report.clean

        t0 = time.perf_counter()
        report = Replayer(simulator=sim).replay(runs)
        t_replay = time.perf_counter() - t0
        assert report.replayed == n_runs
        assert report.mean_discrepancy() == 0.0

        print(f"{'stage':>8} {'runs/s':>10} {'wall_s':>9}")
        for stage, dt in (("write", t_write), ("read", t_read),
                          ("replay", t_replay)):
            print(f"{stage:>8} {n_runs / max(dt, 1e-9):>10.0f} {dt:>9.3f}")
        print(f"archive files: {len(sink.paths)}, "
              f"{sink.bytes_written / 1e6:.2f} MB, "
              f"self-replay discrepancy: "
              f"{report.mean_discrepancy():.4f}")


def bench_index(n_runs: int = INDEX_GATE_RUNS, *,
                device: "str | None" = None) -> None:
    """Indexed get vs full-scan locate of the same (last) run."""
    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    bench = next(b for b in make_suite(cfg, datasets=1)
                 if b.name == "DIAMOND")
    sim = Simulator(device=device)
    res = sim.run(bench, cfg)
    meta = run_meta("hanoi_torch", as_request(bench, cfg))
    print(f"\n== index: O(1) get vs full scan ({n_runs} runs) ==")
    with tempfile.TemporaryDirectory() as tmp:
        sink = RotatingJsonlSink(tmp, max_bytes=1 << 20)
        for _ in range(n_runs):
            feed_result(sink, res, meta)
        sink.flush()
        sink.close()

        t0 = time.perf_counter()
        idx = ArchiveIndex.build(tmp)
        t_build = time.perf_counter() - t0
        assert len(idx) == n_runs
        target = idx.entries[-1].run_id      # worst case for the scan

        reader = ArchiveReader(tmp)
        t0 = time.perf_counter()
        scanned = None
        for run in reader:                   # sequential locate
            scanned = run
        t_scan = time.perf_counter() - t0

        repeats = 20
        t0 = time.perf_counter()
        for _ in range(repeats):
            got = reader.get(target)         # seek + read one span
        t_get = (time.perf_counter() - t0) / repeats
        assert got.trace == scanned.trace and dict(got.meta) == \
            dict(scanned.meta), "indexed get must be bit-equal to the scan"

        speedup = t_scan / max(t_get, 1e-9)
        print(f"{'op':>10} {'wall_s':>10}")
        print(f"{'build':>10} {t_build:>10.4f}")
        print(f"{'scan':>10} {t_scan:>10.4f}")
        print(f"{'get':>10} {t_get:>10.6f}")
        print(f"indexed speedup: {speedup:.0f}x")
        if n_runs >= INDEX_GATE_RUNS:
            assert speedup >= INDEX_GATE_SPEEDUP, (
                f"acceptance gate: indexed get must be "
                f">={INDEX_GATE_SPEEDUP}x a full scan at {INDEX_GATE_RUNS} "
                f"runs; measured {speedup:.1f}x")
            print(f"gate OK: >= {INDEX_GATE_SPEEDUP}x at >= "
                  f"{INDEX_GATE_RUNS} runs")


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (still enforces the >=5x and >=10x "
                         "gates)")
    ap.add_argument("--device", default=None,
                    help="torch device hanoi_torch runs on (default: the "
                         "GPU; 'cpu' runs its plain twin)")
    args = ap.parse_args(argv)
    if args.smoke:
        bench_levenshtein((512, GATE_LEN), repeats=1)
        bench_archive(n_runs=60, device=args.device)
        bench_index(n_runs=INDEX_GATE_RUNS, device=args.device)
    else:
        bench_levenshtein((512, GATE_LEN, 4096))
        bench_archive(n_runs=400, device=args.device)
        bench_index(n_runs=2 * INDEX_GATE_RUNS, device=args.device)


if __name__ == "__main__":
    main()
