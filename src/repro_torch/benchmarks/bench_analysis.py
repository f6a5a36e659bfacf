"""Static-analysis benchmarks: analyzer + synthesizer + similarity.

Three sections:

* **analyzer** — cold-cache ``analyze_program`` over the full benchmark
  suite plus every ``tests/progen.py`` distribution (the same corpus the
  conformance gate walks), reporting programs/s.  The acceptance gate
  asserts >= 1k programs/s *with caches cleared* — static
  admission must be invisible next to simulation cost, and the service
  runs it on every submit.
* **synthesizer** — cold-cache ``strip_annotations`` →
  ``synthesize_annotations`` round-trips over the same corpus, gating
  both throughput (>= 500 programs/s: repair-at-admission must stay
  cheap) and correctness (every round-trip bit-equal to the compiler's
  own annotation — the known FIG5 deviation excepted — and error-free
  under re-analysis).
* **similarity** — "find archived runs whose control flow resembles this
  program", both ways: ranking CFG fingerprints straight from the sidecar
  index (``ArchiveIndex.rank_similar``, nothing replayed, no archive file
  opened) versus the replay-based baseline (re-execute every archived run
  and Levenshtein-diff its trace against the query's).  The acceptance
  gate asserts the index path is >= 100x faster — what makes "search the
  fleet's archive for this pathology" interactive instead of a batch job.

Port of the repo's ``benchmarks/bench_analysis.py`` over
:mod:`repro_torch.analysis`, with its gates unchanged; ``--smoke`` takes
the best of five cold passes for the two throughput gates (the reference's
smoke takes one and two; its full run three).  The programs that
run (the synthesizer's deviating round-trips, the archived runs and the
replay baseline) run under ``hanoi_torch`` on ``--device``: the card by
default (kernel K1), its plain twin with ``--device cpu``.

Each section is a measuring function (``bench_*``: its numbers, and the
correctness holds, which any host meets) and a gate (``gate_*``: the
rates, which need an idle host); ``main()`` runs both.

Run:   PYTHONPATH=src python -m repro_torch.benchmarks.bench_analysis
CI:    PYTHONPATH=src python -m repro_torch.benchmarks.bench_analysis \
           --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.analysis import analyze_program, fingerprint
from repro_torch.analysis.fingerprint import _CACHE as _FP_CACHE
from repro_torch.analysis.passes import _analyze_cached
from repro_torch.archive import ArchiveIndex, ArchiveReader, request_from_meta
from repro_torch.core import MachineConfig
from repro_torch.core.programs import make_suite, spinlock_program
from repro_torch.core.trace import levenshtein, trace_tokens
from repro_torch.engine import RotatingJsonlSink, Simulator

from .progen import corpus

GATE_PROGRAMS_PER_S = 1000.0     # acceptance: cold analyzer throughput
GATE_SYNTH_PROGRAMS_PER_S = 500.0   # acceptance: strip+synthesize round-trip
GATE_SIM_SPEEDUP = 100.0         # acceptance: sidecar rank vs replay+diff

# round-trips that are equivalent but deliberately not bit-equal: FIG5
# hand-forces B0 reuse + an R0 spill the allocator improves away
KNOWN_DEVIATIONS = {"FIG5"}


def _clear_caches() -> None:
    _analyze_cached.cache_clear()
    _FP_CACHE.clear()


def bench_analyzer(n_seeds: int, *, repeats: int = 3) -> dict:
    """Measure the cold analyzer; returns its numbers (``rate`` in
    programs/s, ``errors``) for :func:`gate_analyzer`."""
    cfg = MachineConfig(n_threads=8)
    progs = [(b.name, b.program, cfg) for b in make_suite(cfg)]
    progs += corpus(n_seeds)
    print(f"== analyzer: cold-cache analyze_program over "
          f"{len(progs)} programs (suite + progen x{n_seeds} seeds) ==")
    best = float("inf")
    n_diags = n_errors = 0
    for _ in range(repeats):
        _clear_caches()
        t0 = time.perf_counter()
        reports = [analyze_program(p, c, name=name) for name, p, c in progs]
        best = min(best, time.perf_counter() - t0)
        n_diags = sum(len(r.diagnostics) for r in reports)
        n_errors = sum(len(r.errors) for r in reports)
    rate = len(progs) / max(best, 1e-9)
    print(f"{'programs':>9} {'wall_s':>9} {'progs/s':>10} "
          f"{'diags':>6} {'errors':>7}")
    print(f"{len(progs):>9} {best:>9.3f} {rate:>10.0f} "
          f"{n_diags:>6} {n_errors:>7}")

    # warm path (the service's steady state: repeated signatures)
    t0 = time.perf_counter()
    for name, p, c in progs:
        analyze_program(p, c, name=name)
    t_warm = time.perf_counter() - t0
    print(f"warm (cached): {len(progs) / max(t_warm, 1e-9):.0f} progs/s")
    return {"programs": len(progs), "rate": rate, "errors": n_errors}


def gate_analyzer(r: dict) -> None:
    assert r["errors"] == 0, "conformance: suite + progen must be error-free"
    assert r["rate"] >= GATE_PROGRAMS_PER_S, (
        f"acceptance gate: cold analyzer must sustain "
        f">={GATE_PROGRAMS_PER_S:.0f} programs/s; measured {r['rate']:.0f}")
    print(f"gate OK: >= {GATE_PROGRAMS_PER_S:.0f} programs/s cold "
          f"({r['rate']:.0f}/s), zero errors")


def bench_synthesizer(n_seeds: int, *, repeats: int = 3,
                      device: "str | None" = None) -> dict:
    """Strip → synthesize over suite + every progen distribution.

    Measures the cold throughput (``rate``, gated >= 500 programs/s by
    :func:`gate_synthesizer`) and holds the round trip: every
    resynthesized program must be bit-equal to the structured compiler's
    annotation (KNOWN_DEVIATIONS excepted) and re-analyze with zero errors
    — the same contract the service's ``auto_annotate`` admission repair
    leans on — and a known deviation must still run as the original.
    """
    import numpy as np

    from repro_torch.analysis import (strip_annotations,
                                      synthesize_annotations, verify_program)

    cfg = MachineConfig(n_threads=8)
    progs = [(b.name, b.program, cfg) for b in make_suite(cfg)]
    progs += corpus(n_seeds)
    print(f"\n== synthesizer: cold strip+synthesize round-trip over "
          f"{len(progs)} programs (suite + progen x{n_seeds} seeds) ==")
    best = float("inf")
    for _ in range(repeats):
        _clear_caches()
        t0 = time.perf_counter()
        results = [(name, p, c,
                    synthesize_annotations(strip_annotations(p, c).program,
                                           c))
                   for name, p, c in progs]
        best = min(best, time.perf_counter() - t0)
    rate = len(progs) / max(best, 1e-9)
    n_regions = sum(r.regions for _, _, _, r in results)
    n_yields = sum(r.yields for _, _, _, r in results)
    deviations = [name for name, p, c, r in results
                  if not np.array_equal(r.program, np.asarray(p))]
    for name, p, c, r in results:
        assert not verify_program(r.program, c).errors, name
    print(f"{'programs':>9} {'wall_s':>9} {'progs/s':>10} "
          f"{'regions':>8} {'yields':>7}")
    print(f"{len(progs):>9} {best:>9.3f} {rate:>10.0f} "
          f"{n_regions:>8} {n_yields:>7}")
    unexpected = [n for n in deviations
                  if n.split(":")[-1] not in KNOWN_DEVIATIONS]
    assert not unexpected, (
        f"acceptance gate: round-trip must be bit-equal outside "
        f"{sorted(KNOWN_DEVIATIONS)}; deviated: {unexpected}")
    # bit-equal programs are trivially trace-equivalent; the known
    # deviations must still prove it by execution (memory + status)
    sim = Simulator(device=device)
    for name, p, c, r in results:
        if name not in deviations:
            continue
        ra = sim.run(p, c)
        rb = sim.run(r.program, c)
        assert ra.status == rb.status and np.array_equal(ra.mem, rb.mem), (
            f"{name}: deviating round-trip is not execution-equivalent")
    return {"programs": len(progs), "rate": rate, "deviations": deviations}


def gate_synthesizer(r: dict) -> None:
    assert r["rate"] >= GATE_SYNTH_PROGRAMS_PER_S, (
        f"acceptance gate: cold strip+synthesize must sustain "
        f">={GATE_SYNTH_PROGRAMS_PER_S:.0f} programs/s; "
        f"measured {r['rate']:.0f}")
    print(f"gate OK: >= {GATE_SYNTH_PROGRAMS_PER_S:.0f} programs/s cold "
          f"({r['rate']:.0f}/s), bit-equal outside {sorted(KNOWN_DEVIATIONS)}")


def bench_similarity(n_runs: int, *, device: "str | None" = None) -> dict:
    """Sidecar fingerprint ranking vs replay-every-run-and-diff: returns
    the ``speedup`` (gated >= 100x by :func:`gate_similarity`) and the
    program of the nearest run each way (``nearest_by_fingerprint``,
    ``nearest_by_replay``)."""
    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    suite = make_suite(cfg, datasets=1)
    sim = Simulator(device=device)
    query = spinlock_program()
    print(f"\n== similarity: sidecar rank vs replay+diff "
          f"({n_runs} archived runs) ==")
    with tempfile.TemporaryDirectory() as tmp:
        sink = RotatingJsonlSink(tmp, max_bytes=1 << 22)
        for i in range(n_runs):
            sim.run(suite[i % len(suite)], cfg, sink=sink)
        sink.flush()
        sink.close()
        idx = ArchiveIndex.ensure(tmp)               # built once, off-path
        assert len(idx) == n_runs
        assert all(e.fp is not None for e in idx.entries)

        # index path: fingerprint the query, rank from the sidecar alone
        repeats = 10
        t0 = time.perf_counter()
        for _ in range(repeats):
            _clear_caches()                          # no free rides
            ranked = idx.rank_similar(fingerprint(query))
        t_index = (time.perf_counter() - t0) / repeats
        assert len(ranked) == n_runs

        # replay baseline: re-execute every archived run, Levenshtein its
        # trace against the query's (how you'd compare without fingerprints)
        q_tokens = trace_tokens(list(sim.run(query, cfg).trace))
        runs = ArchiveReader(tmp).runs()
        t0 = time.perf_counter()
        scored = []
        for run in runs:
            req = request_from_meta(run.meta)
            res = sim.run(req.program, req.cfg)
            dist = int(levenshtein(trace_tokens(list(res.trace)), q_tokens))
            scored.append((dist, run.meta.get("program", "")))
        t_replay = time.perf_counter() - t0
        scored.sort()

        speedup = t_replay / max(t_index, 1e-9)
        nearest = ArchiveReader(tmp).get(ranked[0][0]).meta.get("program")
        print(f"{'path':>12} {'wall_s':>10}")
        print(f"{'sidecar':>12} {t_index:>10.5f}")
        print(f"{'replay+diff':>12} {t_replay:>10.3f}")
        print(f"nearest by fingerprint: {ranked[0][0]} ({nearest}) "
              f"d={ranked[0][1]:.4f}; "
              f"nearest by replay: {scored[0][1]} lev={scored[0][0]}")
        print(f"speedup: {speedup:.0f}x")
    return {"speedup": speedup, "nearest_by_fingerprint": nearest,
            "nearest_by_replay": scored[0][1]}


def gate_similarity(r: dict) -> None:
    assert r["speedup"] >= GATE_SIM_SPEEDUP, (
        f"acceptance gate: sidecar similarity must be "
        f">={GATE_SIM_SPEEDUP:.0f}x replay-based comparison; "
        f"measured {r['speedup']:.1f}x")
    print(f"gate OK: >= {GATE_SIM_SPEEDUP:.0f}x over replay")


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (still enforces the >=1k programs/s "
                         "and >=100x gates)")
    ap.add_argument("--device", default=None,
                    help="torch device hanoi_torch runs on (default: the "
                         "GPU; 'cpu' runs its plain twin)")
    args = ap.parse_args(argv)
    if args.smoke:
        # the best of five cold passes: one ~0.1 s pass on a busy host
        # times the neighbours' bursts, not the analyzer
        gate_analyzer(bench_analyzer(n_seeds=40, repeats=5))
        gate_synthesizer(bench_synthesizer(n_seeds=40, repeats=5,
                                           device=args.device))
        gate_similarity(bench_similarity(n_runs=120, device=args.device))
    else:
        gate_analyzer(bench_analyzer(n_seeds=120))
        gate_synthesizer(bench_synthesizer(n_seeds=120, device=args.device))
        gate_similarity(bench_similarity(n_runs=200, device=args.device))


if __name__ == "__main__":
    main()
