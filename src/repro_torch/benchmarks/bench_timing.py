"""Cycle-engine benchmarks: event throughput + the Fig 10 IPC-delta smoke.

Port of the repo's ``benchmarks/bench_timing.py`` over
:mod:`repro_torch.timing` (the numpy cycle engine, copied), with its gates
unchanged.  Two sections:

* **throughput** — ``repro_torch.timing.schedule_cycle`` over multi-warp,
  memory-heavy warp sets (the progen ``mem_features`` distribution),
  reporting issue slots/s and completion events/s through the event queue
  for every mode that changes the hot loop: trace-conservative,
  scoreboard, dual-issue, and a sampled memory distribution.  The
  acceptance gate asserts a floor on events/s — the cycle engine is pure
  Python and the Fig 10 sweep re-prices every (program, mechanism)
  schedule, so a regression here multiplies straight into evaluation
  wall-time.
* **fig10** — ``Simulator.compare(..., timing="cycle")`` hanoi vs
  simt_stack over a suite slice: the paper's IPC-delta evaluation on the
  cycle engine.  Hanoi runs as ``hanoi_torch`` on ``--device`` (kernel K1
  on the card by default, its plain twin with ``--device cpu``), bit-equal
  to the numpy ``hanoi`` the reference runs.  Gates: every delta
  finite, self-comparison exactly 0.0, and every per-schedule result
  partitions its cycles into busy + scoreboard-stall + memory-stall.

A quick differential spot-check (unit-latency cycle engine ==
``schedule_traces_reference`` bit-for-bit) runs in both modes — the full
gate lives in ``tests/test_timing.py``.

Run:   PYTHONPATH=src python -m repro_torch.benchmarks.bench_timing
CI:    PYTHONPATH=src python -m repro_torch.benchmarks.bench_timing \
           --smoke [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import MachineConfig
from repro_torch.core.programs import make_suite
from repro_torch.core.timing import TimingConfig, schedule_traces_reference
from repro_torch.engine import Simulator
from repro_torch.timing import CycleConfig, schedule_cycle

from .progen import make_program

GATE_EVENTS_PER_S = 20_000     # floor on completion events/s (pure Python)

CFG = MachineConfig(n_threads=8, mem_size=64, max_steps=20_000)
FIG10_BENCHES = ("HOTS0", "GAUS0", "DIAMOND", "BFSD")


def _warp_sets(n_warps: int, n_sets: int):
    """Memory-heavy multi-warp sets from the progen distribution."""
    sim = Simulator("simt_stack")
    sets = []
    seed = 0
    while len(sets) < n_sets:
        out, cfg = make_program(seed, 8, mem_features=True)
        seed += 1
        if out is None:
            continue
        prog, mem = out
        res = sim.run(prog, cfg, init_mem=mem)
        trace = list(res.trace)
        sets.append(([trace] * n_warps, [np.asarray(prog)] * n_warps))
    return sets


def bench_throughput(*, n_warps: int = 8, n_sets: int = 6,
                     repeats: int = 3) -> None:
    sets = _warp_sets(n_warps, n_sets)
    modes = [
        ("trace", CycleConfig(scoreboard=False)),
        ("scoreboard", CycleConfig(scoreboard=True)),
        ("dual_issue", CycleConfig(scoreboard=True, issue_width=2)),
        ("bimodal_mem", CycleConfig(scoreboard=True, memory_model="bimodal",
                                    seed=7)),
    ]
    print(f"== schedule_cycle throughput ({n_warps} warps x {n_sets} "
          f"sets) ==")
    print(f"{'mode':>12} {'slots':>8} {'cycles':>8} {'sched_s':>9} "
          f"{'slots/s':>10} {'events/s':>10}")
    worst = float("inf")
    for name, ccfg in modes:
        slots = cycles = 0
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            slots = cycles = 0
            for traces, progs in sets:
                res = schedule_cycle(traces, progs, "greedy_then_oldest",
                                     ccfg)
                slots += res.issues
                cycles += res.cycles
            best = min(best, time.perf_counter() - t0)
        # every issued slot pushes exactly one completion event; idle
        # fast-forwards pop (and may discard) them — slots/s is the
        # conservative events/s proxy
        rate = slots / max(best, 1e-9)
        worst = min(worst, rate)
        print(f"{name:>12} {slots:>8} {cycles:>8} {best:>9.4f} "
              f"{rate:>10.0f} {rate:>10.0f}")
    assert worst >= GATE_EVENTS_PER_S, (
        f"cycle-engine throughput regressed: {worst:.0f} events/s < gate "
        f"{GATE_EVENTS_PER_S}")
    print(f"[gate] min {worst:.0f} events/s >= {GATE_EVENTS_PER_S} OK")


def bench_fig10(*, benches=FIG10_BENCHES, device=None) -> None:
    sim = Simulator("hanoi_torch", device=device)
    suite = [b for b in make_suite(CFG, datasets=1) if b.name in benches]
    t0 = time.perf_counter()
    rep = sim.compare(["hanoi_torch", "simt_stack"], suite, CFG,
                      timing="cycle")
    dt = time.perf_counter() - t0
    print(f"== Fig 10 (cycle engine): hanoi (hanoi_torch) vs simt_stack "
          f"({dt:.2f}s) ==")
    print(f"{'bench':>10} {'disc%':>7} {'ipc_delta%':>11} "
          f"{'hanoi_ipc':>10} {'stack_ipc':>10}")
    for row in rep.rows:
        if row.mech_b != "simt_stack" or row.mech_a != "hanoi_torch":
            continue
        ta = rep.timing_results[(row.program, "hanoi_torch")]
        tb = rep.timing_results[(row.program, "simt_stack")]
        print(f"{row.program:>10} {100 * row.discrepancy:>7.2f} "
              f"{row.ipc_delta_pct:>11.2f} {ta.ipc:>10.3f} "
              f"{tb.ipc:>10.3f}")
    assert rep.rows, "compare produced no rows"
    assert all(np.isfinite(r.ipc_delta) for r in rep.rows)
    for tres in rep.timing_results.values():
        assert tres.cycles == (tres.busy_cycles
                               + tres.scoreboard_stall_cycles
                               + tres.memory_stall_cycles), tres
    self_rep = sim.compare(["hanoi_torch"], suite, CFG,
                           pairs=[("hanoi_torch", "hanoi_torch")],
                           timing="cycle")
    assert all(r.ipc_delta == 0.0 for r in self_rep.rows)
    print("[gate] deltas finite, self-delta 0.0, stall partition OK")


def differential_spot_check(*, n_sets: int = 3) -> None:
    sets = _warp_sets(3, n_sets)
    for traces, progs in sets:
        ops = [p[:, 0] for p in progs]
        for policy in ("greedy_then_oldest", "round_robin"):
            ref = schedule_traces_reference(traces, ops, policy,
                                            TimingConfig())
            res = schedule_cycle(traces, progs, policy,
                                 CycleConfig.from_timing(TimingConfig()))
            assert (res.order, res.cycles, res.thread_instructions) == ref, \
                f"cycle engine drifted from reference under {policy}"
    print(f"[gate] unit-latency == reference over {n_sets} warp sets OK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small fast run with the same gates (CI)")
    ap.add_argument("--device", default=None,
                    help="torch device hanoi_torch runs on in the Fig 10 "
                         "section (default: the card; 'cpu' runs its plain "
                         "twin)")
    args = ap.parse_args(argv)
    if args.smoke:
        differential_spot_check(n_sets=2)
        bench_throughput(n_warps=4, n_sets=3, repeats=1)
        bench_fig10(benches=("HOTS0", "DIAMOND"), device=args.device)
    else:
        differential_spot_check()
        bench_throughput()
        bench_fig10(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
