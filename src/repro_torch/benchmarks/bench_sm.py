"""Per-SM multi-warp interleaving sweep (``run_sm``) and the ``sm_torch``
gate.

Port of the repo's ``benchmarks/bench_sm.py``.  Sweeps warp count x
warp-scheduler policy x inner mechanism over a slice of the benchmark
suite and reports the SM-level schedule metrics: issue slots,
latency-aware cycles, thread IPC, and SIMD utilization.  The headline
effects to look for:

* more warps per SM hide memory latency — cycles grow sublinearly in
  warp count, so thread-IPC rises (the classic occupancy curve);
* ``greedy_then_oldest`` (GTO) beats ``round_robin`` on IPC when traces
  are memory-heavy (it keeps issuing from a ready warp instead of
  rotating onto stalled ones);
* a reconvergence-enforcing inner mechanism (``hanoi``) out-utilizes the
  stackless per-thread-PC scheduler (``volta_itps``) at equal warp count.

The sweep goes through ``Simulator.run_sm``'s defaults, as the
reference's does: a ``hanoi`` inner runs on ``sm_torch`` (one launch of
kernel K1 and one of K2 a cell, on ``--device``: the card by default,
their plain twins with ``--device cpu``), any other inner on
``sm_interleave``; the rows are the reference's.

``--smoke`` is the gate for the ``sm_torch`` SM engine: it runs the same
grid of SM cells through ``sm_torch`` (over a ``hanoi_torch`` inner; one
K1 and one K2 launch a batch, warmed so the kernels' build and load are
excluded) and through the Python interleaver (``sm_interleave`` +
``hanoi``), asserts bit-identical ``(warp, pc, mask)`` SM traces / cycles
/ stall taxonomies for every policy, and requires >= 10x speedup at >= 8
warps.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.bench_sm \\
          [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core import MachineConfig
from repro_torch.core.programs import make_suite
from repro_torch.engine import Simulator, get_mechanism
from repro_torch.engine.types import SimRequest
from repro_torch.service.planner import plan_dispatch
from repro_torch.timing.policies import POLICY_NAMES

CFG = MachineConfig(n_threads=8, mem_size=64, max_steps=20_000)
BENCHES = ("GAUS0", "RBFS0", "LUD0", "DIAMOND")
WARP_COUNTS = (1, 2, 4, 8)
POLICIES = ("round_robin", "greedy_then_oldest")
INNERS = ("hanoi", "volta_itps")


def sm_sweep_rows(benches=BENCHES, warp_counts=WARP_COUNTS,
                  policies=POLICIES, inners=INNERS,
                  device=None) -> list[dict]:
    sim = Simulator("hanoi", device=device)
    suite = {b.name: b for b in make_suite(CFG, datasets=1)}
    rows = []
    for name in benches:
        bench = suite[name]
        for inner in inners:
            for n_warps in warp_counts:
                for policy in policies:
                    sm = sim.run_sm(bench, CFG, n_warps=n_warps,
                                    inner=inner, policy=policy)
                    rows.append({
                        "bench": name, "inner": inner, "policy": policy,
                        "n_warps": n_warps, "status": sm.status.value,
                        "sm_slots": sm.steps, "cycles": sm.cycles,
                        "ipc": sm.ipc, "warp_ipc": sm.warp_ipc,
                        "utilization": sm.utilization,
                    })
    return rows


def occupancy_summary(rows: list[dict]) -> list[dict]:
    """Cycles-vs-warps scaling per (bench, inner): how sublinear is it?"""
    out = []
    for (bench, inner) in {(r["bench"], r["inner"]) for r in rows}:
        gto = {r["n_warps"]: r for r in rows
               if r["bench"] == bench and r["inner"] == inner
               and r["policy"] == "greedy_then_oldest"}
        lo, hi = min(gto), max(gto)
        scale = gto[hi]["cycles"] / max(1, gto[lo]["cycles"])
        out.append({"bench": bench, "inner": inner,
                    "warps": f"{lo}->{hi}",
                    "cycles_scale": scale,
                    "linear_scale": hi / lo,
                    "latency_hidden_frac": 1.0 - scale / (hi / lo),
                    "ipc_gain": gto[hi]["ipc"] / max(1e-9, gto[lo]["ipc"])})
    return sorted(out, key=lambda r: (r["bench"], r["inner"]))


def sm_torch_smoke(n_warps: int = 8, benches=BENCHES,
                   policies=POLICY_NAMES, min_speedup: float = 10.0,
                   timed_cells: int = 192, device=None) -> dict:
    """The sm_torch acceptance gate: trace equality + wall-clock speedup.

    Two parts.  **Equality**: every bench (including the long-trace LUD0)
    under every policy through the registered ``sm_torch`` batch runner vs
    the Python interleaver — the ``(warp, pc, mask)`` SM traces, cycles and
    stall taxonomies must be bit-identical.  **Timing**: a ``timed_cells``
    grid of short-trace SM cells under GTO, ``sm_torch`` warmed first (the
    kernels built and loaded) so the timed pass measures its launches and
    result assembly, against the serial Python interleaver.  Returns the
    measurement; ``main(--smoke)`` turns it into a pass/fail exit code.
    """
    sim = Simulator("hanoi", device=device)
    suite = {b.name: b for b in make_suite(CFG, datasets=1)}

    def cell_reqs(inner: str, names, policy_set) -> list[SimRequest]:
        return [SimRequest(program=suite[n].program, cfg=CFG,
                           init_mem=suite[n].init_mem, name=n,
                           meta={"sm_warps": n_warps, "sm_inner": inner,
                                 "sm_policy": policy})
                for policy in policy_set for n in names]

    # equality sweep: every policy x every bench
    eq_torch = cell_reqs("hanoi_torch", benches, policies)
    torch_res = sim.run_batch(eq_torch, mechanism="sm_torch")
    py_res = sim.run_batch(cell_reqs("hanoi", benches, policies),
                           mechanism="sm_interleave")
    mismatches = [
        (a.meta["sm"].policy, a.meta["sm"].requests[0].name)
        for a, b in zip(torch_res, py_res)
        if a.meta["sm"].sm_trace != b.meta["sm"].sm_trace
        or a.meta["sm"].cycles != b.meta["sm"].cycles
        or a.meta["sm"].stall_breakdown != b.meta["sm"].stall_breakdown
        or a.meta["sm"].thread_instructions
        != b.meta["sm"].thread_instructions]

    # timed grid: short-trace cells so the fixed lane-execution cost
    # amortizes over cells, GTO only
    short = tuple(n for n in benches if n != "LUD0") or benches
    names = [f"{short[i % len(short)]}" for i in range(timed_cells)]
    timed_torch = [SimRequest(program=suite[n].program, cfg=CFG,
                              init_mem=suite[n].init_mem, name=f"{n}#{i}",
                              meta={"sm_warps": n_warps,
                                    "sm_inner": "hanoi_torch",
                                    "sm_policy": "greedy_then_oldest"})
                   for i, n in enumerate(names)]
    timed_py = [SimRequest(program=q.program, cfg=CFG, init_mem=q.init_mem,
                           name=q.name,
                           meta={**dict(q.meta), "sm_inner": "hanoi"})
                for q in timed_torch]
    sim.run_batch(timed_torch, mechanism="sm_torch")     # warm the kernels
    t0 = time.perf_counter()
    sim.run_batch(timed_torch, mechanism="sm_torch")
    t_torch = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run_batch(timed_py, mechanism="sm_interleave")
    t_py = time.perf_counter() - t0
    # each signature group of an sm_torch run_batch is one K1 and one K2
    # launch: the equality sweep's groups, and the timed grid's twice
    mech = get_mechanism("sm_torch")
    batches = (len(plan_dispatch(mech, eq_torch))
               + 2 * len(plan_dispatch(mech, timed_torch)))
    return {"n_warps": n_warps, "cells": timed_cells,
            "sm_torch_batches": batches,
            "equality_cells": len(torch_res), "policies": tuple(policies),
            "t_sm_torch_s": t_torch, "t_sm_interleave_s": t_py,
            "speedup": t_py / max(1e-9, t_torch),
            "min_speedup": min_speedup, "mismatches": mismatches,
            "ok": not mismatches
            and t_py / max(1e-9, t_torch) >= min_speedup}


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--benches", default=",".join(BENCHES))
    ap.add_argument("--smoke", action="store_true",
                    help="sm_torch gate: bit-equal SM traces + >=10x "
                         "speedup")
    ap.add_argument("--smoke-warps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device sm_torch runs on (default: the card; "
                         "'cpu' runs the plain twins of K1 and K2)")
    args = ap.parse_args(argv)
    if args.smoke:
        res = sm_torch_smoke(n_warps=args.smoke_warps, device=args.device)
        print(f"sm_torch smoke: {res['equality_cells']} equality cells over "
              f"{len(res['policies'])} policies; timed grid "
              f"{res['cells']} cells x {res['n_warps']} warps")
        print(f"  sm_torch      {res['t_sm_torch_s']:.4f}s (warmed)")
        print(f"  sm_interleave {res['t_sm_interleave_s']:.4f}s")
        print(f"  speedup x{res['speedup']:.1f} "
              f"(gate x{res['min_speedup']:.0f}), "
              f"trace mismatches: {len(res['mismatches'])}")
        if res["mismatches"]:
            raise SystemExit(f"FAIL: sm_torch diverged from sm_interleave "
                             f"on {res['mismatches']}")
        if not res["ok"]:
            raise SystemExit(f"FAIL: speedup x{res['speedup']:.1f} below "
                             f"gate x{res['min_speedup']:.0f}")
        print("PASS")
        return
    rows = sm_sweep_rows(benches=tuple(args.benches.split(",")),
                         device=args.device)
    hdr = ("bench", "inner", "policy", "n_warps", "sm_slots", "cycles",
           "ipc", "utilization")
    print(",".join(hdr))
    for r in rows:
        print(",".join(f"{r[k]:.3f}" if isinstance(r[k], float) else str(r[k])
                       for k in hdr))
    print("\n== occupancy (GTO, cycles scaling vs warp count) ==")
    for r in occupancy_summary(rows):
        print(f"  {r['bench']:8s} inner={r['inner']:10s} "
              f"warps {r['warps']}: cycles x{r['cycles_scale']:.2f} "
              f"(linear would be x{r['linear_scale']:.0f}; "
              f"{100 * r['latency_hidden_frac']:.0f}% latency hidden), "
              f"IPC x{r['ipc_gain']:.2f}")


if __name__ == "__main__":
    main()
