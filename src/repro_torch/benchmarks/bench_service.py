"""Simulation-service throughput sweep: batch size x request mix x mechanism.

Port of the repo's ``benchmarks/bench_service.py`` over
:mod:`repro_torch.service`, with its gates unchanged.  The torch mechanism
is ``hanoi_torch``, on ``--device``: the card by default (one launch of
kernel K1 a coalesced group, one a request in the loop arm), its plain twin
with ``--device cpu``.

Three arms per cell, all producing identical results (the service test
suite asserts that); what differs is dispatch:

* ``loop``    — the pre-service baseline: one ``Simulator.run`` per request;
* ``batch``   — the planner path: one ``Simulator.run_batch`` call
  (signature grouping, one K1 launch a homogeneous ``hanoi_torch`` group);
* ``service`` — the full queue: admission -> coalescer -> worker pool.

Mixes: ``hanoi_torch`` (homogeneous, native), ``hanoi`` (homogeneous,
numpy) and ``mixed`` (``hanoi_torch``, ``hanoi``, ``simt_stack`` in turn).
The coalesced arm is held to at least the per-request loop's warps/s at
the sweep's largest batch size (printed, as in the reference).

The ``--procs`` sweep adds the process-backed execution tier: the same
numpy-heavy traffic through 1..N shard processes.  ``--smoke --procs 2``
enforces two hard gates (exit 1 on failure):

* **scaling** — the numpy mix at 2 procs sustains >= 1.5x the warps/s of
  1 proc.  Enforced only when the host exposes >= 2 CPUs to this process;
  a 1-CPU runner reports the sweep and marks the gate SKIPPED;
* **warm start** — a restarted ``warm_start=`` service admits traffic
  with zero serve-time kernel-cache misses (``cache_misses == 0`` and
  ``warm_retraced == 0``, with ``warm_loaded >= 1``), proven by the
  service's own counters.

Run:   PYTHONPATH=src python -m repro_torch.benchmarks.bench_service
CI:    PYTHONPATH=src python -m repro_torch.benchmarks.bench_service \
           --smoke --procs 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.core import MachineConfig
from repro_torch.core.programs import make_suite
from repro_torch.engine import SimRequest, Simulator
from repro_torch.service import SimulationService

CFG = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
BATCH_SIZES = (4, 16, 64)
MIXES = {
    "hanoi_torch": ("hanoi_torch",),                  # homogeneous, native
    "hanoi": ("hanoi",),                              # homogeneous, numpy
    "mixed": ("hanoi_torch", "hanoi", "simt_stack"),  # round-robin mix
}


def _requests(n: int, benches, seed: int = 0, *,
              rotate: bool = False) -> list[SimRequest]:
    """``n`` requests over fresh memory images.

    The homogeneous sweeps replicate ONE kernel over many datasets (the
    service's target traffic shape: a K1 launch waits for its slowest
    warp, so same-program batches waste no work); ``rotate=True`` cycles
    programs for the mixed sweep.
    """
    rng = np.random.default_rng(seed)
    return [SimRequest(program=benches[i % len(benches)].program
                       if rotate else benches[0].program, cfg=CFG,
                       init_mem=rng.integers(0, 8, size=CFG.mem_size)
                       .astype(np.int32),
                       record_trace=False, name=f"req{i}")
            for i in range(n)]


def _time(fn, repeats: int = 3) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_rows(batch_sizes=BATCH_SIZES, mixes=MIXES, *, workers: int = 2,
               repeats: int = 3, device=None) -> list[dict]:
    benches = [b for b in make_suite(CFG, datasets=1)
               if b.name in ("HOTS0", "GAUS0", "RBFS0", "DIAMOND")]
    sim = Simulator("hanoi", device=device)
    rows = []
    for mix_name, mechs in mixes.items():
        for n in batch_sizes:
            reqs = _requests(n, benches, rotate=len(mechs) > 1)
            assign = [mechs[i % len(mechs)] for i in range(n)]

            def loop_arm():
                return [sim.run(r, mechanism=m)
                        for r, m in zip(reqs, assign)]

            def batch_arm():
                out = []
                for mech in mechs:        # one run_batch per mechanism lane
                    sub = [r for r, m in zip(reqs, assign) if m == mech]
                    out.extend(sim.run_batch(sub, mechanism=mech))
                return out

            def service_arm():
                with SimulationService(default_mechanism=mechs[0],
                                       device=device, max_batch=n,
                                       max_wait_s=0.05, workers=workers,
                                       annotate=False) as svc:
                    tickets = [svc.submit(r, mechanism=m)
                               for r, m in zip(reqs, assign)]
                    svc.flush()
                    return [t.result() for t in tickets]

            loop_arm(); batch_arm(); service_arm()        # warm-up
            t_loop = _time(loop_arm, repeats)
            t_batch = _time(batch_arm, repeats)
            t_service = _time(service_arm, repeats)
            rows.append({
                "mix": mix_name, "batch": n,
                "loop_warps_s": n / t_loop,
                "batch_warps_s": n / t_batch,
                "service_warps_s": n / t_service,
                "coalesced_speedup": t_loop / t_service,
            })
    return rows


def _available_cpus() -> int:
    """CPUs this process may actually run on (affinity-aware)."""
    import os
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                       # non-Linux fallback
        return os.cpu_count() or 1


def proc_scaling_rows(procs_list=(1, 2), n: int = 64, repeats: int = 3,
                      device=None) -> list[dict]:
    """Numpy-mix throughput through the process tier, per shard count.

    The workload is the suite's heaviest numpy kernel (LUD0) replicated
    over fresh memory images, so the per-request interpreter work dwarfs
    the pickle + queue overhead the spawn boundary adds — that is what
    makes the >= 1.5x gate fair.  The service is started once per shard
    count; only ``svc.run`` is timed.
    """
    benches = [b for b in make_suite(CFG, datasets=1) if b.name == "LUD0"]
    reqs = _requests(n, benches)
    rows = []
    for procs in procs_list:
        with SimulationService(default_mechanism="hanoi", device=device,
                               procs=procs, max_batch=n, max_wait_s=0.05,
                               annotate=False) as svc:
            svc.run(reqs, timeout=300)                      # warm-up
            t = _time(lambda: svc.run(reqs, timeout=300), repeats)
            st = svc.stats()
        rows.append({"procs": procs, "batch": n, "warps_s": n / t,
                     "scaling": (n / t) / rows[0]["warps_s"] if rows
                     else 1.0,
                     "shards_used": sum(1 for s in st.shards
                                        if s.completed > 0)})
    return rows


def warm_start_report(n: int = 8, device=None) -> dict:
    """Cold-serve then restart-warm-serve one hot ``hanoi_torch`` signature
    through one shard process.

    Returns the counters the zero-miss gate is judged on: the second
    (restarted, warm-started) service must admit and serve the same
    traffic shape without a single serve-time kernel-cache miss.
    """
    from repro_torch.engine.compile_cache import supports_serialization
    benches = [b for b in make_suite(CFG, datasets=1) if b.name == "GAUS0"]
    reqs = _requests(n, benches)
    runs = []
    with tempfile.TemporaryDirectory(prefix="repro-warm-bench-") as cache:
        for _ in range(2):
            with SimulationService(default_mechanism="hanoi_torch",
                                   device=device, procs=1, warm_start=cache,
                                   max_batch=n, max_wait_s=60.0,
                                   annotate=False) as svc:
                t0 = time.perf_counter()
                out = svc.run(reqs, timeout=600)
                runs.append((time.perf_counter() - t0, out, svc.stats()))
    (cold_s, cold, st1), (warm_s, warm, st2) = runs
    return {"cold_s": cold_s, "warm_s": warm_s,
            "cold_ok": sum(r.ok for r in cold),
            "warm_ok": sum(r.ok for r in warm),
            "cold_misses": st1.cache_misses,
            "warm_signatures": st2.warm_signatures,
            "warm_loaded": st2.warm_loaded,
            "warm_retraced": st2.warm_retraced,
            "serve_misses": st2.cache_misses,
            "serializable": supports_serialization(),
            "zero_retrace": st2.cache_misses == st2.warm_retraced == 0
            and st2.warm_loaded >= 1}


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small CI sweep (one batch size per mix); with "
                         "--procs, enforces the scaling + warm-start gates")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--procs", type=int, default=0,
                    help="also sweep the process tier at 1..N shard "
                         "processes on the numpy mix")
    ap.add_argument("--device", default=None,
                    help="torch device hanoi_torch runs on (default: the "
                         "GPU; 'cpu' runs its plain twin)")
    args = ap.parse_args(argv)
    sizes = (16,) if args.smoke else BATCH_SIZES
    repeats = 3
    rows = sweep_rows(batch_sizes=sizes, workers=args.workers,
                      repeats=repeats, device=args.device)
    hdr = ("mix", "batch", "loop_warps_s", "batch_warps_s",
           "service_warps_s", "coalesced_speedup")
    print(",".join(hdr))
    for r in rows:
        print(",".join(f"{r[k]:.1f}" if isinstance(r[k], float) else str(r[k])
                       for k in hdr))
    homog = [r for r in rows if r["mix"] == "hanoi_torch"]
    print("\n== homogeneous hanoi_torch: coalesced vs per-request loop ==")
    for r in homog:
        print(f"  batch {r['batch']:3d}: service {r['service_warps_s']:8.1f} "
              f"warps/s vs loop {r['loop_warps_s']:8.1f} "
              f"({r['coalesced_speedup']:.2f}x)")
    # the acceptance gate sits at the largest batch size: coalescing is a
    # batch-amortization play (at batch 4 there is nothing to coalesce and
    # queue overhead shows)
    at_scale = max(homog, key=lambda r: r["batch"])
    status = "OK" if at_scale["coalesced_speedup"] >= 1.0 else "BELOW PAR"
    print(f"  at batch {at_scale['batch']}: "
          f"{at_scale['coalesced_speedup']:.2f}x -> {status} "
          f"(acceptance: coalesced >= per-request loop)")

    if not args.procs:
        return
    failures = []

    print("\n== process tier: numpy mix (LUD0 x64) across shard "
          "processes ==")
    prows = proc_scaling_rows(procs_list=tuple(range(1, args.procs + 1)),
                              repeats=repeats, device=args.device)
    for r in prows:
        print(f"  procs {r['procs']}: {r['warps_s']:8.1f} warps/s "
              f"({r['scaling']:.2f}x vs 1 proc, "
              f"{r['shards_used']} shard(s) serving)")
    if args.procs >= 2:
        two = next(r for r in prows if r["procs"] == 2)
        cpus = _available_cpus()
        if cpus < 2:
            print(f"  gate: 2-proc scaling {two['scaling']:.2f}x — "
                  f"SKIPPED ({cpus} CPU visible; two shard processes "
                  f"cannot scale on one core)")
        else:
            gate = two["scaling"] >= 1.5
            print(f"  gate: 2-proc scaling {two['scaling']:.2f}x >= "
                  f"1.50x -> {'OK' if gate else 'FAIL'}")
            if not gate:
                failures.append(
                    f"proc scaling {two['scaling']:.2f}x < 1.5x")

    print("\n== warm start: restarted service, hot hanoi_torch "
          "signature ==")
    w = warm_start_report(device=args.device)
    print(f"  cold serve: {w['cold_s']:.4f}s ({w['cold_ok']} ok, "
          f"{w['cold_misses']} miss(es))")
    print(f"  warm serve: {w['warm_s']:.4f}s ({w['warm_ok']} ok) — "
          f"manifest {w['warm_signatures']} sig(s), "
          f"{w['warm_loaded']} loaded + {w['warm_retraced']} missed at "
          f"warm time, {w['serve_misses']} serve-time miss(es), "
          f"libraries on disk={w['serializable']}")
    print(f"  gate: zero serve-time miss -> "
          f"{'OK' if w['zero_retrace'] else 'FAIL'}")
    if not w["zero_retrace"]:
        failures.append("warm-start restart missed at serve time")

    if args.smoke and failures:
        raise SystemExit("bench gates FAILED: " + "; ".join(failures))


if __name__ == "__main__":
    main()
