"""Benchmark aggregator: one section per paper table/figure.

Port of the repo's ``benchmarks/run.py``.  Prints ``name,us_per_call,
derived`` CSV rows (the same rows as the reference, in the same order,
under the same names), then the total.  Hanoi runs as ``hanoi_torch`` and
the SM engine as ``sm_torch`` on ``--device``: the card by default (kernels
K1 and K2; the kernel rows time K3, K4 and K5 there), their plain twins
with ``--device cpu``.

``--engine-api`` runs only a tiny end-to-end smoke of the unified
:mod:`repro_torch.engine` API (one ``Simulator.compare`` call on a reduced
machine) — the CI entry point; it exits non-zero when any mechanism fails
to complete a benchmark.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.run \\
          [--engine-api] [--device cpu]
"""
from __future__ import annotations

import argparse
import time


def engine_api_smoke(device=None) -> list[tuple[str, float, str]]:
    """One tiny end-to-end ``compare()`` through the unified engine API,
    with Hanoi as ``hanoi_torch`` on ``device`` (bit-equal to the numpy
    ``hanoi`` the reference compares, so the derived string is the
    reference's).

    Exits non-zero when any mechanism fails to complete a benchmark, so the
    CI step is a real regression gate, not just a printout.
    """
    from repro_torch.core import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import Simulator

    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    suite = [b for b in make_suite(cfg, datasets=1)
             if b.name in ("GAUS0", "BFSD", "DIAMOND")]
    hanoi = "hanoi_torch"
    t0 = time.perf_counter()
    report = Simulator(hanoi, device=device).compare(
        ["simt_stack", hanoi, "turing_oracle"], suite, cfg,
        pairs=[("simt_stack", hanoi), (hanoi, "turing_oracle")],
        timing=False)
    dt = (time.perf_counter() - t0) * 1e6
    sh = report.mean_discrepancy("simt_stack", hanoi)
    ho = report.mean_discrepancy(hanoi, "turing_oracle")
    ok = all(r.status_a == "ok" and r.status_b == "ok" for r in report.rows)
    rows = [("engine_api_smoke", dt,
             f"simt_vs_hanoi={100 * sh:.2f}%;"
             f"hanoi_vs_oracle={100 * ho:.2f}%;all_ok={ok}")]
    if not ok:
        bad = [(r.program, r.mech_a, r.status_a, r.mech_b, r.status_b)
               for r in report.rows
               if r.status_a != "ok" or r.status_b != "ok"]
        raise SystemExit(f"engine API smoke failed: non-ok statuses {bad}")
    return rows


def all_rows(device=None) -> list[tuple[str, float, str]]:
    """Every row of the full run, in the reference's order."""
    from . import bench_control_flow as bcf
    from . import bench_kernels as bk

    rows: list[tuple[str, float, str]] = []
    t0 = time.perf_counter()
    s = bcf.summary(device=device)
    dt = (time.perf_counter() - t0) * 1e6
    rows.append(("fig9_trace_discrepancy", dt,
                 f"avg={s['avg_discrepancy_pct']:.2f}%;"
                 f"zero={s['zero_discrepancy']}/{s['executions']}"))
    rows.append(("fig10_ipc_delta", dt,
                 f"avg_abs={s['avg_abs_ipc_delta_pct']:.2f}%;"
                 f"bfsd_gain={s['bfsd_ipc_gain_pct']:.1f}%;"
                 f"bfsd_util_gain={s['bfsd_util_gain_pct']:.1f}%"))

    t0 = time.perf_counter()
    hw = bcf.hw_cost_rows()
    dt = (time.perf_counter() - t0) * 1e6
    h8 = next(r for r in hw if r["n_bx"] == 8)
    rows.append(("sec9a_hw_cost", dt,
                 f"hanoi={h8['hanoi_bytes']}B;simt={h8['simt_stack_bytes']}B;"
                 f"saving={h8['saving_frac']:.1%}"))

    t0 = time.perf_counter()
    thr = bcf.engine_throughput(device=device)
    dt = (time.perf_counter() - t0) * 1e6
    rows.append(("engine_throughput", dt,
                 f"torch={thr['torch_warps_per_s']:.0f}w/s;"
                 f"numpy={thr['numpy_warps_per_s']:.0f}w/s;"
                 f"speedup={thr['speedup']:.2f}x"))

    rows += engine_api_smoke(device)

    t0 = time.perf_counter()
    census = bk.tile_census_rows()
    dt = (time.perf_counter() - t0) * 1e6
    for r in census:
        rows.append((f"tiles[{r['case']}]", dt / len(census),
                     f"kept={r['flops_kept_frac']:.3f};"
                     f"partial={r['partial']};empty={r['empty']}"))
    t0 = time.perf_counter()
    mech = bk.mechanism_utilization_rows(device)
    dt = (time.perf_counter() - t0) * 1e6
    for r in mech:
        rows.append((f"mech_util[{r['mechanism']}]", dt / len(mech),
                     f"util={r['utilization']:.3f};"
                     f"steps={r['steps']}"))
    for r in bk.kernel_timing_rows(device):
        rows.append((f"kernel[{r['kernel']}]", r["us"], ""))
    return rows


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine-api", action="store_true",
                    help="run only the repro_torch.engine end-to-end smoke "
                         "(tiny compare() call; used by CI)")
    ap.add_argument("--device", default=None,
                    help="torch device of the device mechanisms and kernels "
                         "(default: the card; 'cpu' runs the plain twins)")
    args = ap.parse_args(argv)
    t_all = time.perf_counter()
    rows = (engine_api_smoke(args.device) if args.engine_api
            else all_rows(args.device))
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    print(f"# total {time.perf_counter() - t_all:.1f}s")


if __name__ == "__main__":
    main()
