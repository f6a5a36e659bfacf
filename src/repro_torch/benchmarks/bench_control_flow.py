"""Paper-table benchmarks for the Hanoi control-flow engine.

Port of the repo's ``benchmarks/bench_control_flow.py``.  All measurements
flow through the unified :mod:`repro_torch.engine` API:

* Fig 9  — control-flow trace discrepancy (Levenshtein %) Hanoi vs. the
           Turing-oracle ("hardware") traces across the benchmark suite,
           via ``Simulator.compare``;
* Fig 10 — relative IPC difference via the trace-driven timing model,
           including the BFSD outlier (+SIMD-utilization gain);
* SS IX-A — hardware storage cost vs. a SIMT-Stack (432 B / ~43% claim);
* engine throughput: the device mechanism (``hanoi_torch``, one launch of
  kernel K1 a ``run_batch``) vs. the numpy reference mechanism,
  warps/second.

Hanoi is ``hanoi_torch`` on ``device``: the card by default, its plain
twin with ``device="cpu"``; it is bit-equal to the numpy ``hanoi`` the
reference compares, so the rows are the reference's.  ``mechanism="hanoi"``
computes the same tables with the numpy engine.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.bench_control_flow \\
          [--device cpu]
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np

from repro_torch.core import MachineConfig, hardware_cost_bytes
from repro_torch.core.programs import make_suite
from repro_torch.core.timing import TimingConfig
from repro_torch.engine import CompareReport, SimRequest, Simulator

CFG = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
ORACLE = "turing_oracle"


@functools.lru_cache(maxsize=1)
def _suite():
    # benchmarks are frozen and engines never mutate the shared program /
    # init_mem arrays, so one suite instance serves every table
    return make_suite(CFG, datasets=2)


def compare_report(device=None, mechanism: str = "hanoi_torch"
                   ) -> CompareReport:
    """One engine-API call computes both Fig 9 and Fig 10 inputs: Hanoi
    (``mechanism`` on ``device``) against the hardware oracle."""
    pair = (mechanism, ORACLE)
    return Simulator(mechanism, device=device).compare(
        list(pair), _suite(), CFG, pairs=[pair], timing_warps=4,
        timing_cfg=TimingConfig())


def _rows(report: CompareReport):
    return report.pair(report.mechanisms[0], ORACLE)


def trace_discrepancy_rows(report: CompareReport | None = None,
                           device=None) -> list[dict]:
    """Fig 9: per-execution trace discrepancy vs the hardware oracle."""
    report = report or compare_report(device)
    families = {b.name: b.family for b in _suite()}
    return [{"bench": row.program, "family": families[row.program],
             "discrepancy_pct": row.discrepancy_pct,
             "trace_len": row.trace_len_b}
            for row in _rows(report)]


def ipc_rows(report: CompareReport | None = None,
             device=None) -> list[dict]:
    """Fig 10: relative IPC (trace-driven GTO model) Hanoi vs hardware."""
    report = report or compare_report(device)
    return [{"bench": row.program,
             "ipc_hanoi": row.ipc_a, "ipc_hw": row.ipc_b,
             "ipc_delta_pct": row.ipc_delta_pct,
             "util_hanoi": row.util_a, "util_hw": row.util_b}
            for row in _rows(report)]


def summary(report: CompareReport | None = None, device=None) -> dict:
    """The paper's headline numbers on our suite."""
    report = report or compare_report(device)
    dd = trace_discrepancy_rows(report)
    ii = ipc_rows(report)
    zero = sum(1 for r in dd if r["discrepancy_pct"] == 0.0)
    nonzero = [r for r in dd if r["discrepancy_pct"] > 0]
    bfsd_i = next(r for r in ii if r["bench"] == "BFSD")
    return {
        "executions": len(dd),
        "zero_discrepancy": zero,
        "avg_discrepancy_pct": float(np.mean([r["discrepancy_pct"]
                                              for r in dd])),
        "max_discrepancy_pct": float(max(r["discrepancy_pct"] for r in dd)),
        "avg_abs_ipc_delta_pct": float(np.mean([abs(r["ipc_delta_pct"])
                                                for r in ii])),
        "bfsd_ipc_gain_pct": bfsd_i["ipc_delta_pct"],
        "bfsd_util_gain_pct": 100.0 * (bfsd_i["util_hanoi"]
                                       - bfsd_i["util_hw"])
        / max(bfsd_i["util_hw"], 1e-9),
        "nonzero_benches": [r["bench"] for r in nonzero],
    }


def hw_cost_rows() -> list[dict]:
    out = []
    for n_bx in (4, 8, 16):
        c = hardware_cost_bytes(MachineConfig(n_threads=32, n_bx=n_bx))
        out.append({"n_bx": n_bx, **c})
    return out


def engine_throughput(n_warps: int = 32, reps: int = 3,
                      device=None) -> dict:
    """The device mechanism vs the numpy mechanism, warps/second.

    Both arms use the same per-warp requests (one randomized memory image
    per warp).  The device arm is one ``run_batch`` call through
    ``hanoi_torch`` (one launch of K1 on ``device``, including result
    materialization — the price a service actually pays), warmed once as
    the reference warms its compile; the numpy arm runs sequentially via
    ``run`` so the ratio stays comparable to the historical
    single-threaded interpreter numbers rather than measuring the
    thread-pool fan-out.
    """
    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=2048)
    bench = next(b for b in make_suite(cfg, datasets=1) if b.name == "GAUS0")
    rng = np.random.default_rng(0)
    reqs = [SimRequest(program=bench.program, cfg=cfg,
                       init_mem=rng.integers(0, 8, size=cfg.mem_size)
                       .astype(np.int32),
                       record_trace=False, name=f"warp{w}")
            for w in range(n_warps)]
    sim = Simulator("hanoi_torch", device=device)

    sim.run_batch(reqs)                                  # build, load, warm
    t0 = time.perf_counter()
    for _ in range(reps):
        sim.run_batch(reqs)
    torch_s = (time.perf_counter() - t0) / reps

    t0 = time.perf_counter()
    for req in reqs:
        sim.run(req, mechanism="hanoi")
    np_s = time.perf_counter() - t0
    return {"n_warps": n_warps,
            "torch_warps_per_s": n_warps / torch_s,
            "numpy_warps_per_s": n_warps / np_s,
            "speedup": np_s / torch_s}


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device hanoi_torch runs on (default: the "
                         "card; 'cpu' runs its plain twin)")
    args = ap.parse_args(argv)
    s = summary(device=args.device)
    print("== Fig 9 (trace discrepancy vs hardware oracle) ==")
    for k, v in s.items():
        print(f"  {k}: {v}")
    print("== SS IX-A hardware cost ==")
    for r in hw_cost_rows():
        print(f"  n_bx={r['n_bx']}: hanoi={r['hanoi_bytes']}B "
              f"simt={r['simt_stack_bytes']}B saving={r['saving_frac']:.1%}")
    print("== engine throughput ==")
    print(f"  {engine_throughput(device=args.device)}")


if __name__ == "__main__":
    main()
