"""Dry-run a single cell and print its headline terms (port of
``examples/dryrun_cell.py``).

Two cell families share this entry point:

* roofline cells — one (arch x shape x mesh) combination through the
  port's dry run (``launch/dryrun.py``: rank 0's step on the meta device
  in a world of fake ranks, scored on one H100).  Needs a fresh process
  (the fake world is started once a process).
* control-flow cells (``--cf-bench NAME``) — one (benchmark x mechanism
  pair) through the port's ``repro_torch.engine`` API: trace discrepancy,
  IPC delta and SIMD utilization for that single cell.  ``hanoi_torch``
  (the default pair's first) runs kernel K1 on the card; ``--device cpu``
  runs its plain twin.

Run:  PYTHONPATH=src python -m repro_torch.examples.dryrun_cell \\
          --arch gemma3-4b --shape decode_32k [--multi-pod]
      PYTHONPATH=src python -m repro_torch.examples.dryrun_cell \\
          --cf-bench BFSD [--cf-mechanisms hanoi_torch,turing_oracle] \\
          [--device cpu]
"""
from __future__ import annotations

import argparse


def run_cf_cell(bench_name: str, mechanisms: list[str], device=None):
    """The (a vs b) row of ``bench_name`` at the paper's config; returns
    it after printing it."""
    from repro_torch.core import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import Simulator

    cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    suite = make_suite(cfg)
    bench = next((b for b in suite if b.name == bench_name), None)
    if bench is None:
        raise SystemExit(f"unknown benchmark {bench_name!r}; available: "
                         + ", ".join(b.name for b in suite))
    a, b = mechanisms
    report = Simulator(device=device).compare(mechanisms, [bench], cfg,
                                              pairs=[(a, b)])
    row = report.pair(a, b)[0]
    print(f"\n[example] control-flow cell {bench_name} x ({a} vs {b})")
    print(f"  status         {row.status_a} / {row.status_b}")
    print(f"  discrepancy    {row.discrepancy_pct:8.2f} %")
    print(f"  ipc            {row.ipc_a:8.3f} vs {row.ipc_b:8.3f} "
          f"({row.ipc_delta_pct:+.1f}%)")
    print(f"  simd util      {row.util_a:8.3f} vs {row.util_b:8.3f}")
    print(f"  trace lengths  {row.trace_len_a} vs {row.trace_len_b}")
    return row


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cf-bench", default=None,
                    help="run a control-flow cell for this benchmark name "
                         "(e.g. BFSD) instead of a roofline cell")
    ap.add_argument("--cf-mechanisms", default="hanoi_torch,turing_oracle",
                    help="comma-separated mechanism pair for --cf-bench")
    ap.add_argument("--device", default=None,
                    help="torch device for --cf-bench (default: the GPU; "
                         "'cpu' for the plain twins)")
    args = ap.parse_args(argv)

    if args.cf_bench:
        mechs = [m.strip() for m in args.cf_mechanisms.split(",")]
        if len(mechs) != 2:
            raise SystemExit("--cf-mechanisms needs exactly two names")
        return run_cf_cell(args.cf_bench, mechs, args.device)

    from repro_torch.launch.dryrun import run_cell
    rec = run_cell(args.arch, args.shape, args.multi_pod)
    if rec["status"] != "ok":
        print(rec)
        return rec
    ro = rec["roofline"]
    print(f"\n[example] {args.arch} x {args.shape} "
          f"({'2x16x16' if args.multi_pod else '16x16'} mesh, one H100 "
          "a rank)")
    print(f"  compute    {ro['compute_s'] * 1e3:9.2f} ms")
    print(f"  memory     {ro['memory_s'] * 1e3:9.2f} ms")
    print(f"  collective {ro['collective_s'] * 1e3:9.2f} ms")
    print(f"  dominant:  {ro['dominant']}")
    print(f"  collectives by kind: {ro['coll_by_kind']}")
    print(f"  useful-FLOP fraction: {rec['useful_flop_frac']:.2f}")
    print(f"  peak {rec['memory']['peak_bytes'] / 1e9:.2f} GB a rank")
    return rec


if __name__ == "__main__":
    main()
