"""Render the roofline table from the port's dry run (port of
``benchmarks/roofline.py``).

Usage: python -m repro_torch.benchmarks.roofline
           [--json build/repro_torch/dryrun.json] [--mesh single]

The terms are one rank's on one NVIDIA H100 (``launch/hlo_analysis.py``);
"fits" holds the rank's peak of live bytes (``MemTracker`` on the meta
device) to the card's budget, ``launch/dryrun.py::HBM_BUDGET``.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.dryrun import DEFAULT_OUT, HBM_BUDGET


def fmt_table(results: list[dict], mesh: str = "single") -> str:
    rows = [r for r in results if r.get("mesh") == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = []
    out.append(
        "| arch | shape | mb | compute_s | memory_s | collective_s | "
        "dominant | roofline_bound_s | MODEL_FLOPS/dev | useful_frac | "
        "peak GB | fits |")
    out.append("|---|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r["status"] in ("skipped", "refused"):
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | "
                       f"{r['status']} | - | - | - | - | "
                       f"({r['reason'][:60]}) |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | "
                       f"ERROR | - | - | - | - | {r.get('error', '')[:40]} |")
            continue
        ro = r["roofline"]
        peak = r["memory"]["peak_bytes"]
        fits = "yes" if peak <= HBM_BUDGET else f"NO ({peak / 1e9:.0f}G)"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('microbatches') or '-'} "
            f"| {ro['compute_s'] * 1e3:.1f}ms | {ro['memory_s'] * 1e3:.1f}ms "
            f"| {ro['collective_s'] * 1e3:.1f}ms | {ro['dominant']} "
            f"| {ro['step_time_s'] * 1e3:.1f}ms "
            f"| {r['model_flops_per_dev'] / 1e12:.1f}T "
            f"| {r['useful_flop_frac']:.2f} | {peak / 1e9:.1f} | {fits} |")
    return "\n".join(out)


def _over_compute(r: dict) -> float:
    """A record's roofline bound over its compute term."""
    ro = r["roofline"]
    return ro["step_time_s"] / max(ro["compute_s"], 1e-12)


def summarize(results: list[dict]) -> str:
    ok = [r for r in results if r["status"] == "ok"]
    dominant = {}
    for r in ok:
        d = r["roofline"]["dominant"]
        dominant[d] = dominant.get(d, 0) + 1
    lines = [f"cells ok: {len(ok)}; dominant terms: {dominant}"]
    worst = sorted(
        (r for r in ok if r["shape"] == "train_4k" and r["mesh"] == "single"),
        key=lambda r: -_over_compute(r))
    if worst:
        lines.append("most roofline-distant train cells: " + ", ".join(
            f"{r['arch']} ({_over_compute(r):.1f}x compute)"
            for r in worst[:3]))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        results = json.load(f)
    print(fmt_table(results, args.mesh))
    print()
    print(summarize(results))


if __name__ == "__main__":
    main()
