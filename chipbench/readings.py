"""The readings that the correctness limits are set from, on the card at a
cell's own size: for each seed, a short window of the cell's own load and
the check's numbers for the program, and, for the seeds asked, the same
numbers for the control (the plain reference with its weights in fp8 e4m3,
put in the program's place).  Not run by the benchmark's runs.

    python3 chipbench/readings.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 3]

One JSON line a seed on standard output."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chipbench import harness  # noqa: E402


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(ROOT, args.workload)
    loop = harness.load_module("loops", cell.traffic["kind"],
                               ROOT / "chipbench")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = loop.run(cell, seed, args.seconds, False, dev, t_start=t0,
                     root=ROOT, control=seed in control)
        line = json.dumps({
            "workload": args.workload, "seed": seed, "steps": r.steps,
            "correct": r.correct,
            "program": r.readings,
            "control": r.control, "launches": r.launches,
            "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
