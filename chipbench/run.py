"""Run one cell of the benchmark once.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for; the last line of standard output is the result (see
``chipbench/harness.py``).  Without them it prints nothing to standard
output and exits 2."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chipbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(root=ROOT, t_start=T_START))
