"""The benchmark's runner: finds a cell and everything it names by name,
runs it once, and prints the result as the last line of standard output.

Discovery (nothing here names a cell, a configuration or a metric):

* the cell: the entry of ``BENCHMARK.json``'s ``workloads`` called
  ``--workload``; its configuration: the ``configs`` entry it names, whose
  ``file`` holds the sizes as run; its traffic:
  ``chipbench/traffic/<traffic>.json``;
* the loop that drives the traffic: ``chipbench/loops/<kind>.py``, ``kind``
  from the traffic file;
* each metric the cell reports (``end_to_end`` with ``--trace 0``,
  ``per_layer`` with ``--trace 1``; a metric with ``workloads`` only in
  those cells): ``chipbench/metrics/<name>.py`` (by the name's part before
  its first dot), whose ``read(run)`` returns a number or ``None`` (nothing
  to read: left out of the line);
* the plain reference: ``chipbench/reference/<reference>.py``, named by the
  configuration.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(kind: str, name: str, root: Path = HERE):
    """``<root>/<kind>/<name>.py`` as a module."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: {path} is missing")
    mod_name = f"chipbench.{kind}.{name}".replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with what it names, read from disk."""
    name: str
    entry: dict
    conf: dict          # the configuration file
    traffic: dict       # the traffic file
    end_to_end: list    # the metric entries this cell reports
    per_layer: list


def find_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((root / "chipbench" / "traffic"
                          / f"{entry['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or workload in m["workloads"]]

    return Cell(workload, entry, conf, traffic, mine(bench["end_to_end"]),
                mine(bench["per_layer"]))


@dataclass
class Run:
    """What one run recorded, for the metric readers and the check.

    Times are host-clock seconds; ``trace`` is the reduced profiler trace
    of a ``--trace 1`` run (:class:`chipbench.trace.Trace`), else None."""
    cell: Cell
    cfg: object                       # the program's ModelConfig as run
    device: object
    seed: int
    setup_s: float = 0.0
    walls: list = field(default_factory=list)       # a step's wall
    enqueue: list = field(default_factory=list)     # call to return
    window_s: float = 0.0
    steps: int = 0
    tokens_per_step: int = 0
    requests_per_step: int = 0
    peak_bytes: int | None = None
    launches: dict = field(default_factory=dict)    # kernel -> per step
    trace: object = None
    checks: dict = field(default_factory=dict)      # name -> (value, limit)
    readings: dict = field(default_factory=dict)    # every number's
    control: dict = field(default_factory=dict)     # the control's numbers
    correct: bool = False


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def reader(metric: str, root: Path = HERE):
    """The reader of a metric: ``metrics/<name>.py`` by the name's part
    before its first dot, so ``prefill_tok_s.rwkv`` (the same quantity in
    other cells, with a bound of its own) reads as ``prefill_tok_s``."""
    return load_module("metrics", metric.split(".")[0], root)


def read_metrics(run: Run, entries: list, root: Path = HERE) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run: Run, metrics: dict, device: dict, breakdown=None) -> str:
    line = {"correct": run.correct,
            "attempted": run.steps * run.requests_per_step,
            "failed": 0, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in run.checks.items()}
    return json.dumps(line)


def execute(workload: str, seed: int, seconds: float, trace: bool, *,
            root: Path, t_start: float, device=None) -> tuple[Run, str]:
    """Run the cell once on ``device`` (the card when None) and return the
    run and its result line.  Raises if the run cannot complete."""
    import torch

    cell = find_cell(root, workload)
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    loop = load_module("loops", cell.traffic["kind"], root / "chipbench")
    run = loop.run(cell, seed, seconds, trace, dev, t_start=t_start,
                   root=root)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = read_metrics(run, entries, root / "chipbench")
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": cell.entry["chips"],
            "memory_peak_bytes": run.peak_bytes}
    breakdown = None
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
        breakdown = run.trace.breakdown()
    return run, result_line(run, metrics, info, breakdown)


def main(argv=None, *, root: Path | None = None,
         t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent if root is None else root

    import torch
    chips = find_cell(root, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run, line = execute(args.workload, args.seed, args.seconds,
                        bool(args.trace), root=root, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"chipbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, value in run.readings.items():
        if name not in run.checks:
            print(f"reading {name} {value!r} (not held)", file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(line, flush=True)
    return 0
