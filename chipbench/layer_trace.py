"""Segments 3 and 4 of a ``--trace 1`` run: the program's own spans and
counters (``repro_torch.tracing``), which put a step's device work, the
device's idle time and the host's time down to the layer that caused it.

3. The profiler with the host's and the device's activity, the program's
   spans on (each also a ``record_function`` range in the trace) and its
   counters off.  Each device operation is put down to the program spans
   open at its launch: the ``cuda_runtime`` or ``cuda_driver`` event of
   the same ``correlation`` id on the thread that ran the steps.  Each
   idle gap between device operations inside the steps' spans is put down
   to the program spans open at its middle (the rule of
   :func:`chipbench.trace.host_gaps`); a gap with none open counts in none.
4. No profiler; spans and counters on: the host's wall a step in each span,
   and the counters.  Each traced step is followed by one with tracing off:
   the two calls' walls give the cost of tracing on.

Segment 3 runs ``STEPS_3`` steps and segment 4 ``trace_steps`` pairs, each
after one untraced warm-up step.  Segment 3 is short because its cost grows
with the trace: 8 steps of deepseek-moe-16b at 16 x 512 (1.27 M events)
took 36 s to profile, export and read back on an H100's host, where the
per-step counts it reads repeat exactly from step to step.
Both run after the check, the first time a reader asks (:func:`of`), on the
cell's model and prompts drawn again from the run's seed: the run keeps
neither.  The program's tracing is off in the window and in segments 1
and 2.  A program without ``repro_torch.tracing`` gives nothing to read.
"""
from __future__ import annotations

import bisect
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass

from chipbench import harness, trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEPS_3 = 2


@dataclass
class LayerTrace:
    steps: int          # segment 4's traced steps
    steps_3: int        # segment 3's steps
    names: tuple        # the program's span names (``tracing.SPANS``)
    busy_s: float       # segment 3: the union of the device operations
    idle_s: float       # segment 3: idle time inside the steps' spans
    device: dict        # segment 3: span path -> [operations, seconds]
    kernels: dict       # segment 3: span path -> {op name: seconds}
    idle: dict          # segment 3: span path -> idle seconds
    host_ns: dict       # segment 4: span name -> wall ns over the steps
    prefill_ms: list    # segment 4: each ``prefill`` span's wall
    n_spans: int        # segment 4: spans over the steps
    counters: dict      # segment 4
    call_ms: tuple      # segment 4: the calls' walls, ms: (traced, off)
    seconds: tuple      # the walls of segments 3 and 4

    def device_in(self, *names) -> tuple[int, float]:
        """(operations, seconds) launched with any of ``names`` open."""
        hits = [v for path, v in self.device.items()
                if any(n in path for n in names)]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def idle_in(self, *names) -> float:
        return sum(s for path, s in self.idle.items()
                   if any(n in path for n in names))

    def opened(self, name: str) -> bool:
        """Whether the program's span ``name`` opened (segment 4)."""
        return name in self.names and name in self.host_ns


def paths(spans: list, times: list) -> list[tuple]:
    """For each time (sorted or not), the names of the spans (start, end,
    name), properly nested, open at it, outermost first."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    out = [()] * len(times)
    stack: list = []
    k = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        k2 = bisect.bisect_right(starts, t)
        for s in spans[k:k2]:
            while stack and stack[-1][1] <= s[0]:
                stack.pop()
            stack.append(s)
        k = max(k, k2)
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[i] = tuple(s[2] for s in stack)
    return out


def attribute(events: list, names) -> dict:
    """Segment 3's reading of Chrome trace events: ``steps_3``,
    ``busy_s``, ``idle_s``, ``device``, ``kernels`` and ``idle`` (as
    :class:`LayerTrace` holds them, in seconds) for the program spans
    ``names``."""
    x = [e for e in events if e.get("ph") == "X"]
    steps = [e for e in x if e.get("name") == trace.STEP_SPAN
             and e.get("cat") == "user_annotation"]
    if not steps:
        raise ValueError(f"no {trace.STEP_SPAN} span in the trace")
    tid = steps[0]["tid"]
    w0 = min(e["ts"] for e in steps)
    w1 = max(e["ts"] + e["dur"] for e in steps)
    prog = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in x
            if e.get("cat") == "user_annotation" and e["name"] in names
            and e.get("tid") == tid]
    launch = {e["args"]["correlation"]: e["ts"] + e["dur"] / 2 for e in x
              if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid
              and "correlation" in e.get("args", {})}
    dev = sorted((e for e in x if e.get("cat") in trace.DEVICE_CATS),
                 key=lambda e: e["ts"])
    at = [launch.get(e.get("args", {}).get("correlation")) for e in dev]
    found = [i for i, t in enumerate(at) if t is not None]
    launched = paths(prog, [at[i] for i in found])
    by_op = [()] * len(dev)
    for i, p in zip(found, launched):
        by_op[i] = p
    device: dict = {}
    kernels: dict = {}
    for e, p in zip(dev, by_op):
        v = device.setdefault(p, [0, 0.0])
        v[0] += 1
        v[1] += e["dur"] * 1e-6
        k = kernels.setdefault(p, {})
        k[e["name"]] = k.get(e["name"], 0.0) + e["dur"] * 1e-6
    intervals = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy, _ = trace._union(intervals, intervals[0][1] if dev else 0.0,
                           intervals[-1][2] if dev else 0.0)
    _, gaps = trace._union(intervals, w0, w1)
    idle: dict = {}
    for (a, b), p in zip(gaps, paths(prog, [(a + b) / 2 for a, b in gaps])):
        idle[p] = idle.get(p, 0.0) + (b - a) * 1e-6
    return {"steps_3": len(steps), "busy_s": busy * 1e-6,
            "idle_s": sum(idle.values()),
            "device": device, "kernels": kernels, "idle": idle}


def capture(tracing, step, n: int, sync) -> LayerTrace:
    """Segment 3 (``STEPS_3`` steps of ``step(i)``) and segment 4 (``n``
    pairs), ``tracing`` the program's tracing module."""
    from torch.profiler import ProfilerActivity

    t0 = time.perf_counter()
    with tracing.recording(spans=True, counters=False):
        events, _ = trace._profile(
            step, STEPS_3, sync,
            [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    seg3 = attribute(events, tracing.SPANS)
    events = None
    t1 = time.perf_counter()
    step(STEPS_3 + 1)
    sync()
    call_ms: tuple = ([], [])

    def timed(i, walls):
        a = time.perf_counter()
        step(i)
        walls.append(1e3 * (time.perf_counter() - a))
        sync()

    spans: list = []
    counters: dict = {}
    for i in range(n):
        with tracing.recording(spans=True, counters=True) as rec:
            timed(STEPS_3 + 2 + 2 * i, call_ms[0])
        timed(STEPS_3 + 3 + 2 * i, call_ms[1])
        spans += rec.spans
        for k, v in rec.counters.items():
            counters[k] = counters.get(k, 0) + v
    host_ns: dict = {}
    for s in spans:
        host_ns[s.name] = host_ns.get(s.name, 0) + s.t1_ns - s.t0_ns
    prefill_ms = [1e-6 * (s.t1_ns - s.t0_ns) for s in spans
                  if s.name == "prefill"]
    return LayerTrace(steps=n, names=tuple(tracing.SPANS), host_ns=host_ns,
                      prefill_ms=prefill_ms, n_spans=len(spans),
                      counters=counters, call_ms=call_ms,
                      seconds=(t1 - t0, time.perf_counter() - t1), **seg3)


def _program_tracing():
    """The program's tracing module, or None where it has none."""
    if importlib.util.find_spec("repro_torch.tracing") is None:
        return None
    return importlib.import_module("repro_torch.tracing")


def of(run) -> LayerTrace | None:
    """Segments 3 and 4 of ``run`` (a ``--trace 1`` run), made once;
    None in a run without a trace or on a program without tracing."""
    if run.trace is None:
        return None
    if "layer_trace" in vars(run):
        return run.layer_trace
    tracing = _program_tracing()
    run.layer_trace = None if tracing is None else _capture_run(run, tracing)
    return run.layer_trace


def _capture_run(run, tracing) -> LayerTrace:
    import torch

    from repro_torch.launch.steps import prefill

    t = time.perf_counter()
    cell, dev = run.cell, run.device
    loop = harness.load_module("loops", cell.traffic["kind"])
    gc.collect()
    cfg, model, _, pool = loop.setup(cell, run.seed, dev)
    P, n = pool.shape[0], cell.traffic["trace_steps"]
    first = run.steps + 2 * (n + 1)     # after segments 1 and 2's prompts

    def step(i):
        return prefill(model, cfg, {"tokens": pool[(first + i) % P]})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    lt = capture(tracing, step, n, sync)
    report(lt, 1e3 * statistics.fmean(run.enqueue), time.perf_counter() - t)
    return lt


def report(lt: LayerTrace, enqueue_ms: float, seconds: float) -> None:
    """Segments 3 and 4 on standard error, for the records: a line of
    totals, then one JSON line by span path (operations and device ms a
    step launched in it, its top operations, idle ms a step) and by span
    (host ms a step)."""
    n, n3 = lt.steps, lt.steps_3
    on, off, span = (statistics.fmean(w) if w else float("nan")
                     for w in (*lt.call_ms, lt.prefill_ms))
    on_mid, off_mid = (statistics.median(w) if w else float("nan")
                       for w in lt.call_ms)
    print(f"layer trace: {seconds:.1f} s with the set-up (segment 3, the "
          f"profile and its reading, {lt.seconds[0]:.1f} s; segment 4 "
          f"{lt.seconds[1]:.1f} s); {lt.n_spans / n:.1f} spans a step; "
          f"segment 3 {sum(v[0] for v in lt.device.values()) / n3:.1f} "
          f"device ops a step, busy {lt.busy_s:.4f} s, idle "
          f"{lt.idle_s:.4f} s; segment 4 prefill span ms mean "
          f"{span:.2f}, calls ms mean traced {on:.2f} off {off:.2f}, "
          f"median traced {on_mid:.2f} off {off_mid:.2f} (window enqueue "
          f"ms mean {enqueue_ms:.2f}); counters {lt.counters}",
          file=sys.stderr)
    paths = sorted(lt.device, key=lambda p: -lt.device[p][1])
    detail = {
        "device_a_step": {"/".join(p): [lt.device[p][0] / n3,
                                        1e3 * lt.device[p][1] / n3]
                          for p in paths},
        "top_ops_ms": {"/".join(p): sorted(
            ([k[:100], 1e3 * v / n3] for k, v in lt.kernels[p].items()),
            key=lambda kv: -kv[1])[:3] for p in paths[:12]},
        "idle_ms_a_step": {"/".join(p): 1e3 * v / n3 for p, v in
                           sorted(lt.idle.items(), key=lambda kv: -kv[1])},
        "host_ms_a_step": {k: 1e-6 * v / n for k, v in lt.host_ns.items()},
    }
    print(f"layer trace detail: {json.dumps(detail)}", file=sys.stderr)
