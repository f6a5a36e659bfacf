"""The profiler trace of a few steps, reduced to what the per-layer metrics
read.

Two traced segments of ``n`` steps each, each after one warm-up step:

1. the device's activity alone (kernels, copies, fills): the device
   operations, their busy time (the union of their intervals) and the
   window's length (the host's wall over the segment's steps).  Recording
   the host's operators slows the host by a quarter of a step or more,
   which would show as device idle time in a cell whose host nearly keeps
   pace; this segment leaves them out.
2. the host's operators and the device together: each idle gap between
   device operations named by the innermost host operator open at its
   middle, for the breakdown only.

Each trace is read back from its Chrome-format export, in a temporary
directory (under ``TMPDIR``) that is deleted at once.  Each step is wrapped,
from the benchmark's own code, in a ``chipbench.step`` span; nothing but
the program's prefill and the wait for it runs in a segment, so every
device operation in it is the prefill's.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
STEP_SPAN = "chipbench.step"
TOP = 10


@dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    device_ops: list    # (name, start_s, end_s), in the window, by start
    idle_by_host: dict  # host op open during an idle gap -> seconds

    def ops_matching(self, pattern: str) -> tuple[int, float]:
        """(count, seconds) of the device ops whose name matches."""
        rx = re.compile(pattern)
        hits = [e - s for n, s, e in self.device_ops if rx.search(n)]
        return len(hits), sum(hits)

    def breakdown(self) -> dict:
        by_name: dict = {}
        for n, s, e in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _profile(step, n: int, sync, activities) -> tuple[list, float]:
    """(trace events, host seconds over the traced steps) of ``n`` calls of
    ``step(i)`` after one untraced warm-up call, each followed by
    ``sync()``."""
    from torch.profiler import profile, record_function, schedule

    with tempfile.TemporaryDirectory(prefix="chipbench-") as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=n,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) \
                as prof:
            for i in range(n + 1):
                if i == 1:
                    t0 = time.perf_counter()
                with record_function(STEP_SPAN):
                    step(i)
                    sync()
                # the last step's prof.step() exports the trace: not timed
                wall = time.perf_counter() - t0 if i else 0.0
                prof.step()
        with open(path) as f:
            return json.load(f)["traceEvents"], wall


def capture(step, n: int, sync) -> Trace:
    """The two traced segments of ``n`` steps of ``step(i)``."""
    import torch
    from torch.profiler import ProfilerActivity

    # the CPU tests have no device to trace: they trace the host twice
    first = ProfilerActivity.CUDA if torch.cuda.is_available() \
        else ProfilerActivity.CPU
    events, wall = _profile(step, n, sync, [first])
    dev = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda x: x[1])
    busy, _ = _union(dev, dev[0][1] if dev else 0.0,
                     dev[-1][2] if dev else 0.0)
    events, _ = _profile(lambda i: step(n + 1 + i), n, sync,
                         [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    us = 1e-6
    return Trace(steps=n, window_s=wall, busy_s=busy * us,
                 device_ops=[(name, s * us, t * us) for name, s, t in dev],
                 idle_by_host={k: v * us
                               for k, v in host_gaps(events).items()})


def _union(dev: list, w0: float, w1: float) -> tuple[float, list]:
    """(busy time, idle gaps) of device intervals (name, start, end),
    sorted by start, within [w0, w1]."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    last_end = w0
    for _, s, t in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
        last_end = max(last_end, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    return busy, gaps


def host_gaps(events: list) -> dict:
    """The device's idle gaps within the steps' spans (us), by the innermost
    host operator open at each gap's middle on the thread that ran the
    steps."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == STEP_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no {STEP_SPAN} span in the trace")
    w0 = min(e["ts"] for e in spans)
    w1 = max(e["ts"] + e["dur"] for e in spans)
    tid = spans[0]["tid"]
    dev = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                 key=lambda x: x[1])
    _, gaps = _union(dev, w0, w1)
    ops = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("tid") == tid and e["ts"] < w1
                  and e["ts"] + e["dur"] > w0),
                 key=lambda o: (o[0], -o[1]))
    starts = [o[0] for o in ops]
    out: dict = {}
    stack: list = []
    k = 0
    for a, b in gaps:
        mid = (a + b) / 2
        k2 = bisect.bisect_right(starts, mid)
        for o in ops[k:k2]:
            while stack and stack[-1][1] <= o[0]:
                stack.pop()
            stack.append(o)
        k = k2
        while stack and stack[-1][1] <= mid:
            stack.pop()
        name = stack[-1][2] if stack else "(no host op)"
        out[name] = out.get(name, 0.0) + (b - a)
    return out
