"""Segments 3 and 4 of a traced run (``chipbench/layer_trace.py``) on the
CPU: device operations put down to the program spans open at their launch,
idle gaps to those open at their middle, on hand-built Chrome events; a
traced smoke run keeps its breakdown and every new reader gives a number
or nothing; a program without tracing gives nothing to read."""
from __future__ import annotations

import json
import time

import pytest

from chipbench import harness, layer_trace, trace
from chipbench.tests.smoke_root import make_root

LIMITS = {"gap_mean": 10.0, "cache_err_first": 1.0}
NEW = ("moe_host_ms", "moe_launches_per_step", "moe_routing_time_pct",
       "moe_drop_pct", "idle_in_moe_pct", "cache_stack_pct",
       "cache_stack_pct.rwkv")
SPANS = ("prefill", "attention", "moe", "moe.dispatch")
STEP, DISPATCH, MOE_SELF, ATTN = (("prefill",), ("prefill", "moe",
                                  "moe.dispatch"), ("prefill", "moe"),
                                  ("prefill", "attention"))


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _events():
    """One step [0, 100) on thread 1: prefill [1, 90) holding moe [10, 50)
    (with moe.dispatch [20, 40)) and attention [60, 80).  Kernels launched
    in moe.dispatch (1), in moe's own time (2), in attention (3), after
    prefill (4) and from thread 2 inside moe's time (5)."""
    ev = [_x(trace.STEP_SPAN, "user_annotation", 0, 100),
          _x("prefill", "user_annotation", 1, 89),
          _x("moe", "user_annotation", 10, 40),
          _x("moe.dispatch", "user_annotation", 20, 20),
          _x("attention", "user_annotation", 60, 20),
          _x("not.a.program.span", "user_annotation", 21, 2),
          _x("moe.dispatch", "gpu_user_annotation", 0, 100, tid=7),
          _x("aten::sort", "cpu_op", 24, 3)]
    launches = [(1, 25, "cudaLaunchKernel", 1), (2, 45, "cudaLaunchKernel", 1),
                (3, 65, "cuLaunchKernelEx", 1), (4, 92, "cudaLaunchKernel", 1),
                (5, 30, "cudaLaunchKernel", 2)]
    cat = {"cuLaunchKernelEx": "cuda_driver"}
    for corr, ts, name, tid in launches:
        ev.append(_x(name, cat.get(name, "cuda_runtime"), ts, 2, tid=tid,
                     correlation=corr))
    # kernel corr: [start, end) on the device
    for corr, s, e in [(1, 28, 33), (2, 47, 50), (3, 70, 80), (4, 93, 95),
                       (5, 33, 36)]:
        ev.append(_x(f"k{corr}", "kernel", s, e - s, tid=9, correlation=corr))
    ev.append(_x("Memset", "gpu_memset", 50, 2, tid=9, correlation=2))
    return ev


def _layer_trace(seg3):
    return layer_trace.LayerTrace(
        steps=1, names=SPANS, host_ns={}, prefill_ms=[], n_spans=0,
        counters={}, call_ms=([], []), seconds=(0.0, 0.0), **seg3)


def test_device_ops_go_to_the_spans_open_at_their_launch():
    got = layer_trace.attribute(_events(), SPANS)
    dev = {p: (n, round(s * 1e6, 6)) for p, (n, s) in got["device"].items()}
    assert dev == {DISPATCH: (1, 5.0), MOE_SELF: (2, 5.0), ATTN: (1, 10.0),
                   (): (2, 5.0)}
    lt = _layer_trace(got)
    assert lt.device_in("moe.dispatch")[0] == 1
    assert lt.device_in("moe")[0] == 3          # moe.dispatch's and its own
    assert lt.device_in("attention")[0] == 1
    assert got["kernels"][MOE_SELF] == {"k2": pytest.approx(3e-6),
                                        "Memset": pytest.approx(2e-6)}
    # busy: [28, 36), [47, 52), [70, 80), [93, 95)
    assert got["busy_s"] == pytest.approx(25e-6) and got["steps_3"] == 1


def test_idle_gaps_go_to_the_program_spans_open_at_their_middle():
    got = layer_trace.attribute(_events(), SPANS)
    idle = {p: round(s * 1e6, 6) for p, s in got["idle"].items()}
    # gaps in [0, 100): [0, 28) mid 14 in moe; [36, 47) mid 41.5 in moe;
    # [52, 70) mid 61 in attention; [80, 93) mid 86.5 in prefill alone;
    # [95, 100) mid 97.5 in no program span
    assert idle == {MOE_SELF: 28.0 + 11.0, ATTN: 18.0, STEP: 13.0, (): 5.0}
    assert got["idle_s"] == pytest.approx(75e-6)
    lt = _layer_trace(got)
    assert lt.idle_in("moe") == pytest.approx(39e-6)


def test_paths_nest_and_close():
    spans = [(0, 10, "a"), (2, 5, "b"), (5, 8, "c"), (12, 20, "d")]
    assert layer_trace.paths(spans, [9, 3, 5, 11, 0, 19, 20]) == [
        ("a",), ("a", "b"), ("a", "c"), (), ("a",), ("d",), ()]


def _smoke_root(tmp_path):
    """The smoke root with the new metrics reported in its cells too."""
    root = make_root(tmp_path, LIMITS)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("rwkv6-3b.smoke" if m["name"].endswith(
                ".rwkv") else "deepseek-moe-16b.smoke")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, workload):
    return harness.execute(workload, 2 ** 31 + 23, 0.2, True, root=root,
                           t_start=time.perf_counter(), device="cpu")


def test_new_metrics_are_in_the_benchmark():
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for m in bench["per_layer"][-len(NEW):]:
        assert m["source"] in ("host_clock", "device_trace")
        assert all(w.startswith("rwkv6-3b." if m["name"].endswith(".rwkv")
                                else "deepseek-moe-16b.")
                   for w in m["workloads"])


@pytest.mark.parametrize("workload", ["deepseek-moe-16b.smoke",
                                      "rwkv6-3b.smoke"])
def test_traced_smoke_run_keeps_its_breakdown_and_reads_new_metrics(
        tmp_path, workload):
    """On the CPU the profiler sees no device operation: the device-trace
    readers give nothing, the host-clock ones a number in the MoE cell."""
    root = _smoke_root(tmp_path)
    run, line = _run(root, workload)
    out = json.loads(line)
    assert out["correct"] is True
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    values = {m: harness.reader(m, root / "chipbench").read(run) for m in NEW}
    for v in values.values():
        assert v is None or isinstance(v, float)
    lt = run.layer_trace
    assert lt.busy_s == 0.0 and not lt.device
    moe = workload.startswith("deepseek")
    reported = {k for k, v in values.items() if v is not None}
    assert reported == ({"moe_host_ms", "moe_drop_pct"} if moe else set())
    assert set(out["metrics"]) == reported
    t = run.cell.traffic
    cfg = run.cfg
    G, T, k = t["batch"], t["seq"], cfg.experts_per_token
    n_moe = cfg.n_layers - cfg.first_dense_layers if moe else 0
    assert lt.counters.get("moe.slots", 0) == lt.steps * n_moe * G * T * k
    assert len(lt.prefill_ms) == lt.steps == t["trace_steps"]
    assert lt.steps_3 == layer_trace.STEPS_3
    assert [len(w) for w in lt.call_ms] == [lt.steps, lt.steps]
    # a smoke step: prefill, embed, head, a cache_stack a segment and the
    # layers' spans (deepseek: 3 attention, 1 mlp, 2 moe of 6 spans each)
    assert lt.n_spans == lt.steps * (21 if moe else 8)


def test_a_program_without_tracing_gives_nothing(tmp_path, monkeypatch):
    root = _smoke_root(tmp_path)
    monkeypatch.setattr(layer_trace, "_program_tracing", lambda: None)
    run, line = _run(root, "deepseek-moe-16b.smoke")
    assert run.layer_trace is None
    assert not set(json.loads(line)["metrics"]) & set(NEW)
    assert all(harness.reader(m, root / "chipbench").read(run) is None
               for m in NEW)


def test_program_tracing_is_found_by_name(monkeypatch):
    assert layer_trace._program_tracing().SPANS
    found = layer_trace.importlib.util.find_spec
    monkeypatch.setattr(layer_trace.importlib.util, "find_spec",
                        lambda name: None if name == "repro_torch.tracing"
                        else found(name))
    assert layer_trace._program_tracing() is None
