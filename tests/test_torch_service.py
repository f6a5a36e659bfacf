"""The port's simulation service (``repro_torch.service``) against the JAX
package's (``repro.service``): the counterpart of every case of
``tests/test_service.py``, the service cases of ``tests/test_analysis.py``
and ``tests/test_transform.py``, and the service stats parity of
``tests/test_sm_jax.py``.

The port's service runs with ``device="cpu"``: ``hanoi_torch`` and
``sm_torch`` run the plain twins of K1 and K2.  Where a case compares with
the reference, the same requests go through ``repro.service`` with
``hanoi_torch`` mapped to ``hanoi_jax`` and ``sm_torch`` to ``sm_jax``;
every comparison is equality (traces, registers, memories, counters and the
service's deterministic stats are integers).  The machine with the card has
no JAX: there this module skips.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro import engine as jengine                                # noqa: E402
from repro import service as jservice                              # noqa: E402
from repro.analysis import StaticAnalysisError as JStaticError     # noqa: E402
from repro.core import programs as jprograms                       # noqa: E402
from repro.core.asm import assemble as jassemble                   # noqa: E402
from repro.core.isa import MachineConfig as JCfg                   # noqa: E402
from repro_torch.analysis import StaticAnalysisError               # noqa: E402
from repro_torch.core import MachineConfig                         # noqa: E402
from repro_torch.core import programs as P                         # noqa: E402
from repro_torch.core.asm import assemble                          # noqa: E402
from repro_torch.core.programs import make_suite                   # noqa: E402
from repro_torch.engine import (RotatingJsonlSink, SimRequest,     # noqa: E402
                                Simulator, as_request, feed_result,
                                get_mechanism, iter_mechanisms,
                                register_mechanism, unregister_mechanism)
from repro_torch.engine.mechanisms.sm import (DEFAULT_WARPS,       # noqa: E402
                                              per_warp_programs, warp_count)
from repro_torch.service import (BatchCoalescer, SimulationService,  # noqa
                                 execute_plan, plan_dispatch, signature_of)

CFG = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
JCFG = JCfg(n_threads=8, mem_size=64, max_steps=8192)
W8 = MachineConfig(n_threads=8)
JW8 = JCfg(n_threads=8)
W4 = MachineConfig(n_threads=4)
JW4 = JCfg(n_threads=4)
SUITE = make_suite(CFG, datasets=1)
JSUITE = jprograms.make_suite(JCFG, datasets=1)
SIM = Simulator("hanoi", device="cpu")
CPU = "cpu"
# the port's torch mechanisms and the reference's JAX ones they stand for
TO_REF = {"hanoi_torch": "hanoi_jax", "sm_torch": "sm_jax"}


def _bench(name, suite=SUITE):
    return next(b for b in suite if b.name == name)


def _jbench(name):
    return _bench(name, JSUITE)


def _same_outcome(a, b):
    """status / final regs / preds / mem / fuel / steps / trace equality."""
    assert a.status.value == b.status.value
    assert a.fuel_left == b.fuel_left
    assert a.finished == b.finished
    assert a.steps == b.steps
    assert a.error == b.error
    np.testing.assert_array_equal(a.regs, b.regs)
    np.testing.assert_array_equal(a.preds, b.preds)
    np.testing.assert_array_equal(a.mem, b.mem)
    assert a.trace == b.trace
    assert a.utilization == b.utilization


def _same_sm(a, b):
    assert a.sm_trace == b.sm_trace
    assert a.cycles == b.cycles
    assert a.stall_breakdown == b.stall_breakdown
    assert a.status.value == b.status.value
    for wa, wb in zip(a.warps, b.warps, strict=True):
        _same_outcome(wa, wb)


def _deterministic(stats):
    return (stats.submitted, stats.completed, stats.failed, stats.rejected,
            stats.batches, stats.native_batches, stats.native_warps,
            stats.sm_jobs, stats.flush_size, stats.flush_manual,
            stats.batch_fill, stats.inflight)


def _service(**kw):
    kw.setdefault("default_mechanism", "hanoi")
    return SimulationService(device=CPU, **kw)


# ---------------------------------------------------------------------------
# the service's device
# ---------------------------------------------------------------------------

def test_service_defaults_to_the_card():
    """``SimulationService()`` serves ``hanoi_torch`` on the card and raises
    without one, naming ``device``; ``device="cpu"`` goes into every
    admitted request's meta, as the Simulator stamps it."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimulationService()
    seen = []

    @register_mechanism("tmp_svc_device_probe", backend="numpy")
    def _probe(req):
        seen.append(req.meta.get("device"))
        return SIM.run(req)

    try:
        with SimulationService(device=CPU) as svc:
            assert svc._default == "hanoi_torch"
            out = svc.run([_bench("DIAMOND")] * 2, CFG,
                          mechanism="tmp_svc_device_probe")
            res = svc.run([_bench("DIAMOND")], CFG,
                          meta={"device": "cpu"})[0]
    finally:
        unregister_mechanism("tmp_svc_device_probe")
    assert seen == ["cpu", "cpu"] and all(r.ok for r in out)
    assert res.mechanism == "hanoi_torch"
    _same_outcome(res, SIM.run(_bench("DIAMOND"), CFG))


# ---------------------------------------------------------------------------
# execution signatures
# ---------------------------------------------------------------------------

def test_signature_groups_compatible_requests():
    a = signature_of("hanoi_torch", as_request(_bench("DIAMOND"), CFG))
    b = signature_of("hanoi_torch", as_request(_bench("GAUS0"), CFG))
    assert a == b and hash(a) == hash(b)
    assert a.batchable
    ref = jservice.signature_of("hanoi_jax",
                                jengine.as_request(_jbench("DIAMOND"), JCFG))
    assert a.key.replace("hanoi_torch", "hanoi_jax") == ref.key
    assert a.token.replace("hanoi_torch", "hanoi_jax") == ref.token


@pytest.mark.parametrize("override,field", [
    (dict(fuel=17), "cfg"),                      # fuel folds into the cfg
    (dict(cfg=CFG._replace(n_threads=4)), "cfg"),
    (dict(majority_first=False), "majority_first"),
    (dict(active0=0b0011), "batchable"),
    (dict(record_trace=False), "record_trace"),
    (dict(bsync_skip_pcs=(3,)), "skip_pcs"),
    (dict(meta={"itps_patience": 1}), "meta"),
    (dict(meta={"device": "cpu"}), "meta"),
])
def test_signature_splits_on(override, field):
    base = signature_of("hanoi", as_request(_bench("DIAMOND"), CFG))
    cfg = override.pop("cfg", CFG)
    changed = signature_of("hanoi", as_request(_bench("DIAMOND"), cfg,
                                               **override))
    assert base != changed
    assert getattr(base, field) != getattr(changed, field)
    jcfg = JCFG._replace(n_threads=cfg.n_threads)
    jbase = jservice.signature_of("hanoi",
                                  jengine.as_request(_jbench("DIAMOND"), JCFG))
    jchanged = jservice.signature_of("hanoi", jengine.as_request(
        _jbench("DIAMOND"), jcfg, **override))
    assert (base.key, changed.key) == (jbase.key, jchanged.key)


def test_signature_pad_class():
    short = signature_of("hanoi_torch", as_request(
        np.asarray(_bench("DIAMOND").program), CFG))
    assert short.pad_len % 32 == 0
    long_prog = np.concatenate([_bench("DIAMOND").program] * 8, axis=0)
    longer = signature_of("hanoi_torch", as_request(long_prog, CFG))
    assert longer.pad_len > short.pad_len
    ref = jservice.signature_of("hanoi_jax", jengine.as_request(
        np.concatenate([_jbench("DIAMOND").program] * 8, axis=0), JCFG))
    assert longer.pad_len == ref.pad_len


# ---------------------------------------------------------------------------
# coalescer flush rules (pure bookkeeping, fake clock), beside the reference
# ---------------------------------------------------------------------------

def _coalescers(**kw):
    now = [0.0]
    clock = (lambda: now[0])
    return now, BatchCoalescer(clock=clock, **kw), \
        jservice.BatchCoalescer(clock=clock, **kw)


def _sigs(*mechs):
    return ([signature_of(m, as_request(_bench("DIAMOND"), CFG))
             for m in mechs],
            [jservice.signature_of(m, jengine.as_request(_jbench("DIAMOND"),
                                                         JCFG))
             for m in mechs])


def test_coalescer_size_flush():
    _, c, jc = _coalescers(max_batch=3, max_wait_s=10.0)
    [sig], [jsig] = _sigs("hanoi")
    for cc, s in ((c, sig), (jc, jsig)):
        assert cc.add(s, "a") == (None, True)
        assert cc.add(s, "b") == (None, False)
        full, created = cc.add(s, "c")
        assert not created
        assert full is not None and full.cause == "size"
        assert [e.payload for e in full.entries] == ["a", "b", "c"]
        assert cc.depth() == 0


def test_coalescer_deadline_flush_only_when_due():
    now, c, jc = _coalescers(max_batch=64, max_wait_s=0.5)
    now[0] = 100.0
    (sa, sb), (ja, jb) = _sigs("hanoi", "simt_stack")
    for cc, a, b in ((c, sa, sb), (jc, ja, jb)):
        now[0] = 100.0
        cc.add(a, "a1")
        now[0] = 100.3
        cc.add(b, "b1")
        assert cc.due() == []
        assert cc.next_deadline() == pytest.approx(100.5)
        now[0] = 100.6
        due = cc.due()
        assert [g.signature for g in due] == [a]
        assert due[0].cause == "deadline"
        assert cc.depth() == 1
        now[0] = 101.0
        assert [g.signature for g in cc.due()] == [b]


def test_coalescer_manual_flush_and_validation():
    c = BatchCoalescer(max_batch=4, max_wait_s=60.0)
    [sig], _ = _sigs("hanoi")
    c.add(sig, "x")
    groups = c.flush_all()
    assert len(groups) == 1 and groups[0].cause == "manual"
    assert c.depth() == 0 and c.next_deadline() is None
    for kw in (dict(max_batch=0), dict(max_wait_s=-1)):
        with pytest.raises(ValueError):
            BatchCoalescer(**kw)
        with pytest.raises(ValueError):
            jservice.BatchCoalescer(**kw)


# ---------------------------------------------------------------------------
# planner: the shared dispatch path
# ---------------------------------------------------------------------------

def test_plan_routes_homogeneous_subgroups_natively():
    def plan(mod, mech, reqs):
        return [(g.indices, g.native) for g in mod(mech, reqs)]

    mine = [as_request(_bench("DIAMOND"), CFG),
            as_request(_bench("GAUS0"), CFG),
            as_request(_bench("DIAMOND"), CFG, fuel=64),
            as_request(_bench("DIAMOND"), CFG, active0=0b1)]
    ref = [jengine.as_request(_jbench("DIAMOND"), JCFG),
           jengine.as_request(_jbench("GAUS0"), JCFG),
           jengine.as_request(_jbench("DIAMOND"), JCFG, fuel=64),
           jengine.as_request(_jbench("DIAMOND"), JCFG, active0=0b1)]
    got = plan(plan_dispatch, get_mechanism("hanoi_torch"), mine)
    want = plan(jservice.plan_dispatch,
                jengine.get_mechanism("hanoi_jax"), ref)
    assert got == want
    routed = {i: n for idx, n in got for i in idx}
    assert routed == {0: True, 1: True, 2: True, 3: False}


def test_execute_plan_preserves_order_and_matches_singles():
    names = ["HOTS0", "GAUS0", "RBFS0", "DIAMOND"]
    reqs = [as_request(_bench(n), CFG) for n in names]
    out = execute_plan(get_mechanism("hanoi"), reqs)
    ref = jservice.execute_plan(jengine.get_mechanism("hanoi"),
                                [jengine.as_request(_jbench(n), JCFG)
                                 for n in names])
    for req, res, r in zip(reqs, out, ref):
        _same_outcome(res, SIM.run(req))
        _same_outcome(res, r)


def test_run_batch_mixed_batch_still_uses_native_groups():
    reqs = [as_request(_bench("DIAMOND"), CFG, meta={"device": CPU}),
            as_request(_bench("GAUS0"), CFG, meta={"device": CPU}),
            as_request(_bench("DIAMOND"), CFG, fuel=64,
                       meta={"device": CPU})]
    plan = plan_dispatch(get_mechanism("hanoi_torch"), reqs)
    assert all(g.native for g in plan) and len(plan) == 2
    out = SIM.run_batch(reqs, mechanism="hanoi_torch")
    for req, res in zip(reqs, out):
        _same_outcome(res, SIM.run(req, mechanism="hanoi_torch"))
        _same_outcome(res, SIM.run(req))


# ---------------------------------------------------------------------------
# service: equivalence across every registered mechanism
# ---------------------------------------------------------------------------

def test_service_matches_reference_service_for_every_mechanism():
    """Every port mechanism through the port's service equals the
    reference service's result for the same request (``hanoi_torch`` held
    to ``hanoi_jax``, ``sm_torch`` to ``sm_jax``) and the port's own
    per-request run."""
    mechs = [m.name for m in iter_mechanisms()]
    assert len(mechs) >= 8
    with _service(max_batch=8, max_wait_s=0.01, workers=2) as svc:
        tickets = [(n, svc.submit(_bench("DIAMOND"), CFG, mechanism=n))
                   for n in mechs]
        svc.flush()
        mine = {n: t.result(120) for n, t in tickets}
    with jservice.SimulationService(default_mechanism="hanoi", max_batch=8,
                                    max_wait_s=0.01, workers=2) as jsvc:
        tickets = [(n, jsvc.submit(_jbench("DIAMOND"), JCFG,
                                   mechanism=TO_REF.get(n, n)))
                   for n in mechs]
        jsvc.flush()
        ref = {n: t.result(300) for n, t in tickets}
    for n in mechs:
        assert mine[n].mechanism == n
        _same_outcome(mine[n], ref[n])
        _same_outcome(mine[n], Simulator(device=CPU).run(
            _bench("DIAMOND"), CFG, mechanism=n))


# ---------------------------------------------------------------------------
# service: the mixed batch, its order and its deterministic stats
# ---------------------------------------------------------------------------

def _mixed_jobs(mod_bench, cfg, small, torch_name):
    return [(torch_name, mod_bench("DIAMOND"), cfg),
            ("hanoi", mod_bench("GAUS0"), cfg),
            (torch_name, mod_bench("GAUS0"), cfg),
            ("simt_stack", mod_bench("HOTS0"), cfg),
            (torch_name, mod_bench("RBFS0"), small),      # other cfg
            ("volta_itps", mod_bench("DIAMOND"), cfg),
            (torch_name, mod_bench("HOTS0"), cfg),
            ("dualpath", mod_bench("DIAMOND"), small)]


def _run_mixed(svc, jobs, sm_bench, cfg):
    tickets = [svc.submit(b, c, mechanism=n) for n, b, c in jobs]
    sm_ticket = svc.submit_sm(sm_bench, cfg, n_warps=4, inner="hanoi",
                              policy="greedy_then_oldest")
    svc.flush()
    results = [t.result(300) for t in tickets]
    return results, sm_ticket.result(300), svc.stats()


def test_service_mixed_batch_order_and_equivalence():
    """>= 3 mechanisms, heterogeneous cfgs/shapes, an SM job: equal to the
    reference service, in submission order, with every homogeneous
    ``hanoi_torch`` group natively batched and the same deterministic
    stats (batches, native batches, the fill histogram) under a manual
    flush."""
    small = MachineConfig(n_threads=4, mem_size=64, max_steps=4096)
    jsmall = JCfg(n_threads=4, mem_size=64, max_steps=4096)
    jobs = _mixed_jobs(_bench, CFG, small, "hanoi_torch")
    # max_wait_s is long: the grouping below needs the deadline flusher not
    # to fire mid-submission; flush() drives dispatch
    with _service(default_mechanism="hanoi_torch", max_batch=16,
                  max_wait_s=30.0, workers=3) as svc:
        results, sm, stats = _run_mixed(svc, jobs, _bench("RBFS0"), CFG)
    with jservice.SimulationService(default_mechanism="hanoi_jax",
                                    max_batch=16, max_wait_s=30.0,
                                    workers=3) as jsvc:
        ref, jsm, jstats = _run_mixed(
            jsvc, _mixed_jobs(_jbench, JCFG, jsmall, "hanoi_jax"),
            _jbench("RBFS0"), JCFG)
    for (name, b, c), res, r in zip(jobs, results, ref):
        assert res.mechanism == name
        _same_outcome(res, r)
        _same_outcome(res, SIM.run(b, c, mechanism=name))
    for i, (name, _, _) in enumerate(jobs):
        if name == "hanoi_torch":
            assert results[i].meta["service"]["native"] is True
    cfg_group = [r.meta["service"] for r, (n, _, _) in zip(results, jobs)
                 if n == "hanoi_torch" and r.meta["service"]["batch_size"]
                 == 3]
    assert len(cfg_group) == 3
    assert stats.native_batches >= 2 and stats.native_warps == 4
    assert _deterministic(stats) == _deterministic(jstats)
    assert (sm.policy, sm.inner) == (jsm.policy, jsm.inner)
    _same_sm(sm, jsm)
    assert stats.sm_jobs == 1
    assert stats.completed == len(jobs) + sm.n_warps
    assert stats.failed == 0 and stats.inflight == 0


def test_service_native_batch_instrumented_probe():
    """A probe whose batch_runner counts calls: a homogeneous group runs
    through it exactly once, never through the per-request runner."""
    calls = {"batch": 0, "single": 0, "sizes": []}

    def probe_batch(reqs):
        calls["batch"] += 1
        calls["sizes"].append(len(reqs))
        return [SIM.run(r) for r in reqs]

    @register_mechanism("probe_native", backend="numpy",
                        batch_runner=probe_batch,
                        description="test probe: counting batch_runner")
    def probe_single(req):
        calls["single"] += 1
        return SIM.run(req)

    try:
        with _service(default_mechanism="probe_native", max_batch=4,
                      max_wait_s=5.0, workers=1) as svc:
            tickets = svc.submit_many([_bench("DIAMOND")] * 4, CFG)
            results = [t.result(60) for t in tickets]
            stats = svc.stats()
    finally:
        unregister_mechanism("probe_native")
    assert calls == {"batch": 1, "single": 0, "sizes": [4]}
    assert stats.flush_size == 1 and stats.native_batches == 1
    assert all(r.meta["service"]["flush"] == "size" for r in results)
    assert dict(stats.batch_fill) == {4: 1}


# ---------------------------------------------------------------------------
# service: flush rules end to end, stats, failure path
# ---------------------------------------------------------------------------

def test_service_deadline_flush_resolves_without_manual_flush():
    with _service(max_batch=64, max_wait_s=0.05, workers=1) as svc:
        res = svc.submit(_bench("DIAMOND"), CFG).result(timeout=30)
        stats = svc.stats()
    assert res.ok
    assert stats.flush_deadline == 1 and stats.flush_size == 0
    assert res.meta["service"]["flush"] == "deadline"


def test_service_stats_shape_and_latency():
    with _service(max_batch=2, max_wait_s=30.0, workers=2) as svc:
        svc.run([_bench("DIAMOND")] * 4, CFG, timeout=60)
        stats = svc.stats()
    assert stats.submitted == stats.completed == 4
    assert stats.queue_depth == 0 and stats.inflight == 0
    assert stats.latency_p50_s <= stats.latency_p99_s
    assert stats.warps_per_s > 0
    assert stats.mean_fill == pytest.approx(2.0)
    assert stats.uptime_s > 0


def test_service_failure_resolves_ticket_with_exception():
    @register_mechanism("probe_boom", backend="numpy",
                        description="test probe: always raises")
    def _boom(req):
        raise RuntimeError("probe exploded")

    try:
        with _service(default_mechanism="probe_boom", max_batch=2,
                      max_wait_s=0.01, workers=1) as svc:
            t = svc.submit(_bench("DIAMOND"), CFG)
            svc.flush()
            with pytest.raises(RuntimeError, match="probe exploded"):
                t.result(30)
            stats = svc.stats()
    finally:
        unregister_mechanism("probe_boom")
    assert stats.failed == 1 and stats.completed == 0
    assert stats.inflight == 0


def test_kernel_failure_fails_the_tickets_and_reruns_nothing(monkeypatch):
    """A group whose kernel fails resolves its tickets with that error; the
    service never runs the group again elsewhere."""
    from repro_torch.kernels import ops
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise RuntimeError("hanoi_step kernel launch failed: probe")
    monkeypatch.setattr(ops, "hanoi_run", broken)
    with _service(default_mechanism="hanoi_torch", max_batch=2,
                  max_wait_s=30.0, workers=1) as svc:
        tickets = svc.submit_many([_bench("DIAMOND")] * 2, CFG)
        for t in tickets:
            with pytest.raises(RuntimeError, match="launch failed"):
                t.result(30)
        assert svc.stats().failed == 2
    assert calls == [1]


def test_short_batch_runner_is_an_error_not_a_hang():
    @register_mechanism("probe_short", backend="numpy",
                        batch_runner=lambda reqs:
                            [SIM.run(r) for r in reqs[:-1]],
                        description="test probe: drops the last result")
    def _probe_short(req):
        return SIM.run(req)

    try:
        with pytest.raises(RuntimeError, match="returned 1 results for 2"):
            SIM.run_batch([_bench("DIAMOND")] * 2, CFG,
                          mechanism="probe_short")
        with _service(default_mechanism="probe_short", max_batch=2,
                      max_wait_s=5.0, workers=1) as svc:
            tickets = svc.submit_many([_bench("DIAMOND")] * 2, CFG)
            for t in tickets:
                with pytest.raises(RuntimeError, match="batch_runner"):
                    t.result(30)
            assert svc.stats().failed == 2
    finally:
        unregister_mechanism("probe_short")


def test_service_restarts_after_stop():
    svc = _service(max_batch=1, workers=1)
    assert svc.run([_bench("DIAMOND")], CFG, timeout=30)[0].ok
    svc.stop()
    t = svc.submit(_bench("DIAMOND"), CFG)
    svc.flush()
    assert t.result(30).ok
    svc.stop()


def test_run_sm_grid_shards_cells():
    """Cells through ``sm_torch`` (the CPU twins of K1 and K2, the port's
    default engine for a hanoi inner) equal the reference service's cells
    (``sm_interleave`` over ``hanoi``)."""
    cells = [dict(programs=_bench("RBFS0"), cfg=CFG, n_warps=w,
                  inner="hanoi", policy=p)
             for w in (2, 4) for p in ("round_robin", "greedy_then_oldest")]
    with _service(workers=3) as svc:
        grid = svc.run_sm_grid(cells, timeout=120)
        stats = svc.stats()
    with jservice.SimulationService(default_mechanism="hanoi",
                                    workers=3) as jsvc:
        ref = jsvc.run_sm_grid([{**c, "programs": _jbench("RBFS0"),
                                 "cfg": JCFG} for c in cells], timeout=120)
    assert stats.sm_jobs == len(cells)
    for cell, sm, r in zip(cells, grid, ref):
        assert sm.mechanism == "sm_torch"
        assert sm.n_warps == cell["n_warps"] and sm.policy == cell["policy"]
        _same_sm(sm, r)


def test_sm_cell_stats_count_per_warp():
    with _service(workers=1) as svc:
        rep = svc.submit_sm(_bench("DIAMOND"), CFG, n_warps=3,
                            inner="hanoi").result(120)
        het = svc.submit_sm([_bench("DIAMOND"), _bench("HOTS0")], CFG,
                            inner="hanoi").result(120)
        stats = svc.stats()
    assert rep.n_warps == 3 and het.n_warps == 2
    assert stats.submitted == stats.completed == 5
    assert stats.sm_jobs == 2
    assert stats.failed == 0 and stats.inflight == 0
    assert stats.warps_per_s == pytest.approx(5 / stats.uptime_s)
    assert len(svc._latencies) == 2


def test_sm_cell_failure_counts_per_warp():
    with _service(workers=1) as svc:
        t = svc.submit_sm([_bench("DIAMOND"), _bench("HOTS0")], CFG,
                          n_warps=3, inner="hanoi")
        with pytest.raises(ValueError, match="conflicts"):
            t.result(120)
        stats = svc.stats()
    assert stats.failed == 2 and stats.completed == 0
    assert stats.inflight == 0


def test_stop_shared_deadline_reports_stragglers():
    svc = _service(workers=2)
    svc.start()
    assert svc.run([_bench("DIAMOND")], CFG, timeout=30)[0].ok
    sleepers = [threading.Thread(target=time.sleep, args=(30,),
                                 daemon=True, name=f"wedged-{i}")
                for i in range(3)]
    for t in sleepers:
        t.start()
        svc._threads.append(t)
    t0 = time.monotonic()
    stragglers = svc.stop(timeout=0.5)
    elapsed = time.monotonic() - t0
    assert elapsed < 1.2, elapsed
    assert sorted(stragglers) == [f"wedged-{i}" for i in range(3)]
    with _service(workers=1) as svc2:
        svc2.run([_bench("DIAMOND")], CFG, timeout=30)
    assert svc2.stop() == []


# ---------------------------------------------------------------------------
# durable archival: rotating buffered sink
# ---------------------------------------------------------------------------

def test_rotating_sink_rotates_and_preserves_runs(tmp_path):
    sink = RotatingJsonlSink(str(tmp_path), prefix="t", max_bytes=2000)
    r = SIM.run(_bench("DIAMOND"), CFG)
    for i in range(12):
        feed_result(sink, r, {"mechanism": "hanoi", "program": f"p{i}"})
    sink.flush()
    sink.close()
    assert len(sink.paths) > 1
    assert sink.runs_written == 12
    begins, ends = [], []
    for path in sink.paths:
        state = None
        for line in open(path, encoding="utf-8"):
            ev = json.loads(line)
            if ev["event"] == "begin":
                assert state in (None, "end")
                state = "begin"
                begins.append(ev["program"])
            elif ev["event"] == "end":
                state = "end"
                ends.append(ev["status"])
    assert sorted(begins) == sorted(f"p{i}" for i in range(12))
    assert len(ends) == 12 and set(ends) == {"ok"}
    with pytest.raises(RuntimeError):
        sink.begin({})


def test_rotating_sink_survives_io_failure(tmp_path, monkeypatch):
    sink = RotatingJsonlSink(str(tmp_path), max_bytes=1 << 20)
    r = SIM.run(_bench("DIAMOND"), CFG)
    feed_result(sink, r, {"mechanism": "hanoi", "program": "ok"})
    sink.flush()
    assert sink.runs_written == 1 and sink.write_error is None
    monkeypatch.setattr(sink, "_rotate",
                        lambda: (_ for _ in ()).throw(OSError("disk full")))
    sink._fh.close()
    sink._fh = None
    for i in range(3):
        feed_result(sink, r, {"mechanism": "hanoi", "program": f"bad{i}"})
    sink.flush()
    assert isinstance(sink.write_error, OSError)
    assert sink.runs_dropped == 3 and sink.runs_written == 1
    sink.close()


def test_service_archives_whole_runs_concurrently(tmp_path):
    sink = RotatingJsonlSink(str(tmp_path), max_bytes=1 << 20)
    names = ["HOTS0", "GAUS0", "RBFS0", "DIAMOND"] * 2
    with _service(max_batch=2, max_wait_s=0.01, workers=3,
                  archive=sink) as svc:
        svc.run([_bench(n) for n in names], CFG, timeout=60)
    sink.flush()
    sink.close()
    assert sink.runs_written == len(names)
    events = [json.loads(line) for p in sink.paths
              for line in open(p, encoding="utf-8")]
    assert sum(e["event"] == "begin" for e in events) == len(names)
    assert sum(e["event"] == "end" for e in events) == len(names)
    depth = 0
    for e in events:
        if e["event"] == "begin":
            depth += 1
        elif e["event"] == "end":
            depth -= 1
        assert depth in (0, 1)
    # the archive holds no device: it is the reference's, line for line
    assert not any("device" in json.dumps(e.get("replay", {}))
                   for e in events)


# ---------------------------------------------------------------------------
# serve_simulations: the thin client keeps its contract
# ---------------------------------------------------------------------------

def test_serve_simulations_thin_client():
    from repro.launch.serve import serve_simulations as jserve_simulations
    from repro_torch.launch.serve import serve_simulations
    reqs = [SimRequest(program=_bench("DIAMOND").program, cfg=CFG,
                       name=f"req{i}") for i in range(4)]
    out = serve_simulations(reqs, mechanism="hanoi_torch", device=CPU,
                            max_workers=2)
    ref = jserve_simulations(
        [jengine.SimRequest(program=_jbench("DIAMOND").program, cfg=JCFG,
                            name=f"req{i}") for i in range(4)],
        mechanism="hanoi", max_workers=2)
    assert out["mechanism"] == "hanoi_torch"
    assert out["ok"] == 4 and out["failed"] == 0
    assert len(out["results"]) == 4 and out["warps_per_s"] > 0
    assert out["stats"].completed == 4
    for res, r in zip(out["results"], ref["results"]):
        _same_outcome(res, r)
    with _service() as svc:
        shared = serve_simulations(reqs, mechanism="hanoi", service=svc)
        with pytest.raises(ValueError, match="sink"):
            serve_simulations(reqs, service=svc, sink=object())
    for res, r in zip(shared["results"], ref["results"]):
        _same_outcome(res, r)


def test_serve_replay_mode_watches_an_archive(tmp_path, capsys):
    """``serve --mode replay`` replays an archive on the asked device,
    and with ``--watch`` tails it until it goes idle."""
    from repro_torch.launch import serve
    sink = RotatingJsonlSink(str(tmp_path))
    Simulator(device=CPU, sink=sink).run_batch(
        [_bench(n) for n in ("DIAMOND", "HOTS0", "GAUS0")], CFG)
    sink.close()
    serve.main(["--mode", "replay", "--device", CPU, "--archive-dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "[serve:replay] 3 run(s)" in out
    serve.main(["--mode", "replay", "--device", CPU, "--archive-dir",
                str(tmp_path), "--watch", "--watch-poll-ms", "20",
                "--watch-idle-s", "0.3"])
    out = capsys.readouterr().out
    assert "+3 run(s) -> 3 replayed" in out
    assert "[serve:replay] 3 run(s)" in out


# ---------------------------------------------------------------------------
# regressions: percentile indexing + sink accounting
# ---------------------------------------------------------------------------

def test_stats_percentiles_nearest_rank():
    svc = _service()
    jsvc = jservice.SimulationService(default_mechanism="hanoi")
    for samples in ([0.2, 0.1], [float(i) for i in range(1, 1001)], [5.0]):
        for s in (svc, jsvc):
            s._latencies.clear()
            s._latencies.extend(samples)
        got, want = svc.stats(), jsvc.stats()
        assert (got.latency_p50_s, got.latency_p99_s) == \
            (want.latency_p50_s, want.latency_p99_s)
    assert svc.stats().latency_p50_s == 5.0
    svc._latencies.clear()
    assert np.isnan(svc.stats().latency_p50_s)


def test_rotating_sink_measures_encoded_bytes(tmp_path):
    meta = {"mechanism": "hanoi", "program": "é" * 120}
    r = SIM.run(_bench("DIAMOND"), CFG)
    probe = RotatingJsonlSink(str(tmp_path / "probe"))
    feed_result(probe, r, meta)
    probe.flush()
    probe.close()
    chunk_bytes = os.path.getsize(probe.paths[0])
    chunk_chars = len(open(probe.paths[0], encoding="utf-8").read())
    assert chunk_bytes > chunk_chars
    max_bytes = 2 * chunk_chars
    assert max_bytes < 2 * chunk_bytes
    sink = RotatingJsonlSink(str(tmp_path / "real"), max_bytes=max_bytes)
    for _ in range(4):
        feed_result(sink, r, meta)
    sink.flush()
    sink.close()
    assert len(sink.paths) == 4
    sizes = [os.path.getsize(p) for p in sink.paths]
    assert all(s <= max_bytes for s in sizes)
    assert sink.bytes_written == sum(sizes)
    for path in sink.paths:
        for line in open(path, encoding="utf-8"):
            json.loads(line)


def test_rotating_sink_guards_protocol_violations(tmp_path):
    sink = RotatingJsonlSink(str(tmp_path))
    r = SIM.run(_bench("DIAMOND"), CFG)
    sink.end(r)
    sink.emit(1, 3)
    assert sink.runs_malformed == 1
    assert sink.events_orphaned == 1
    feed_result(sink, r, {"mechanism": "hanoi", "program": "good"})
    sink.begin({"mechanism": "hanoi", "program": "halfdone"})
    sink.emit(0, 1)
    sink.begin({"mechanism": "hanoi", "program": "fresh"})
    sink.emit(0, 1)
    sink.end(r)
    sink.flush()
    sink.close()
    assert sink.runs_stale == 1
    assert sink.runs_written == 2
    events = [json.loads(line) for p in sink.paths
              for line in open(p, encoding="utf-8")]
    begins = [e["program"] for e in events if e["event"] == "begin"]
    assert begins == ["good", "fresh"]
    assert sum(e["event"] == "end" for e in events) == 2


# ---------------------------------------------------------------------------
# admission: static analysis and annotation repair (tests/test_analysis.py,
# tests/test_transform.py)
# ---------------------------------------------------------------------------

def test_service_rejects_statically_invalid_at_admission():
    with _service(workers=1) as svc:
        t_bad = svc.submit(P.fig6_no_break_program(), W8, name="bad")
        t_good = svc.submit(P.fig6_program(), W8, name="good")
        svc.flush()
        assert t_good.result(30).ok
        exc = t_bad.exception(5)
        stats = svc.stats()
    with jservice.SimulationService(default_mechanism="hanoi",
                                    workers=1) as jsvc:
        jt = jsvc.submit(jprograms.fig6_no_break_program(), JW8, name="bad")
        jexc = jt.exception(5)
        jsvc.submit(jprograms.fig6_program(), JW8, name="good").result(30)
        jstats = jsvc.stats()
    assert isinstance(exc, StaticAnalysisError)
    assert isinstance(jexc, JStaticError)
    assert [d.code for d in exc.report.errors] == \
        [d.code for d in jexc.report.errors] == \
        ["reconvergence", "reconvergence"]
    assert (stats.rejected, stats.submitted, stats.completed,
            stats.failed) == (jstats.rejected, jstats.submitted,
                              jstats.completed, jstats.failed) == (1, 2, 1, 0)


def test_service_rejects_bad_sm_cell():
    with _service(workers=1) as svc:
        t = svc.submit_sm(P.fig6_no_break_program(), W8, n_warps=2,
                          inner="hanoi")
        assert isinstance(t.exception(5), StaticAnalysisError)
        stats = svc.stats()
    assert stats.rejected == 2
    assert stats.sm_jobs == 0


def test_service_verify_off_admits_everything():
    with _service(workers=1, verify=False) as svc:
        t = svc.submit(P.fig6_no_break_program(), W8)
        svc.flush()
        res = t.result(30)
        assert svc.stats().rejected == 0
    ref = jengine.Simulator("hanoi").run(jprograms.fig6_no_break_program(),
                                         JW8)
    _same_outcome(res, ref)


def test_service_auto_annotate_repairs_and_counts():
    spin = assemble(P.SPINLOCK_NO_YIELD_ASM)
    with _service(verify="strict", auto_annotate=True, workers=1) as svc:
        t = svc.submit(spin, W4)
        svc.flush()
        res = t.result(timeout=30)
        assert res.ok and int(res.mem[1]) == 4
        stats = svc.stats()
        assert stats.repaired == 1 and stats.rejected == 0
        bad = svc.submit(P.fig6_no_break_program(), W8)
        svc.flush()
        with pytest.raises(StaticAnalysisError):
            bad.result(timeout=30)
        assert svc.stats().rejected == 1
    with jservice.SimulationService(default_mechanism="hanoi",
                                    verify="strict", auto_annotate=True,
                                    workers=1) as jsvc:
        ref = jsvc.submit(jassemble(jprograms.SPINLOCK_NO_YIELD_ASM),
                          JW4).result(timeout=30)
    _same_outcome(res, ref)


# ---------------------------------------------------------------------------
# service stats parity with the SM engines (tests/test_sm_jax.py)
# ---------------------------------------------------------------------------

def test_warp_count_accepts_any_sized_sequence():
    p = _bench("DIAMOND").program
    stack = np.stack([p, p, p])
    assert warp_count(stack, None) == 3
    assert [a.shape for a in per_warp_programs(stack, None)] == [p.shape] * 3
    assert warp_count([p, p], None) == 2
    assert warp_count(p, None) == DEFAULT_WARPS
    assert warp_count(p, 6) == 6
    assert warp_count(_bench("DIAMOND"), None) == DEFAULT_WARPS

    class Deque:
        def __init__(self, items):
            self._items = list(items)

        def __len__(self):
            return len(self._items)

        def __iter__(self):
            return iter(self._items)

    assert warp_count(Deque([p, p]), None) == 2
    assert len(per_warp_programs(Deque([p, p]), None)) == 2
    with pytest.raises(TypeError, match="unsized iterable"):
        warp_count(iter([p, p]), None)
    with pytest.raises(TypeError, match="unsized iterable"):
        per_warp_programs((q for q in [p, p]), None)
    with pytest.raises(ValueError, match="conflicts"):
        per_warp_programs([p, p], 3)


def test_submit_sm_stats_count_ndarray_stack_warps():
    """A 3-plane ndarray stack is 3 warps through ``sm_torch`` (the
    service's default SM engine here), as through the reference's
    ``sm_interleave``; stats equal the reference service's."""
    stack = np.stack([_bench("DIAMOND").program] * 3)
    with _service(default_mechanism="hanoi_torch", workers=1) as svc:
        sm = svc.submit_sm(stack, CFG, policy="round_robin").result(120)
        stats = svc.stats()
    with jservice.SimulationService(default_mechanism="hanoi",
                                    workers=1) as jsvc:
        jsm = jsvc.submit_sm(np.stack([_jbench("DIAMOND").program] * 3),
                             JCFG, policy="round_robin").result(120)
        jstats = jsvc.stats()
    assert sm.mechanism == "sm_torch" and sm.n_warps == 3
    _same_sm(sm, jsm)
    assert (stats.sm_jobs, stats.submitted, stats.completed,
            stats.failed) == (jstats.sm_jobs, jstats.submitted,
                              jstats.completed, jstats.failed) == (1, 3, 3, 0)
    assert (stats.sm_cycles, stats.sm_busy_cycles,
            stats.sm_issue_stall_cycles) == \
        (jstats.sm_cycles, jstats.sm_busy_cycles,
         jstats.sm_issue_stall_cycles)
