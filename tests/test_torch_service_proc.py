"""The port's process tier (``repro_torch.service.procpool``), persistent
kernel cache and warm start (``repro_torch.engine.compile_cache``) against
the JAX package's: the counterpart of ``tests/test_service_proc.py``.

Shards are spawned processes on the service's device, here the CPU
(``device="cpu"``: ``hanoi_torch`` and ``sm_torch`` run the plain twins of
K1 and K2).  Every result that crosses the spawn boundary must equal the
reference's for the same requests (``hanoi_torch`` held to ``hanoi_jax``),
carry numpy arrays and no torch tensor, every shard's archive family must
self-replay to exactly 0.0, and a restarted warm-started service must take
no kernel-cache miss.  The groups whose counts the cases assert are formed
by a manual flush (``max_wait_s`` far beyond any case), never by timing.
``_register_shard_probes`` is the shard init hook, imported by reference
in every spawned shard.  The machine with the card has no JAX: there this
module skips.
"""
from __future__ import annotations

import glob
import os
import pickle
import time
import types as pytypes

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro import engine as jengine                                # noqa: E402
from repro import service as jservice                              # noqa: E402
from repro.core import programs as jprograms                       # noqa: E402
from repro.core.isa import MachineConfig as JCfg                   # noqa: E402
from repro.engine import compile_cache as jcc                      # noqa: E402
from repro_torch.archive import ArchiveReader, Replayer            # noqa: E402
from repro_torch.archive.index import ArchiveIndex, compact        # noqa: E402
from repro_torch.core.isa import MachineConfig                     # noqa: E402
from repro_torch.core.programs import diamond_program, make_suite  # noqa: E402
from repro_torch.engine import (MemorySink, RotatingJsonlSink,     # noqa: E402
                                Simulator, adapters, iter_mechanisms,
                                register_mechanism, unregister_mechanism)
from repro_torch.engine.compile_cache import (CompileCache,        # noqa: E402
                                              affinity_token,
                                              shard_of_token,
                                              uninstall_compile_cache)
from repro_torch.engine.simulator import as_request                # noqa: E402
from repro_torch.service import ServiceStopped, SimulationService  # noqa: E402

CFG = MachineConfig(n_threads=8, mem_size=64, max_steps=4096)
JCFG = JCfg(n_threads=8, mem_size=64, max_steps=4096)
SUITE = make_suite(CFG, datasets=1)
JSUITE = jprograms.make_suite(JCFG, datasets=1)
SIM = Simulator("hanoi", device="cpu")
CPU = "cpu"
TO_REF = {"hanoi_torch": "hanoi_jax", "sm_torch": "sm_jax"}
WAIT = 600.0            # every ticket's own timeout, seconds
MANUAL = 600.0          # max_wait_s: groups form on flush(), never on time


def _reqs(n=6, **kw):
    return [as_request(b, CFG, **kw) for b in SUITE[:n]]


def _jreqs(n=6, **kw):
    return [jengine.as_request(b, JCFG, **kw) for b in JSUITE[:n]]


def _same_outcome(a, b):
    assert a.status.value == b.status.value
    assert (a.fuel_left, a.finished, a.steps, a.error) == \
        (b.fuel_left, b.finished, b.steps, b.error)
    np.testing.assert_array_equal(a.regs, b.regs)
    np.testing.assert_array_equal(a.preds, b.preds)
    np.testing.assert_array_equal(a.mem, b.mem)
    assert a.trace == b.trace


def _no_tensor(obj, seen=None) -> bool:
    """True when nothing reachable from ``obj`` is a torch tensor."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return True
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, (str, bytes, int, float, bool, type(None),
                        np.ndarray, np.generic)):
        return True
    if isinstance(obj, (dict, pytypes.MappingProxyType)):
        return all(_no_tensor(k, seen) and _no_tensor(v, seen)
                   for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return all(_no_tensor(v, seen) for v in obj)
    fields = getattr(obj, "__dataclass_fields__", None)
    if fields is not None:
        return all(_no_tensor(getattr(obj, f), seen) for f in fields)
    return True


# ---------------------------------------------------------------------------
# shard init hook (pickled by reference into spawned shards)
# ---------------------------------------------------------------------------

def _register_shard_probes(shard: int) -> None:
    """Runs inside every spawned shard: installs the probe mechanisms the
    cases below route to (a parent-process ``register_mechanism`` does not
    cross the spawn boundary)."""
    import dataclasses
    import time as _time

    from repro_torch.engine import Simulator as _Sim
    from repro_torch.engine import register_mechanism as _register

    @_register("proc_probe", backend="numpy",
               description="shard-side echo probe")
    def _probe(req):
        res = _Sim("hanoi", device="cpu").run(req)
        return dataclasses.replace(res, meta={**res.meta, "shard": shard})

    @_register("proc_sleeper", backend="numpy",
               description="wedges the shard (shutdown cases)")
    def _sleeper(req):
        _time.sleep(120)
        raise RuntimeError("unreachable")


def _failing_shard_init(shard: int) -> None:
    raise RuntimeError(f"shard {shard} cannot start")


def _parent_stub(name):
    """Parent-side registration so signature_of/get_mechanism admit the
    request; execution happens in the shard."""
    def _never_runs(req):
        raise AssertionError(f"{name} must execute in a shard process")
    return register_mechanism(name, backend="numpy")(_never_runs)


@pytest.fixture(scope="module")
def svc():
    """One two-shard CPU service for the cases that need no archive, no
    warm start and no stop: spawned once."""
    service = SimulationService(default_mechanism="hanoi", device=CPU,
                                procs=2, max_batch=64, max_wait_s=MANUAL,
                                shard_init=_register_shard_probes)
    service.start()
    assert service._pool.wait_ready(timeout=WAIT)
    yield service
    assert service.stop(timeout=60.0) == []


# ---------------------------------------------------------------------------
# cross-process bit-equality
# ---------------------------------------------------------------------------

def test_every_mechanism_bit_equal_through_two_procs(svc):
    """Every port mechanism through the two-shard service equals the
    reference service's result for the same requests, and the port's
    single-process ``Simulator.run_batch``."""
    names = sorted(m.name for m in iter_mechanisms())
    reqs, jreqs = _reqs(3), _jreqs(3)
    with jservice.SimulationService(default_mechanism="hanoi",
                                    annotate=False) as jsvc:
        for name in names:
            got = svc.run(reqs, mechanism=name, timeout=WAIT)
            ref = jsvc.run(jreqs, mechanism=TO_REF.get(name, name),
                           timeout=WAIT)
            want = Simulator(name, device=CPU).run_batch(reqs)
            for g, r, w in zip(got, ref, want, strict=True):
                assert g.mechanism == name
                _same_outcome(g, r)
                _same_outcome(g, w)


def test_proc_results_annotated_with_shard(svc):
    res = svc.run(_reqs(4), timeout=WAIT)
    for r in res:
        svc_meta = r.meta["service"]
        assert svc_meta["shard"] in (0, 1)
        assert svc_meta["batch_size"] >= 1


def test_numpy_groups_spread_across_shards(svc):
    res = svc.run(_reqs(6), timeout=WAIT)
    shards = {r.meta["service"]["shard"] for r in res}
    st = svc.stats()
    assert shards == {0, 1}
    assert {s.shard for s in st.shards if s.completed > 0} == {0, 1}


def test_torch_groups_route_affine_to_one_shard(svc):
    """A signature-homogeneous ``hanoi_torch`` group keeps its
    kernel-cache locality: the whole group lands on its affinity shard,
    the one the reference picks for the ``hanoi_jax`` token."""
    reqs = _reqs(6)
    res = svc.run(reqs, mechanism="hanoi_torch", timeout=WAIT)
    shards = {r.meta["service"]["shard"] for r in res}
    assert len(shards) == 1
    sig = res[0].meta["service"]["signature"]
    assert sig.startswith("hanoi_torch/") and "device=" in sig
    token = affinity_token("hanoi_torch", CFG, True, 32)
    assert shards == {shard_of_token(token, 2)}
    assert token.replace("hanoi_torch", "hanoi_jax") == \
        jcc.affinity_token("hanoi_jax", JCFG, True, 32)
    for r, w in zip(res, Simulator(device=CPU).run_batch(reqs)):
        _same_outcome(r, w)


def test_sm_grid_bit_equal_through_two_procs(svc):
    progs = [b.program for b in SUITE[:4]]
    jprogs = [b.program for b in JSUITE[:4]]
    policies = ("round_robin", "greedy_then_oldest")
    before = svc.stats().sm_jobs
    got = svc.run_sm_grid([dict(programs=progs, cfg=CFG, n_warps=4,
                                inner="hanoi", policy=p) for p in policies],
                          timeout=WAIT)
    assert svc.stats().sm_jobs - before == 2
    jsim = jengine.Simulator("hanoi")
    for p, sm in zip(policies, got):
        want = jsim.run_sm(jprogs, JCFG, n_warps=4, inner="hanoi", policy=p)
        assert sm.mechanism == "sm_torch"
        assert sm.sm_trace == want.sm_trace
        assert sm.cycles == want.cycles
        assert sm.stall_breakdown == want.stall_breakdown
        for g, w in zip(sm.warps, want.warps):
            _same_outcome(g, w)


def test_shard_init_registers_plugin_mechanisms_in_shards(svc):
    _parent_stub("proc_probe")
    try:
        got = svc.run(_reqs(4), mechanism="proc_probe", timeout=WAIT)
    finally:
        unregister_mechanism("proc_probe")
    for g, w in zip(got, SIM.run_batch(_reqs(4))):
        _same_outcome(g, w)
        assert g.meta["shard"] in (0, 1)


def test_shard_exception_rebuilt_parent_side(svc):
    _parent_stub("proc_parent_only")
    try:
        before = svc.stats().failed
        t = svc.submit(diamond_program(), CFG, mechanism="proc_parent_only")
        svc.flush()
        with pytest.raises(Exception) as ei:
            t.result(timeout=WAIT)
        assert "proc_parent_only" in str(ei.value)
    finally:
        unregister_mechanism("proc_parent_only")
    assert svc.stats().failed == before + 1


def test_results_cross_the_spawn_boundary_without_tensors(svc):
    """Group and SM-cell results that came back from a shard hold numpy
    arrays and no torch tensor, and pickle round-trip unchanged."""
    res = svc.run(_reqs(3), mechanism="hanoi_torch", timeout=WAIT)
    sm = svc.submit_sm([b.program for b in SUITE[:2]], CFG, n_warps=2,
                       inner="hanoi_torch").result(WAIT)
    sm_res = svc.run(_reqs(2, meta={"sm_warps": 2}), mechanism="sm_torch",
                     timeout=WAIT)
    for obj in (*res, sm, *sm_res):
        assert _no_tensor(obj)
        back = pickle.loads(pickle.dumps(obj))
        assert _no_tensor(back)
    for r in res:
        assert isinstance(r.regs, np.ndarray) and isinstance(r.mem,
                                                             np.ndarray)
    assert isinstance(sm_res[0].meta["sm"].warps[0].regs, np.ndarray)


def test_shards_report_kernel_cache_and_launches(svc):
    """Each shard reports its pid, its kernel-cache counters (a
    ``hanoi_torch`` group took a miss or a hit there) and its K1/K2
    launch counts (0 on the CPU: the twins run, no kernel launches)."""
    svc.run(_reqs(4), mechanism="hanoi_torch", timeout=WAIT)
    st = svc.stats()
    assert st.procs == 2 and len(st.shards) == 2
    assert all(s.pid and s.alive for s in st.shards)
    assert st.cache_misses + st.cache_hits >= 1
    assert st.cache_entries >= 1
    for s in st.shards:
        assert dict(s.launches) == {"hanoi_run": 0, "sm_schedule": 0}


# ---------------------------------------------------------------------------
# per-shard archive families
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_archive(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shard-archive"))
    sink = RotatingJsonlSink(d, prefix="traces", max_bytes=1 << 20)
    with SimulationService(default_mechanism="hanoi", device=CPU, procs=2,
                           max_wait_s=MANUAL, archive=sink) as s:
        s.run(_reqs(6), mechanism="hanoi", timeout=WAIT)
        s.run(_reqs(6), mechanism="hanoi_torch", timeout=WAIT)
        s.submit_sm([b.program for b in SUITE[:4]], CFG, n_warps=4,
                    inner="hanoi").result(WAIT)
    sink.close()
    return d


def test_per_shard_archives_self_replay_to_zero(shard_archive):
    d = shard_archive
    families = sorted(os.path.basename(p)
                      for p in glob.glob(os.path.join(d, "*.jsonl")))
    assert any("traces-shard0-" in f for f in families)
    assert any("traces-shard1-" in f for f in families)
    total = 0
    for k in range(2):
        reader = ArchiveReader(d, prefix=f"traces-shard{k}")
        runs = reader.runs()
        total += len(runs)
        rep = Replayer(simulator=Simulator(device=CPU)).replay(reader)
        assert rep.mean_discrepancy() == 0.0
        assert rep.replayed == len(runs)
        assert all(r.meta.get("shard") == k for r in runs)
        assert all("device" not in r.meta for r in runs)
    assert total == 16   # 6 hanoi + 6 hanoi_torch + 4 SM warps


def test_shard_family_index_and_compaction_still_work(shard_archive):
    d = shard_archive
    for k in range(2):
        prefix = f"traces-shard{k}"
        reader = ArchiveReader(d, prefix=prefix)
        runs = reader.runs()
        if not runs:
            continue
        idx = ArchiveIndex.ensure(d, prefix=prefix)
        assert len(idx.entries) == len(runs)
        got = reader.get(idx.entries[0].run_id)
        assert got.meta == runs[0].meta and got.steps == runs[0].steps
        assert compact(d, prefix) is not None
        assert len(ArchiveReader(d, prefix=prefix).runs()) == len(runs)


def test_non_rotating_sink_fed_parent_side():
    sink = MemorySink()
    with SimulationService(default_mechanism="hanoi", device=CPU, procs=2,
                           max_wait_s=MANUAL, archive=sink) as s:
        s.run(_reqs(4), timeout=WAIT)
    assert len(sink.runs) == 4


# ---------------------------------------------------------------------------
# shutdown semantics
# ---------------------------------------------------------------------------

def test_stop_terminates_wedged_shard_and_resolves_tickets():
    _parent_stub("proc_sleeper")
    try:
        s = SimulationService(default_mechanism="hanoi", device=CPU,
                              procs=1, shard_init=_register_shard_probes)
        s.start()
        assert s._pool.wait_ready(timeout=WAIT)
        ticket = s.submit(diamond_program(), CFG, mechanism="proc_sleeper")
        s.flush()
        time.sleep(0.5)                    # let the shard start sleeping
        t0 = time.monotonic()
        stragglers = s.stop(timeout=1.0)
        assert time.monotonic() - t0 < 15.0
        assert "sim-shard-0" in stragglers
        with pytest.raises(ServiceStopped):
            ticket.result(timeout=5.0)
    finally:
        unregister_mechanism("proc_sleeper")


def test_warm_start_fails_fast_when_a_shard_dies(tmp_path):
    """A shard that dies before it is ready fails ``start()`` at once (the
    service does not wait out its warm-start deadline), and leaves no
    shard behind."""
    s = SimulationService(default_mechanism="hanoi", device=CPU, procs=1,
                          warm_start=str(tmp_path),
                          shard_init=_failing_shard_init)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="not ready"):
        s.start()
    assert time.monotonic() - t0 < 120.0
    assert s._pool is None and s.stop() == []


def test_clean_stop_reports_no_stragglers():
    s = SimulationService(default_mechanism="hanoi", device=CPU, procs=1)
    s.start()
    s.run(_reqs(4), timeout=WAIT)
    assert s.stop(timeout=60.0) == []
    st = s.stats()
    assert st.completed == 4 and st.inflight == 0
    assert st.procs == 1 and len(st.shards) == 1


# ---------------------------------------------------------------------------
# warm start + kernel-cache counters
# ---------------------------------------------------------------------------

def test_warm_start_restarted_service_retraces_zero(tmp_path):
    """A cold service takes one miss a signature and records it in the
    manifest; a restarted service warms every signature (loaded: on the
    CPU no library is needed) and serves the same traffic with no miss.
    Groups are formed by the manual flush of ``run``, never by time."""
    cache_dir = str(tmp_path / "kcache")
    stats = []
    for _ in range(2):
        s = SimulationService(default_mechanism="hanoi_torch", device=CPU,
                              procs=1, max_wait_s=MANUAL,
                              warm_start=cache_dir)
        with s:
            first = s.run(_reqs(6), timeout=WAIT)
            s.run(_reqs(3), timeout=WAIT)     # a second batch-size class
        stats.append(s.stats())
        for r, w in zip(first, Simulator(device=CPU).run_batch(_reqs(6))):
            _same_outcome(r, w)
    cold, warm = stats
    assert cold.cache_misses >= 2
    entries = CompileCache(cache_dir).entries()
    assert len(entries) >= 2
    assert {e.mechanism for e in entries} == {"hanoi_torch"}
    assert len({e.batch for e in entries}) >= 2
    assert warm.warm_signatures >= 2
    assert warm.cache_misses == warm.warm_retraced == 0
    assert warm.warm_loaded >= 2 and warm.cache_disk_hits >= 2
    assert warm.cache_hits >= 2


def test_thread_tier_warm_start(tmp_path):
    cache_dir = str(tmp_path / "kcache")
    try:
        with SimulationService(default_mechanism="hanoi_torch", device=CPU,
                               max_wait_s=MANUAL,
                               warm_start=cache_dir) as s:
            s.run(_reqs(5), timeout=WAIT)
        adapters.reset_batch_caches()      # a process restart
        with SimulationService(default_mechanism="hanoi_torch", device=CPU,
                               max_wait_s=MANUAL,
                               warm_start=cache_dir) as s2:
            before = s2.stats()
            assert before.warm_signatures >= 1
            assert before.warm_loaded == before.warm_signatures
            s2.run(_reqs(5), timeout=WAIT)
            after = s2.stats()
        assert after.cache_misses == before.cache_misses == 0
        assert after.cache_hits > before.cache_hits
    finally:
        uninstall_compile_cache()
        adapters.reset_batch_caches()


def test_warm_start_archive_stamps_cache_counters(tmp_path):
    """A warm-start deployment stamps the kernel-cache counters onto every
    archived run, as the reference does."""
    from repro_torch.engine import install_compile_cache
    sink = MemorySink()
    try:
        adapters.reset_batch_caches()
        install_compile_cache(str(tmp_path / "kcache"))
        with SimulationService(default_mechanism="hanoi_torch", device=CPU,
                               max_wait_s=MANUAL, archive=sink) as s:
            s.run(_reqs(2), timeout=WAIT)
    finally:
        uninstall_compile_cache()
        adapters.reset_batch_caches()
    stamps = [run["meta"]["compile_cache"] for run in sink.runs]
    assert len(stamps) == 2
    assert all(st["misses"] == 1 and st["trace_time_s"] == 0.0
               for st in stamps)


# ---------------------------------------------------------------------------
# bounded in-memory caches
# ---------------------------------------------------------------------------

def test_batch_caches_bounded_with_eviction_counters():
    adapters.reset_batch_caches()
    adapters.set_batch_cache_capacity(executables=2)
    try:
        sim = Simulator(device=CPU)
        for n in (1, 2, 3):
            sim.run_batch(_reqs(n))
        s = adapters.batch_cache_stats()
        assert s["entries"] <= 2
        assert s["evictions"] >= 1
        assert s["misses"] >= 3
        assert s["capacity"] == 2
        sim.run_batch(_reqs(3))            # most recent entry: a hit
        assert adapters.batch_cache_stats()["hits"] > s["hits"]
        sim.run_batch(_reqs(1))            # evicted: a miss again
        assert adapters.batch_cache_stats()["misses"] == s["misses"] + 1
    finally:
        adapters.set_batch_cache_capacity(executables=256)
        adapters.reset_batch_caches()


def test_sm_torch_phases_count_into_the_kernel_cache():
    """``sm_torch``'s K1 phase counts under the ``hanoi_torch`` key of its
    unique rows and its K2 phase under the ``sm_torch`` key of its cell
    width, as ``sm_jax``'s compiles count in the reference."""
    adapters.reset_batch_caches()
    try:
        sim = Simulator(device=CPU)
        progs = [b.program for b in SUITE[:4]]
        sim.run_sm(progs, CFG, n_warps=4, policy="round_robin")
        s = adapters.batch_cache_stats()
        assert (s["misses"], s["hits"], s["entries"]) == (2, 0, 2)
        sim.run_sm(progs, CFG, n_warps=4, policy="greedy_then_oldest")
        s = adapters.batch_cache_stats()
        assert (s["misses"], s["hits"], s["entries"]) == (2, 2, 2)
    finally:
        adapters.reset_batch_caches()


def test_kernel_cache_counts_exactly_under_thread_stress():
    """Many threads preparing launches at a few keys at once, with a
    shortened switch interval: every call counts once, and each key takes
    exactly one miss (the miss path is serialized)."""
    import sys
    import threading
    keys = [(CFG._replace(max_steps=64 * (k + 1)), True, 4, 32)
            for k in range(5)]
    dev = torch.device("cpu")
    n_threads, calls = 16, 200
    adapters.reset_batch_caches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(t):
            for i in range(calls):
                adapters.prepare_launch("hanoi_torch", *keys[(t + i) % 5],
                                        dev)
        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    s = adapters.batch_cache_stats()
    adapters.reset_batch_caches()
    assert s["hits"] + s["misses"] == n_threads * calls
    assert s["misses"] == s["entries"] == len(keys)


def test_launch_counts_are_exact_across_threads():
    """A wrapper's launch count loses no increment when service workers
    launch from several threads at once."""
    import sys
    import threading

    from repro_torch.kernels import ops

    def probe():
        pass
    probe.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ops._count(probe) for _ in range(5000)])
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert probe.launches == 16 * 5000


def test_thread_tier_stats_surface_cache_counters():
    adapters.reset_batch_caches()
    with SimulationService(default_mechanism="hanoi_torch", device=CPU,
                           max_wait_s=MANUAL) as s:
        s.run(_reqs(4), timeout=WAIT)
        st = s.stats()
    assert st.procs == 0 and st.shards == ()
    # one miss a signature group (the suite's pad classes), no hit
    assert st.cache_misses == st.cache_entries >= 1
    assert st.cache_hits == 0
    adapters.reset_batch_caches()


# ---------------------------------------------------------------------------
# affinity hashing + envelope pickling
# ---------------------------------------------------------------------------

def test_affinity_token_stable_and_partitioning():
    tok = affinity_token("hanoi_torch", CFG, True, 32)
    assert tok == affinity_token("hanoi_torch", CFG, True, 32)
    assert tok != affinity_token("hanoi_torch", CFG, False, 32)
    assert tok != affinity_token("hanoi_torch", CFG, True, 64)
    for n in (1, 2, 3, 7):
        assert 0 <= shard_of_token(tok, n) < n
        jtok = jcc.affinity_token("hanoi_torch", JCFG, True, 32)
        assert jtok == tok
        assert shard_of_token(tok, n) == jcc.shard_of_token(jtok, n)
    assert shard_of_token(tok, 1) == 0


def test_manifest_entries_read_by_the_reference(tmp_path):
    """The manifest keeps the reference's format: its ``CompileCache``
    reads the port's entries field for field."""
    cache = CompileCache(str(tmp_path))
    cache.store_executable("hanoi_torch", CFG, True, 6, 32, 0.25)
    mine = cache.entries()
    ref = jcc.CompileCache(str(tmp_path)).entries()
    assert [(e.mechanism, e.cfg, e.majority_first, e.batch, e.pad_len,
             e.token, e.compile_time_s) for e in mine] == \
        [(e.mechanism, e.cfg, e.majority_first, e.batch, e.pad_len,
          e.token, e.compile_time_s) for e in ref] == \
        [("hanoi_torch", CFG._asdict(), True, 6, 32,
          affinity_token("hanoi_torch", CFG, True, 32), 0.25)]
    assert cache.has("hanoi_torch", CFG, True, 6, 32)
    assert not cache.has("hanoi_torch", CFG, True, 7, 32)
    assert cache.load_executable("hanoi_torch", CFG, True, 6, 32,
                                 device=CPU) == ("hanoi_step",)
    assert cache.load_executable("hanoi_torch", CFG, True, 7, 32,
                                 device=CPU) is None
    snap = cache.snapshot()
    assert (snap["stored"], snap["disk_hits"], snap["disk_misses"],
            snap["manifest_entries"]) == (1, 1, 1, 1)


def test_request_result_pickle_roundtrip():
    req = _reqs(1, meta={"k": 1})[0]
    r2 = pickle.loads(pickle.dumps(req))
    assert isinstance(r2.meta, pytypes.MappingProxyType)
    assert dict(r2.meta) == {"k": 1}
    np.testing.assert_array_equal(r2.program, req.program)
    res = Simulator(device=CPU).run(req)
    res2 = pickle.loads(pickle.dumps(res))
    _same_outcome(res, res2)
    assert isinstance(res2.meta, pytypes.MappingProxyType)
    sm = Simulator(device=CPU).run_sm([b.program for b in SUITE[:2]], CFG,
                                      n_warps=2, inner="hanoi")
    sm2 = pickle.loads(pickle.dumps(sm))
    assert sm2.sm_trace == sm.sm_trace and sm2.cycles == sm.cycles
    for a, b in zip(sm.warps, sm2.warps):
        _same_outcome(a, b)
    assert _no_tensor(res2) and _no_tensor(sm2)


def test_bench_service_sweep_and_warm_gate_on_cpu(capsys):
    """The port's ``bench_service`` on the CPU: the sweep over the three
    mixes prints its acceptance line, and the warm-start report of a
    restarted one-shard service takes no serve-time miss."""
    from repro_torch.benchmarks import bench_service
    bench_service.main(["--smoke", "--device", CPU])
    out = capsys.readouterr().out
    for mix in ("hanoi_torch,16,", "hanoi,16,", "mixed,16,"):
        assert mix in out
    assert "(acceptance: coalesced >= per-request loop)" in out
    w = bench_service.warm_start_report(device=CPU)
    assert w["cold_ok"] == w["warm_ok"] == 8
    assert w["cold_misses"] >= 1 and w["zero_retrace"]
    assert w["serve_misses"] == w["warm_retraced"] == 0

