"""The port's cycle engine (``repro_torch.timing``) and the lifted
``repro_torch.core.timing`` shims against the JAX package's
(``repro.timing``, ``repro.core.timing``), on the cases of
``tests/test_timing.py``: the event core, the three issue policies and their
``priority_keys`` formulation, ``schedule_cycle`` / ``simulate_cycle`` in the
trace-conservative, scoreboard, dual-issue and seeded stochastic-memory
modes, and the legacy ``schedule_traces`` / ``simulate`` against
``schedule_traces_reference``.

Everything here is numpy and exact, so every comparison is equality.  The
machine with the card has no JAX: there this module skips.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import timing as jtiming                         # noqa: E402
from repro.core.isa import MachineConfig                        # noqa: E402
from repro.core.programs import make_suite                      # noqa: E402
from repro.engine import Simulator                              # noqa: E402
from repro import timing as jt                                  # noqa: E402
from repro.timing import policies as jpol                       # noqa: E402
from repro_torch import timing as tt                            # noqa: E402
from repro_torch.core import timing as ttiming                  # noqa: E402
from repro_torch.timing import policies as tpol                 # noqa: E402
from tests.progen import make_program                           # noqa: E402

CFG = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
SUITE = make_suite(CFG, datasets=1)
SIM = Simulator("hanoi")
POLICIES = ("greedy_then_oldest", "round_robin", "oldest_first")


def _trace(prog, cfg=CFG, mech="hanoi", mem=None):
    return list(SIM.run(prog, cfg, mechanism=mech, init_mem=mem).trace)


def _corpus():
    """(traces, programs) warp sets, as test_timing.py builds them: suite
    benches under two mechanisms, and heterogeneous progen triples with
    and without memory-latency features."""
    sets = []
    for b in SUITE[:4]:
        prog = np.asarray(b.program)
        sets.append(([_trace(b), _trace(b, mech="simt_stack")], [prog, prog]))
    pool = []
    for seed in range(12):
        out, cfg = make_program(seed, 8, mem_features=(seed % 2 == 0))
        if out is None:
            continue
        prog, mem = out
        pool.append((_trace(prog, cfg, "simt_stack", mem), np.asarray(prog)))
    for i in range(0, len(pool) - 2, 3):
        chunk = pool[i:i + 3]
        sets.append(([t for t, _ in chunk], [p for _, p in chunk]))
    return sets


CORPUS = _corpus()


def _fields(res) -> dict:
    d = dataclasses.asdict(res)
    d["order"] = [tuple(x) for x in d["order"]]
    return d


def _cycle_pair(cfg_kw: dict):
    return jt.CycleConfig(**cfg_kw), tt.CycleConfig(**cfg_kw)


MODES = {
    "trace_conservative": dict(scoreboard=False),
    "trace_conservative_slow_memory": dict(scoreboard=False,
                                           memory_latency=300, alu_latency=7),
    "scoreboard": dict(scoreboard=True),
    "dual_issue": dict(scoreboard=True, issue_width=2),
    "uniform_memory_seeded": dict(memory_model="uniform", seed=11,
                                  memory_latency_lo=10, memory_latency_hi=60),
    "bimodal_memory_seeded": dict(memory_model="bimodal", seed=5,
                                  scoreboard=False),
}


# ---------------------------------------------------------------------------
# events.py
# ---------------------------------------------------------------------------

def _event_run(mod):
    q = mod.EventQueue()
    for t, x in ((5, "a"), (2, "b"), (5, "c"), (2, "d"), (9, "e")):
        q.push(t, x)
    popped = [q.peek_time(), q.pop(), q.pop(), list(q.pop_until(5)), len(q)]
    sched = mod.Scheduler()
    done = {}
    sig, never = mod.Signal(), mod.Signal()

    def worker(name, wait):
        yield mod.Delay(wait)
        done[name] = sched.now

    def producer():
        yield mod.Delay(3)
        sig.fire(sched)

    def consumer():
        yield sig
        done["consumer"] = sched.now

    def parked():
        yield never

    for proc in (worker("fast", 2), worker("slow", 7), producer(), consumer(),
                 parked()):
        sched.spawn(proc)
    sched.run()
    return popped, done, sched.now


def test_event_core_equal():
    assert _event_run(tt) == _event_run(jt)


# ---------------------------------------------------------------------------
# policies.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES + ("gto",))
def test_policies_and_priority_keys_equal(policy):
    """The same select / issued / stalled history gives the same choices
    and key vectors in both packages, and the port's argmin over
    ``priority_keys`` never drifts from its ``select``."""
    assert tpol.POLICY_NAMES == jpol.POLICY_NAMES
    assert tpol.resolve_policy_name(policy) == \
        jpol.resolve_policy_name(policy)
    rng = np.random.default_rng(20260809)
    for n_warps in (1, 2, 3, 8, 33):
        mine = tpol.get_policy(policy, n_warps)
        ref = jpol.get_policy(policy, n_warps)
        for _ in range(200):
            keys = mine.priority_keys()
            np.testing.assert_array_equal(keys, ref.priority_keys())
            k = int(rng.integers(1, n_warps + 1))
            ready = sorted(rng.choice(n_warps, size=k, replace=False))
            sel = mine.select(ready)
            assert sel == ref.select(ready)
            assert sel == min(ready, key=lambda w: int(keys[w]))
            if rng.random() < 0.25:
                mine.stalled()
                ref.stalled()
            else:
                mine.issued(sel)
                ref.issued(sel)
    for kw in ({}, {"last": 2}, {"cursor": 3}):
        name = tpol.resolve_policy_name(policy)
        np.testing.assert_array_equal(tpol.priority_keys(name, 4, **kw),
                                      jpol.priority_keys(name, 4, **kw))


# ---------------------------------------------------------------------------
# sm_model.py: schedule_cycle / simulate_cycle in every mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("policy", POLICIES)
def test_schedule_cycle_equal(mode, policy):
    jcfg, tcfg = _cycle_pair(MODES[mode])
    for traces, progs in CORPUS:
        got = tt.schedule_cycle(traces, progs, policy, tcfg)
        want = jt.schedule_cycle(traces, progs, policy, jcfg)
        assert _fields(got) == _fields(want)
        assert (got.ipc, got.warp_ipc, got.simd_utilization) == \
            (want.ipc, want.warp_ipc, want.simd_utilization)


@pytest.mark.parametrize("mode", list(MODES))
def test_simulate_cycle_equal(mode):
    jcfg, tcfg = _cycle_pair(MODES[mode])
    for traces, progs in CORPUS:
        for n in (1, 4):
            got = tt.simulate_cycle([traces[0]] * n, progs[0], 8, tcfg)
            want = jt.simulate_cycle([traces[0]] * n, progs[0], 8, jcfg)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_instr_deps_and_cycle_config_equal():
    for b in SUITE:
        for row in np.asarray(b.program):
            assert tt.instr_deps(row) == jt.instr_deps(row)
    for bad in (dict(memory_model="gaussian"), dict(issue_width=0),
                dict(memory_latency_lo=50, memory_latency_hi=10,
                     memory_model="uniform")):
        with pytest.raises(ValueError):
            tt.CycleConfig(**bad)
    c = tt.CycleConfig(scoreboard=False, issue_width=2)
    assert tt.CycleConfig.from_timing(c, scoreboard=True) is c
    for t_kw in ({}, {"alu_latency": 5, "memory_latency": 100}):
        assert dataclasses.asdict(tt.CycleConfig.from_timing(
            ttiming.TimingConfig(**t_kw), scoreboard=True)) == \
            dataclasses.asdict(jt.CycleConfig.from_timing(
                jtiming.TimingConfig(**t_kw), scoreboard=True))


# ---------------------------------------------------------------------------
# the lifted core.timing shims
# ---------------------------------------------------------------------------

TIMING_CFGS = [dict(), dict(alu_latency=1, control_latency=1,
                            memory_latency=1, atomic_latency=1),
               dict(alu_latency=3, control_latency=2, memory_latency=11,
                    atomic_latency=17)]


@pytest.mark.parametrize("policy", ["greedy_then_oldest", "round_robin"])
def test_schedule_traces_equals_reference(policy):
    """The port's ``schedule_traces`` (now on the port's cycle engine)
    equals its ``schedule_traces_reference`` and the JAX package's, on
    opcode columns and on full row tables."""
    cases = 0
    for traces, progs in CORPUS:
        ops = [p[:, 0] for p in progs]
        for kw in TIMING_CFGS:
            ref = jtiming.schedule_traces_reference(
                traces, ops, policy, jtiming.TimingConfig(**kw))
            cfg = ttiming.TimingConfig(**kw)
            assert ttiming.schedule_traces_reference(traces, ops, policy,
                                                     cfg) == ref
            assert ttiming.schedule_traces(traces, ops, policy, cfg) == ref
            assert ttiming.schedule_traces(traces, progs, policy, cfg) == ref
            cases += 1
    assert cases >= 15


def test_simulate_shim_equals_reference():
    for traces, progs in CORPUS:
        for n in (1, 2):
            tr = [traces[0]] * n
            for mine_cfg, ref_cfg in (
                    (ttiming.TimingConfig(), jtiming.TimingConfig()),
                    _cycle_pair({"scoreboard": True})[::-1]):
                got = ttiming.simulate(tr, progs[0], 8, mine_cfg)
                want = jtiming.simulate(tr, progs[0], 8, ref_cfg)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert ttiming.ipc_delta(got, got) == 0.0
    empty = ttiming.simulate([], np.zeros((1, 8), dtype=np.int32), 8)
    assert (empty.cycles, empty.ipc, empty.simd_utilization) == (0, 0.0, 0.0)
