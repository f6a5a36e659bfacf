"""The port's simulator modules against the JAX package: the copied numpy
modules (ISA, assembler, suite, CFG analysis without networkx, trace diff,
timing), the numpy mechanisms, ``run_warps`` and the suite at 32 threads
against the JAX engine, and the engine (``Simulator.run_batch`` and
``compare`` through ``hanoi_torch`` on the CPU, its wall-time contract, and
the paths that are not ported yet).

Everything here is integer and bit-exact, so every comparison is equality.
The machine with the card has no JAX: there this module skips.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import asm as jasm                                # noqa: E402
from repro.core import cfg as jcfg                                # noqa: E402
from repro.core import hanoi as jh                                # noqa: E402
from repro.core import isa as jisa                                # noqa: E402
from repro.core import programs as jprograms                      # noqa: E402
from repro.core import timing as jtiming                          # noqa: E402
from repro.core import trace as jtrace                            # noqa: E402
from repro.engine import Simulator as JSimulator                  # noqa: E402
from repro_torch.core import asm as tasm                          # noqa: E402
from repro_torch.core import cfg as tcfg                          # noqa: E402
from repro_torch.core import hanoi as th                          # noqa: E402
from repro_torch.core import isa as tisa                          # noqa: E402
from repro_torch.core import programs as tprograms                # noqa: E402
from repro_torch.core import timing as ttiming                    # noqa: E402
from repro_torch.core import trace as ttrace                      # noqa: E402
from repro_torch.engine import Simulator, SimRequest              # noqa: E402
from repro_torch.engine import adapters                           # noqa: E402
from repro_torch.service.planner import plan_dispatch             # noqa: E402
from repro_torch.engine.registry import get_mechanism             # noqa: E402
from tests.progen import corpus, make_program                     # noqa: E402
from tests.test_torch_hanoi import (FIELDS, _arrays, _cases,      # noqa: E402
                                    _jax_states, _numpy_result,
                                    _torch_states, assert_matches_numpy,
                                    assert_state_equal)

CFG4 = tisa.MachineConfig(n_threads=4, max_steps=512)
CPU = {"device": "cpu"}
RESULT_FIELDS = ("finished", "steps", "fuel_left", "trace", "utilization",
                 "error")


def assert_results_equal(a, b):
    assert a.status.value == b.status.value
    for f in RESULT_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ("regs", "preds", "mem"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# the copied numpy modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [4, 8, 32])
def test_suite_programs_and_memories_equal(W):
    cfg = tisa.MachineConfig(n_threads=W)
    mine, ref = tprograms.make_suite(cfg), jprograms.make_suite(cfg)
    assert [b.name for b in mine] == [b.name for b in ref]
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.program, b.program)
        assert (a.family, a.skip_bsync_pcs, a.race_free) == \
            (b.family, b.skip_bsync_pcs, b.race_free)
        assert (a.init_mem is None) == (b.init_mem is None)
        if a.init_mem is not None:
            np.testing.assert_array_equal(a.init_mem, b.init_mem)
    for seed in (0, 7, 12345):
        np.testing.assert_array_equal(tprograms._mem(cfg, seed),
                                      jprograms._mem(cfg, seed))


@pytest.mark.parametrize("name", ["SPINLOCK_ASM", "SPINLOCK_NO_YIELD_ASM"])
def test_assembler_equal(name):
    text = getattr(jprograms, name)
    mine, ref = tasm.assemble(text), jasm.assemble(text)
    np.testing.assert_array_equal(mine, ref)
    assert tasm.disassemble(mine) == jasm.disassemble(ref)
    cfg = tisa.MachineConfig()
    assert tisa.hardware_cost_bytes(cfg) == jisa.hardware_cost_bytes(cfg)


def _cfg_inputs():
    progs = [b.program for W in (4, 32)
             for b in jprograms.make_suite(jisa.MachineConfig(n_threads=W))]
    progs += [jprograms.fig6_no_break_program(),
              jprograms.spinlock_no_yield_program()]
    for unannotated in (False, True):
        progs += [p for _, p, _ in corpus(12, 8, unannotated=unannotated)]
    return progs


def test_immediate_postdominators_equal_without_networkx():
    for prog in _cfg_inputs():
        assert tcfg.immediate_postdominators(prog) == \
            jcfg.immediate_postdominators(prog)
        succ = tcfg.build_cfg(prog)
        g = jcfg.build_cfg(prog)
        assert set(succ) == set(g.nodes)
        assert {(a, b) for a, out in succ.items() for b in out} == \
            set(g.edges)


def test_trace_diff_and_reference_schedule_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = [(int(p), int(m)) for p, m in rng.integers(0, 6, (rng.integers(
            0, 40), 2))]
        b = [(int(p), int(m)) for p, m in rng.integers(0, 6, (rng.integers(
            1, 40), 2))]
        assert ttrace.discrepancy(a, b) == jtrace.discrepancy(a, b)
        assert ttrace.levenshtein(ttrace.trace_tokens(a),
                                  ttrace.trace_tokens(b)) == \
            jtrace.levenshtein(jtrace.trace_tokens(a), jtrace.trace_tokens(b))
    cfg = jisa.MachineConfig(n_threads=8)
    suite = jprograms.make_suite(cfg)[:6]
    traces = [list(JSimulator().run(b, cfg).trace) for b in suite]
    ops = [b.program[:, 0] for b in suite]
    for policy in ("greedy_then_oldest", "round_robin"):
        assert ttiming.schedule_traces_reference(traces, ops, policy) == \
            jtiming.schedule_traces_reference(traces, ops, policy)


@pytest.mark.parametrize("mech", ["hanoi", "turing_oracle", "simt_stack",
                                  "dualpath"])
def test_numpy_mechanisms_equal(mech):
    inputs = [(b, cfg) for cfg in (CFG4, tisa.MachineConfig(n_threads=32))
              for b in jprograms.make_suite(cfg)]
    # the sync programs deadlock pre-Volta by design: 2,048 slots of fuel
    inputs += [(p, c._replace(max_steps=2048)) for _, p, c in corpus(8, 8)]
    for prog, cfg in inputs:
        assert_results_equal(Simulator(mech).run(prog, cfg),
                             JSimulator(mech).run(prog, cfg))


# ---------------------------------------------------------------------------
# the plain Hanoi path at 32 threads and over many warps
# ---------------------------------------------------------------------------

def test_suite_at_32_threads_matches_jax_and_numpy():
    """The suite on the paper's warp width (LUD runs 3,865 slots)."""
    cfg = tisa.MachineConfig(n_threads=32, max_steps=4096)
    cases = {name: c for name, c in _cases(cfg, traps=False).items()
             if not name.endswith("+skip")}
    names, *arrays = _arrays(cases, cfg)
    want = _jax_states(cfg, True, *arrays)
    got = _torch_states(cfg, True, *arrays)
    for i, name in enumerate(names):
        assert_state_equal(got, want, i)
        assert_matches_numpy(got, i, _numpy_result(cfg, cases[name], True),
                             cfg)


def test_run_warps_matches_run_warps_jax():
    """One program over warps with their own memories, registers and lane
    ids (``run_warps_jax``, the reference's vmap over warps)."""
    (prog, _), cfg = make_program(1234, 8)
    rng = np.random.default_rng(0)
    n = 6
    regs = rng.integers(-4, 4, (n, cfg.n_threads, cfg.n_regs)).astype(np.int32)
    mems = rng.integers(0, 8, (n, cfg.mem_size)).astype(np.int32)
    lanes = np.stack([rng.permutation(cfg.n_threads) for _ in range(n)]) \
        .astype(np.int32)
    skips = tuple(int(pc) for pc in np.flatnonzero(prog[:, 0] == 4))[:1]
    want = jh.run_warps_jax(prog, cfg, regs, mems, lanes,
                            bsync_skip_pcs=skips)
    got = th.run_warps(prog, cfg, regs, mems, lanes, bsync_skip_pcs=skips,
                       device="cpu")
    for k in FIELDS:
        w = np.asarray(getattr(want, k))
        g = getattr(got, k).numpy()
        if k == "trace_mask":
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _programs(mod):
    """The suite and three figures, from the port's or the reference's
    ``programs`` module: one batch shape, so hanoi_jax compiles once."""
    return mod.make_suite(CFG4) + [mod.fig5_program(), mod.fig6_program(),
                                   mod.spinlock_program()]


def test_run_batch_hanoi_torch_equals_hanoi_jax():
    progs = _programs(tprograms)
    mine = Simulator().run_batch(progs, CFG4, mechanism="hanoi_torch",
                                 meta=CPU)
    ref = JSimulator().run_batch(_programs(jprograms), CFG4,
                                 mechanism="hanoi_jax")
    assert len(mine) == len(ref) == len(progs)
    for a, b in zip(mine, ref):
        assert a.mechanism == "hanoi_torch"
        assert_results_equal(a, b)


def test_compare_rows_equal_reference():
    progs = _programs(tprograms)
    mine = Simulator().compare("hanoi_torch", progs, CFG4,
                               baseline="turing_oracle", timing=False,
                               meta=CPU)
    ref = JSimulator().compare("hanoi_jax", _programs(jprograms), CFG4,
                               baseline="turing_oracle", timing=False)
    rows = mine.pair("hanoi_torch", "turing_oracle")
    ref_rows = ref.pair("hanoi_jax", "turing_oracle")
    assert [r.program for r in rows] == [r.program for r in ref_rows]
    for a, b in zip(rows, ref_rows):
        assert (a.discrepancy, a.util_a, a.util_b, a.status_a, a.status_b,
                a.trace_len_a, a.trace_len_b) == (
            b.discrepancy, b.util_a, b.util_b, b.status_a, b.status_b,
            b.trace_len_a, b.trace_len_b)
    assert mine.mean_discrepancy("hanoi_torch", "turing_oracle") == \
        ref.mean_discrepancy("hanoi_jax", "turing_oracle")
    same = Simulator().compare(["hanoi_torch", "hanoi"], progs, CFG4,
                               timing=False, meta=CPU)
    assert all(r.discrepancy == 0.0 for r in same.rows)


def test_wall_time_excludes_the_kernel_build(monkeypatch):
    """K1's first build goes into meta["compile_time_s"] of that batch and
    never into wall_time_s (the reference's wall-time contract)."""
    import time
    build_s = 0.5
    monkeypatch.setattr(adapters, "_build_kernel",
                        lambda dev: (time.sleep(build_s), build_s)[1])
    progs = [tprograms.fig5_program(), tprograms.fig6_program()]
    res = Simulator().run_batch(progs, CFG4, mechanism="hanoi_torch",
                                meta=CPU)
    for r in res:
        assert r.meta["compile_time_s"] == build_s
        assert r.wall_time_s * len(res) < build_s
    monkeypatch.setattr(adapters, "_build_kernel", lambda dev: None)
    res = Simulator().run_batch(progs, CFG4, mechanism="hanoi_torch",
                                meta=CPU)
    assert all("compile_time_s" not in r.meta for r in res)


def test_result_assembly_copies_only_the_traces(monkeypatch):
    """Each warp's trace[:trace_n] and its small state reach the host, never
    the max_steps trace buffer."""
    cfg = CFG4._replace(max_steps=200_000)
    copied = []
    cpu = torch.Tensor.cpu

    def spy(t, *a, **kw):
        copied.append(t.numel())
        return cpu(t, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    progs = [tprograms.fig5_program(), tprograms.fig6_program()]
    res = Simulator().run_batch(progs, cfg, mechanism="hanoi_torch", meta=CPU)
    monkeypatch.undo()
    assert sum(copied) < 2_000
    for r, p in zip(res, progs):
        assert r.trace == Simulator().run(p, cfg).trace


def test_hanoi_torch_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no.*visible"):
        Simulator().run_batch([tprograms.fig5_program()], CFG4,
                              mechanism="hanoi_torch")
    mech = get_mechanism("hanoi_torch")
    assert mech.backend == "torch" and mech.batch_runner is not None
    assert not mech.uses_skip_pcs
    reqs = [SimRequest(program=tprograms.fig5_program(), cfg=CFG4),
            SimRequest(program=tprograms.fig5_program(), cfg=CFG4, meta=CPU)]
    groups = plan_dispatch(mech, reqs)
    assert [g.indices for g in groups] == [(0,), (1,)]   # never one batch


def test_unported_paths_raise_naming_the_roadmap():
    prog = tprograms.fig5_program()
    sim = Simulator()
    for call in (lambda: sim.run(prog, CFG4, verify=True),
                 lambda: sim.run_batch([prog], CFG4, synthesize=True),
                 lambda: Simulator(sink=object()),
                 lambda: sim.run_sm(prog, CFG4),
                 lambda: sim.compare("hanoi", [prog], CFG4),
                 lambda: sim.compare("hanoi", [prog], CFG4, timing="cycle"),
                 lambda: ttiming.simulate([[(0, 1)]], prog, 4),
                 lambda: ttiming.schedule_traces([[(0, 1)]], [prog[:, 0]])):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
