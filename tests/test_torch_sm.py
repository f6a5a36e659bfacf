"""The port's SM model against the JAX package: ``sm_torch`` on the CPU
(K1's and K2's plain twins) against ``repro``'s ``sm_jax`` and against
``sm_interleave``; the ported ``sm_interleave`` and ``volta_itps``;
``core/divergence.py`` and the flash-attention tile classes; ``compare``
with the IPC models; and every request ``sm_jax`` rejects.

Everything here is integer and bit-exact, so every comparison is equality
(utilization, a ratio of the same integers, too).  The machine with the
card has no JAX: there this module skips.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.core import divergence as jdiv                        # noqa: E402
from repro.core import programs as jprograms                     # noqa: E402
from repro.core.isa import MachineConfig as JCfg                 # noqa: E402
from repro.engine import SimRequest as JRequest                  # noqa: E402
from repro.engine import Simulator as JSimulator                 # noqa: E402
from repro.engine.mechanisms import sm_jax                       # noqa: E402
from repro.timing import CycleConfig as JCycleConfig             # noqa: E402
from repro_torch.core import divergence as tdiv                  # noqa: E402
from repro_torch.core import programs as tprograms               # noqa: E402
from repro_torch.core.asm import assemble                        # noqa: E402
from repro_torch.core.isa import MachineConfig                   # noqa: E402
from repro_torch.core.timing import TimingConfig                 # noqa: E402
from repro_torch.engine import SimRequest, SimStatus, Simulator  # noqa: E402
from repro_torch.engine import get_mechanism                     # noqa: E402
from repro_torch.engine.mechanisms import sm_torch               # noqa: E402
from repro_torch.kernels import flash_attention as tfa           # noqa: E402
from repro_torch.kernels import sm_sched                         # noqa: E402
from repro_torch.timing import CycleConfig                       # noqa: E402
from tests.progen import make_program                            # noqa: E402
from tests.test_torch_gpu import sched_grid                      # noqa: E402

CFG = MachineConfig(n_threads=8, mem_size=64, max_steps=20_000)
JCFG = JCfg(n_threads=8, mem_size=64, max_steps=20_000)
SUITE = tprograms.make_suite(CFG, datasets=1)
JSUITE = jprograms.make_suite(JCFG, datasets=1)
BENCH = {b.name: b for b in SUITE}
BENCHES = ("GAUS0", "RBFS0", "DIAMOND", "HOTS0")
POLICIES = ("greedy_then_oldest", "round_robin", "oldest_first")
CPU = {"device": "cpu"}
SIM, JSIM = Simulator("hanoi"), JSimulator("hanoi")


def assert_warp_equal(a, b):
    assert (a.status.value, a.trace, a.steps, a.fuel_left, a.finished,
            a.error, a.utilization) == (b.status.value, b.trace, b.steps,
                                        b.fuel_left, b.finished, b.error,
                                        b.utilization)
    for f in ("regs", "preds", "mem"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


def assert_sm_equal(a, b):
    """Bit-equality of two SmResults in every simulated field."""
    assert a.sm_trace == b.sm_trace
    assert (a.steps, a.cycles, a.thread_instructions, a.busy_cycles,
            a.issue_stall_cycles, a.scoreboard_stall_cycles,
            a.memory_stall_cycles, a.utilization, a.status.value,
            a.policy) == (b.steps, b.cycles, b.thread_instructions,
                          b.busy_cycles, b.issue_stall_cycles,
                          b.scoreboard_stall_cycles, b.memory_stall_cycles,
                          b.utilization, b.status.value, b.policy)
    assert len(a.warps) == len(b.warps)
    for wa, wb in zip(a.warps, b.warps):
        assert_warp_equal(wa, wb)


def _progen_pairs():
    pairs = []
    for seed in range(4):
        for sf, mf in ((True, False), (False, True)):
            built, cfg = make_program(seed, 8, sync_features=sf,
                                      mem_features=mf)
            if built is not None:
                pairs.append((built[0], built[1],
                              MachineConfig(**cfg._asdict())))
    return pairs


PROGEN = _progen_pairs()


def _grids(width):
    """Homogeneous cells of the suite benches and of the progen corpus,
    ``width`` warps each, as (port cells, reference cells)."""
    mine, ref = [], []
    for name in BENCHES:
        b, jb = BENCH[name], next(x for x in JSUITE if x.name == name)
        mine.append([SimRequest(program=b.program, cfg=CFG,
                                init_mem=b.init_mem, meta=CPU)] * width)
        ref.append([JRequest(program=jb.program, cfg=JCFG,
                             init_mem=jb.init_mem)] * width)
    grids = [(mine, ref)]
    by_cfg: dict = {}                     # one grid shares one cfg
    for p, m, cfg in PROGEN:
        by_cfg.setdefault(cfg, []).append((p, m))
    for cfg, progs in by_cfg.items():
        jcfg = JCfg(**cfg._asdict())
        grids.append(([[SimRequest(program=p, cfg=cfg, init_mem=m,
                                   meta=CPU)] * width for p, m in progs],
                      [[JRequest(program=p, cfg=jcfg, init_mem=m)] * width
                       for p, m in progs]))
    return grids


# ---------------------------------------------------------------------------
# sm_torch (the twins of K1 and K2) == sm_jax == sm_interleave
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 4, 8, 33])
@pytest.mark.parametrize("policy", POLICIES)
def test_sm_torch_matches_sm_jax_and_interleave(policy, width):
    """Suite benches and the progen corpus (sync and memory features) at
    1, 4, 8 and 33 warps a cell: the whole grid through run_cells on the
    CPU equals the reference's sm_jax grid and the ported sm_interleave,
    cell by cell."""
    for mine, ref in _grids(width):
        got = sm_torch.run_cells(mine, policy=policy)
        want = sm_jax.run_cells(ref, policy=policy, inner_label="hanoi")
        for g, w, cell in zip(got, want, mine):
            assert g.mechanism == "sm_torch" and g.inner == "hanoi_torch"
            assert_sm_equal(g, w)
            p = SIM.run_sm(list(cell), policy=policy,
                           sm_mechanism="sm_interleave")
            assert p.mechanism == "sm_interleave"
            assert_sm_equal(g, p)


def test_sm_torch_heterogeneous_cells_and_ndarray_stack():
    """run_sm routing: heterogeneous per-warp programs (cells of 3 and of
    33 distinct warps) and a 3-D stacked ndarray."""
    names = ["DIAMOND", "HOTS0", "BFSD"]
    progs = [BENCH[n] for n in names]
    jprogs = [next(x for x in JSUITE if x.name == n) for n in names]
    for policy in POLICIES:
        j = SIM.run_sm(progs, CFG, inner="hanoi_torch", policy=policy,
                       sm_mechanism="sm_torch", meta=CPU)
        p = SIM.run_sm(progs, CFG, inner="hanoi", policy=policy,
                       sm_mechanism="sm_interleave")
        r = JSIM.run_sm(jprogs, JCFG, inner="hanoi", policy=policy,
                        sm_mechanism="sm_jax")
        assert j.n_warps == 3 and len(j.requests) == 3
        assert_sm_equal(j, p)
        assert_sm_equal(j, r)
    mixed = [SUITE[i % len(SUITE)] for i in range(33)]
    for policy in POLICIES:
        j = SIM.run_sm(mixed, CFG, policy=policy, sm_mechanism="sm_torch",
                       meta=CPU)
        assert_sm_equal(j, SIM.run_sm(mixed, CFG, policy=policy,
                                      sm_mechanism="sm_interleave"))
    stack = np.stack([BENCH["DIAMOND"].program] * 3)
    j = SIM.run_sm(stack, CFG, policy="round_robin", sm_mechanism="sm_torch",
                   meta=CPU)
    assert j.n_warps == 3
    assert_sm_equal(j, SIM.run_sm(stack, CFG, policy="round_robin",
                                  sm_mechanism="sm_interleave"))


def test_run_batch_sm_torch_matches_sm_jax():
    """The registered mechanism: one grid of signature-homogeneous cells a
    batch, SimResult mirroring warp 0 and the interleaved trace."""
    for policy in POLICIES:
        meta = {"sm_warps": 4, "sm_inner": "hanoi_torch", "sm_policy": policy}
        reqs = [SimRequest(program=BENCH[n].program, cfg=CFG, name=n,
                           init_mem=BENCH[n].init_mem,
                           meta={**meta, **CPU}) for n in BENCHES]
        jreqs = [JRequest(program=q.program, cfg=JCFG, name=q.name,
                          init_mem=q.init_mem,
                          meta={**meta, "sm_inner": "hanoi_jax"})
                 for q in reqs]
        got = SIM.run_batch(reqs, mechanism="sm_torch")
        want = JSIM.run_batch(jreqs, mechanism="sm_jax")
        for a, b in zip(got, want):
            sm = a.meta["sm"]
            assert a.mechanism == "sm_torch" and sm.mechanism == "sm_torch"
            assert_sm_equal(sm, b.meta["sm"])
            assert a.trace == tuple((pc, m) for _, pc, m in sm.sm_trace)
            assert a.trace == b.trace and a.status.value == b.status.value
            np.testing.assert_array_equal(a.regs, b.regs)
    mech = get_mechanism("sm_torch")
    assert mech.backend == "torch" and mech.batch_runner is not None
    assert {"sm", "multi-warp", "composite", "vectorized"} <= set(mech.tags)


def test_non_default_latencies_and_no_trace():
    """A non-default trace-conservative TimingConfig moves cycles and
    stalls alike in sm_torch and sm_interleave; a grid that records no
    trace schedules nothing."""
    b = BENCH["HOTS0"]
    for tcfg in (TimingConfig(alu_latency=4, memory_latency=100),
                 CycleConfig(scoreboard=False, alu_latency=2,
                             control_latency=3, memory_latency=40,
                             atomic_latency=90)):
        j = SIM.run_sm(b, CFG, n_warps=5, policy="greedy_then_oldest",
                       timing_cfg=tcfg, sm_mechanism="sm_torch", meta=CPU)
        assert_sm_equal(j, SIM.run_sm(b, CFG, n_warps=5,
                                      policy="greedy_then_oldest",
                                      timing_cfg=tcfg,
                                      sm_mechanism="sm_interleave"))
    quiet = [[SimRequest(program=b.program, cfg=CFG, init_mem=b.init_mem,
                         record_trace=False, meta=CPU)] * 2]
    (sm,) = sm_torch.run_cells(quiet)
    assert sm.sm_trace == () and sm.cycles == 0 and sm.steps == 0


def test_sm_torch_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no.*visible"):
        SIM.run_sm(BENCH["DIAMOND"], CFG, sm_mechanism="sm_torch")


@pytest.mark.parametrize("name", BENCHES)
def test_run_sm_defaults_on_the_cpu_equal_sm_jax_and_interleave(name):
    """``Simulator(device="cpu").run_sm`` with its defaults (4 identical
    warps, round robin, inner ``hanoi_torch``) is ``sm_torch`` on the
    plain twins, and equals the reference's ``sm_jax`` and the port's
    ``sm_interleave``."""
    b, jb = BENCH[name], next(x for x in JSUITE if x.name == name)
    got = Simulator(device="cpu").run_sm(b, CFG)
    assert (got.mechanism, got.inner, got.n_warps) == ("sm_torch",
                                                        "hanoi_torch", 4)
    assert_sm_equal(got, JSIM.run_sm(jb, JCFG, inner="hanoi",
                                     sm_mechanism="sm_jax"))
    assert_sm_equal(got, Simulator(device="cpu").run_sm(
        b, CFG, sm_mechanism="sm_interleave"))


def test_run_sm_default_engine_follows_the_inner():
    """``sm_mechanism=None`` is ``sm_torch`` over a hanoi inner and
    ``sm_interleave`` over any other (``sm_torch`` takes only hanoi
    inners); a composite default mechanism falls back to ``hanoi_torch``."""
    b, jb = BENCH["DIAMOND"], next(x for x in JSUITE if x.name == "DIAMOND")
    sim = Simulator(device="cpu")
    for inner in ("simt_stack", "volta_itps"):
        got = sim.run_sm(b, CFG, inner=inner, policy="greedy_then_oldest")
        assert got.mechanism == "sm_interleave" and got.inner == inner
        assert_sm_equal(got, JSIM.run_sm(jb, JCFG, inner=inner,
                                         policy="greedy_then_oldest"))
    assert sim.run_sm(b, CFG, inner="hanoi").mechanism == "sm_torch"
    sm = Simulator("sm_torch", device="cpu").run_sm(b, CFG)
    assert (sm.mechanism, sm.inner) == ("sm_torch", "hanoi_torch")


# ---------------------------------------------------------------------------
# K2's twin: the schedule's buffers, fill included
# ---------------------------------------------------------------------------

def test_schedule_fill_and_an_empty_trace():
    """Slots past a cell's total are (-1, -1, 0); a warp with an empty
    trace never issues; a pc out of the program reads as NOP."""
    traces_pc = torch.tensor([[0, 1, 5, -1], [2, 0, -1, -1]],
                             dtype=torch.int32)
    traces_mask = torch.tensor([[3, 1, 7, 0], [15, 2, 0, 0]],
                               dtype=torch.int32)
    ops = torch.tensor([[14, 24, 1], [24, 14, 1]], dtype=torch.int32)
    warp_map = torch.tensor([[0, 1, 1], [1, 0, 0]], dtype=torch.int32)
    trace_n = torch.tensor([[3, 2, 0], [2, 0, 1]], dtype=torch.int32)
    lat, is_mem = sm_torch._latency_tables(CycleConfig(scoreboard=False))
    s = sm_sched.sm_schedule_plain(warp_map, trace_n, ops, traces_pc,
                                   traces_mask, lat, is_mem, out_cap=32,
                                   policy="round_robin")
    assert s.issued.tolist() == [5, 3]
    assert s.warp[0, :5].tolist() == [0, 1, 0, 1, 0]
    assert s.pc[0, :5].tolist() == [0, 2, 1, 0, 5]     # pc 5: past L, NOP
    assert (s.warp[:, 5:] == -1).all() and (s.pc[0, 5:] == -1).all()
    assert (s.mask[0, 5:] == 0).all() and (s.warp[1, 3:] == -1).all()
    assert 2 not in s.warp[0].tolist()                 # empty trace
    assert s.tinstr.tolist() == [2 + 4 + 1 + 1 + 3, 4 + 1 + 2]


@pytest.mark.parametrize("N,policy,lats,all_memory", [
    (7, "greedy_then_oldest", {}, False), (7, "round_robin", {}, False),
    (7, "oldest_first", {}, False), (100, "greedy_then_oldest", {}, False),
    (100, "round_robin", {}, False), (100, "oldest_first", {}, False),
    (33, "greedy_then_oldest", {"alu_latency": 4, "memory_latency": 100},
     False),
    (33, "round_robin", {"alu_latency": 4, "memory_latency": 100}, True)])
def test_schedule_twin_matches_jax_scheduler(N, policy, lats, all_memory):
    """K2's twin against the reference's compiled grid scheduler on
    synthetic grids: pcs out of the program, opcodes out of range, empty
    traces, cells of 7, 33 and 100 warps, slow latencies, all-memory
    cells; every output, the fill past each cell's total included."""
    from repro.engine.mechanisms.sm_jax import _compiled_grid_scheduler
    from repro.timing.policies import POLICY_NAMES
    warp_map, trace_n, ops, trace_pc, trace_mask = sched_grid(
        N, 5, N, all_memory=all_memory)
    ccfg = CycleConfig(scoreboard=False, **lats)
    lat, is_mem = sm_torch._latency_tables(ccfg)
    out_cap = sm_torch._out_capacity(int(trace_n.sum(1).max()))
    got = sm_sched.sm_schedule_plain(
        *(torch.from_numpy(a) for a in (warp_map, trace_n, ops, trace_pc,
                                        trace_mask)),
        lat, is_mem, out_cap=out_cap, policy=policy)
    sched, _ = _compiled_grid_scheduler(
        5, N, ops.shape[0], trace_pc.shape[1], ops.shape[1], out_cap,
        POLICY_NAMES.index(policy), (ccfg.alu_latency, ccfg.control_latency,
                                     ccfg.memory_latency,
                                     ccfg.atomic_latency))
    want = [np.asarray(x) for x in sched(
        warp_map, trace_n, ops[warp_map], trace_pc,
        trace_mask.view(np.uint32))]
    want[2] = want[2].view(np.int32)
    for k, w in zip(sm_sched.Schedule._fields, want):
        np.testing.assert_array_equal(getattr(got, k).numpy(), w,
                                      err_msg=k)
    if all_memory:
        assert int(got.mstall.sum()) > 0


# ---------------------------------------------------------------------------
# rejections: everything sm_jax rejects
# ---------------------------------------------------------------------------

def test_sm_torch_rejects_unsupported_inner_and_timing():
    b = BENCH["DIAMOND"]

    def run(**kw):
        return SIM.run_sm(b, CFG, sm_mechanism="sm_torch", meta=CPU, **kw)
    with pytest.raises(ValueError, match="hanoi lane step"):
        run(inner="volta_itps")
    with pytest.raises(ValueError, match="composite"):
        run(inner="sm_interleave")
    with pytest.raises(ValueError, match="sm_mechanism"):
        SIM.run_sm(b, CFG, sm_mechanism="sm_vulkan")
    with pytest.raises(ValueError, match="sm_torch"):
        SIM.run_sm(b, CFG, sm_mechanism="sm_jax")
    with pytest.raises(ValueError, match="scoreboard"):
        run(timing_cfg=CycleConfig(scoreboard=True))
    with pytest.raises(ValueError, match="stochastic-memory"):
        run(timing_cfg=CycleConfig(scoreboard=False, memory_model="uniform"))
    with pytest.raises(ValueError, match="dual-issue"):
        run(timing_cfg=CycleConfig(scoreboard=False, issue_width=2))
    with pytest.raises(ValueError, match="latencies >= 1"):
        run(timing_cfg=TimingConfig(alu_latency=0))
    # the reference rejects the same requests
    with pytest.raises(ValueError, match="scoreboard"):
        JSIM.run_sm(next(x for x in JSUITE if x.name == "DIAMOND"), JCFG,
                    sm_mechanism="sm_jax",
                    timing_cfg=JCycleConfig(scoreboard=True))
    # the registered mechanism checks its sm_inner
    for inner, match in (("volta_itps", "hanoi lane step"),
                         ("sm_interleave", "composite")):
        req = SimRequest(program=b.program, cfg=CFG,
                         meta={"sm_inner": inner, **CPU})
        with pytest.raises(ValueError, match=match):
            SIM.run_batch([req], mechanism="sm_torch")


def test_run_cells_rejects_what_sm_jax_rejects():
    b = BENCH["DIAMOND"]
    q = SimRequest(program=b.program, cfg=CFG, meta=CPU)
    for cells, match in (
            ([], "at least one warp"),
            ([[q], []], "at least one warp"),
            ([[q], [q, q]], "share a warp count"),
            ([[q, SimRequest(program=b.program, cfg=CFG._replace(
                n_threads=4), meta=CPU)]], "share cfg"),
            ([[q, SimRequest(program=b.program, cfg=CFG,
                             majority_first=False, meta=CPU)]], "share cfg"),
            ([[q, SimRequest(program=b.program, cfg=CFG, record_trace=False,
                             meta=CPU)]], "share cfg"),
            ([[SimRequest(program=b.program, cfg=CFG, active0=1,
                          meta=CPU)]], "full entry mask")):
        with pytest.raises(ValueError, match=match):
            sm_torch.run_cells(cells)
    with pytest.raises(ValueError, match="hanoi lane step"):
        sm_torch.run_cells([[q]], inner_label="simt_stack")


# ---------------------------------------------------------------------------
# the copied numpy mechanisms: sm_interleave, volta_itps
# ---------------------------------------------------------------------------

_SPLIT_RENDEZVOUS = """
    LANEID R1
    ISETP.GE P0, R1, 4
    @P0 BRA other
    WARPSYNC 255
    EXIT
other:
    WARPSYNC 255
    EXIT
"""


def _volta_cases():
    """(program, memory, cfg): the suite, both spinlocks, a split
    rendezvous and the progen corpus."""
    cases = [(b.program, b.init_mem, CFG) for b in SUITE]
    cases += [(tprograms.spinlock_program(), None, CFG),
              (tprograms.spinlock_no_yield_program(), None, CFG),
              (assemble(_SPLIT_RENDEZVOUS), None, CFG)]
    return cases + PROGEN


def test_volta_itps_equals_reference():
    for prog, mem, cfg in _volta_cases():
        jcfg = JCfg(**cfg._asdict())
        got = SIM.run(prog, cfg, mechanism="volta_itps", init_mem=mem)
        want = JSIM.run(prog, jcfg, mechanism="volta_itps", init_mem=mem)
        assert_warp_equal(got, want)
    r = SIM.run(assemble(_SPLIT_RENDEZVOUS), CFG, mechanism="volta_itps")
    assert r.status is SimStatus.DEADLOCK and r.fuel_left > 0
    spin = SIM.run(tprograms.spinlock_no_yield_program(), CFG,
                   mechanism="volta_itps")
    assert spin.ok and int(spin.mem[1]) == CFG.n_threads


@pytest.mark.parametrize("policy", POLICIES)
def test_sm_interleave_equals_reference(policy):
    """The ported sm_interleave (numpy hanoi inner) equals the reference's,
    also on the YIELD-less spinlock, where Hanoi deadlocks structurally."""
    progs = [(BENCH[n].program, BENCH[n].init_mem) for n in BENCHES]
    progs.append((tprograms.spinlock_no_yield_program(), None))
    for prog, mem in progs:
        for n in (1, 3):
            got = SIM.run_sm(prog, CFG, n_warps=n, policy=policy,
                             init_mem=mem, sm_mechanism="sm_interleave")
            want = JSIM.run_sm(prog, JCFG, n_warps=n, policy=policy,
                               init_mem=mem)
            assert_sm_equal(got, want)
    stuck = SIM.run_sm(tprograms.spinlock_no_yield_program(), CFG,
                       n_warps=2, policy=policy, sm_mechanism="sm_interleave")
    assert not stuck.ok and stuck.status is not SimStatus.OK


# ---------------------------------------------------------------------------
# core/divergence.py and the flash-attention tile classes
# ---------------------------------------------------------------------------

_GRIDS = [(256, 256, dict(causal=True, window=0), 64),
          (1024, 1024, dict(causal=True, window=64), 128),
          (512, 512, dict(causal=False, window=128), 64),
          (256, 512, dict(causal=False, kv_len=256), 128),
          (4096, 4096, dict(causal=True, window=1024), 128),
          (384, 640, dict(causal=True, window=200, kv_len=600), 64)]


@pytest.mark.parametrize("sq,sk,spec,bq", _GRIDS)
def test_divergence_census_equals_reference(sq, sk, spec, bq):
    mine = tdiv.classify_grid(sq, sk, tdiv.MaskSpec(**spec), bq=bq, bk=bq)
    ref = jdiv.classify_grid(sq, sk, jdiv.MaskSpec(**spec), bq=bq, bk=bq)
    np.testing.assert_array_equal(mine, ref)
    assert tdiv.census(mine) == jdiv.census(ref)
    assert tdiv.schedule_order(mine) == jdiv.schedule_order(ref)
    # the port's flash-attention tile classes agree on every tile
    kv_len = spec.get("kv_len") or sk
    for i in range(mine.shape[0]):
        for j in range(mine.shape[1]):
            empty, full = tfa._tile_class(i * bq, j * bq, bq, bq,
                                          causal=spec["causal"],
                                          window=spec.get("window", 0),
                                          kv_len=kv_len)
            want = tdiv.EMPTY if empty else (tdiv.FULL if full
                                             else tdiv.PARTIAL)
            assert mine[i, j] == want, (i, j)


# ---------------------------------------------------------------------------
# compare with the IPC models (Fig 10)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timing", [True, "trace", "cycle"])
def test_compare_timing_rows_equal_reference(timing):
    cfg = MachineConfig(n_threads=4, max_steps=512)
    jcfg = JCfg(n_threads=4, max_steps=512)
    mine = SIM.compare("hanoi_torch", tprograms.make_suite(cfg), cfg,
                       baseline="turing_oracle", timing=timing, meta=CPU)
    ref = JSIM.compare("hanoi", jprograms.make_suite(jcfg), jcfg,
                       baseline="turing_oracle", timing=timing)
    rows = mine.pair("hanoi_torch", "turing_oracle")
    ref_rows = ref.pair("hanoi", "turing_oracle")
    assert [r.program for r in rows] == [r.program for r in ref_rows]
    for a, b in zip(rows, ref_rows):
        assert (a.discrepancy, a.ipc_a, a.ipc_b, a.ipc_delta, a.util_a,
                a.util_b, a.status_a, a.status_b, a.trace_len_a,
                a.trace_len_b) == (b.discrepancy, b.ipc_a, b.ipc_b,
                                   b.ipc_delta, b.util_a, b.util_b,
                                   b.status_a, b.status_b, b.trace_len_a,
                                   b.trace_len_b)
    assert mine.mean_abs_ipc_delta("hanoi_torch", "turing_oracle") == \
        ref.mean_abs_ipc_delta("hanoi", "turing_oracle")
    assert sorted(mine.timing_results) == sorted(
        (p, m.replace("hanoi", "hanoi_torch") if m == "hanoi" else m)
        for p, m in ref.timing_results)
