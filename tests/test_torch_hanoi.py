"""The port's Hanoi step machine (``repro_torch.core.hanoi``, its plain
PyTorch path on the CPU) against the JAX reference (``repro.core.hanoi``)
and the numpy ``hanoi`` mechanism.

Bit-equal is the contract: against JAX, every field of the final state
(stacks, Bx file, masks, registers, predicates, memory, the whole
``max_steps`` trace buffer, counters, fuel, error); against numpy, the
``tests/test_hanoi_jax.py::assert_equiv`` fields (registers, predicates,
memory, finished, trace, deadlock) and steps and fuel.  Inputs: the paper's
figures, the spinlock, ``make_suite`` (also with every BSYNC an oracle skip),
the divergence traps of ``test_torch_gpu.hanoi_traps`` (JAX only: they use
fields out of range on purpose), ``tests/progen.py``'s corpus in its base,
sync, mem and unannotated forms, at ``n_threads`` 4, 8 and 32, ``n_bx`` 2
and 8, ``majority_first`` on and off, and the golden traces.

The JAX side runs as its engine runs it: ``init_state`` and ``_run``,
jitted and vmapped over warps, one compile per configuration (module-scoped
fixtures).  The machine with the card has no JAX: there this module skips.
"""
import collections
import json
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import hanoi as jh                                # noqa: E402
from repro.core import programs as jprograms                      # noqa: E402
from repro.engine import Simulator as JSimulator                  # noqa: E402
from repro_torch.core import hanoi as th                          # noqa: E402
from repro_torch.core import programs as tprograms                # noqa: E402
from repro_torch.core.isa import MachineConfig, Op                # noqa: E402
from repro_torch.engine import Simulator                          # noqa: E402
from repro_torch.engine.adapters import padded_len                # noqa: E402
from tests.progen import corpus                                   # noqa: E402
from tests.test_torch_gpu import hanoi_traps                      # noqa: E402

# every program here but the out-of-fuel trap ends within 300 slots at 4
# threads; the fuel bounds the plain path's host loop
CFG4 = MachineConfig(n_threads=4, max_steps=512)
# the sync corpus without its annotations livelocks in its spinlock (no
# YIELD) and spins until its fuel is spent (20,000 slots in progen's
# config); annotated, it ends within 260 slots.  512 keep the host loop
# short, as test_hanoi_jax cuts random programs to 4,096
SYNC_FUEL, SYNC_SEEDS = 512, 12
FIELDS = th.HanoiState._fields
GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


def _cases(cfg, *, traps=True):
    """``{name: (program, init_regs, init_mem, active0, skips)}``: the
    figures, the suite (also with every BSYNC an oracle skip) and the
    traps."""
    W = cfg.n_threads
    out = {
        "fig5": (jprograms.fig5_program(), None, None, None, ()),
        "fig6": (jprograms.fig6_program(), None, None, None, ()),
        "warpsync": (jprograms.warpsync_program(W), None, None, None, ()),
        "spinlock": (jprograms.spinlock_program(), None, None, None, ()),
        "diamond": (jprograms.diamond_program(), None, None, None, ()),
    }
    for b in jprograms.make_suite(cfg):
        out[b.name] = (b.program, None, b.init_mem, None,
                       tuple(b.skip_bsync_pcs))
        bsyncs = tuple(int(pc) for pc in np.flatnonzero(
            b.program[:, 0] == int(Op.BSYNC)))
        if bsyncs:
            out[b.name + "+skip"] = (b.program, None, b.init_mem, None,
                                     bsyncs)
    if traps:
        for name, (prog, regs, mem, active0) in hanoi_traps(W).items():
            out["trap:" + name] = (prog, regs, mem, active0, ())
    return out


def _arrays(cases, cfg):
    names = list(cases)
    W, N = cfg.n_threads, len(names)
    L = padded_len(max(c[0].shape[0] for c in cases.values()))
    progs = np.zeros((N, L, 8), np.int32)
    progs[:, :, 0] = int(Op.EXIT)
    skips = np.zeros((N, L), bool)
    regs = np.zeros((N, W, cfg.n_regs), np.int32)
    mems = np.zeros((N, cfg.mem_size), np.int32)
    active = np.full(N, cfg.full_mask, np.uint32)
    for i, name in enumerate(names):
        prog, r, m, a, sk = cases[name]
        progs[i, :prog.shape[0]] = prog
        skips[i, list(sk)] = True
        if r is not None:
            regs[i] = r
        if m is not None:
            mems[i] = m
        if a is not None:
            active[i] = a
    lanes = np.broadcast_to(np.arange(W, dtype=np.int32), (N, W)).copy()
    return names, progs, skips, regs, mems, lanes, active


def _jax_states(cfg, majority_first, progs, skips, regs, mems, lanes, active):
    """The reference engine's final states, one row a warp, as numpy (u32
    masks widened to int64)."""
    def one(prog, skip, reg, mem, lane, act):
        st = jh.init_state(prog.shape[0], cfg, init_regs=reg, init_mem=mem,
                           lane_ids=lane)
        st = st._replace(ws_mask=st.ws_mask.at[0].set(act))
        return jh._run(prog, st, skip, cfg, majority_first)

    st = jax.jit(jax.vmap(one))(progs, skips, regs, mems, lanes, active)
    out = {}
    for k in FIELDS:
        a = np.asarray(getattr(st, k))
        out[k] = a.astype(np.int64) if a.dtype == np.uint32 else a
    return out


def _torch_states(cfg, majority_first, progs, skips, regs, mems, lanes,
                  active):
    """The port's plain path on the CPU, rows grouped by entry mask (one
    ``active0`` a batch), as numpy in the reference's row order."""
    out = {k: [None] * len(progs) for k in FIELDS}
    for act in np.unique(active):
        rows = np.flatnonzero(active == act)
        st = th.run_batch(progs[rows], skips[rows], cfg, init_regs=regs[rows],
                          init_mem=mems[rows], lane_ids=lanes[rows],
                          active0=None if act == cfg.full_mask else int(act),
                          majority_first=majority_first, device="cpu")
        for k in FIELDS:
            a = getattr(st, k).numpy()
            if k == "trace_mask":
                a = a.view(np.uint32).astype(np.int64)
            for j, i in enumerate(rows):
                out[k][i] = a[j]
    return {k: np.stack(v) for k, v in out.items()}


def _numpy_result(cfg, case, majority_first):
    prog, regs, mem, active0, skips = case
    mech = "turing_oracle" if skips else "hanoi"
    return JSimulator(mech).run(prog, cfg, init_regs=regs, init_mem=mem,
                                active0=active0, bsync_skip_pcs=skips,
                                majority_first=majority_first)


def assert_state_equal(got: dict, want: dict, i: int, j: int = None):
    j = i if j is None else j
    bad = [k for k in FIELDS if not np.array_equal(got[k][i], want[k][j])]
    assert not bad, f"fields differ: {bad}"


def assert_matches_numpy(st: dict, i: int, ref, cfg):
    """The ``assert_equiv`` contract of tests/test_hanoi_jax.py, plus steps
    and fuel."""
    n = int(st["trace_n"][i])
    trace = tuple(zip(st["trace_pc"][i, :n].tolist(),
                      st["trace_mask"][i, :n].tolist()))
    deadlocked = ((int(st["finished"][i]) & cfg.full_mask) != cfg.full_mask
                  or int(st["fuel"][i]) <= 0)
    assert deadlocked == ref.deadlocked
    np.testing.assert_array_equal(st["regs"][i], ref.regs)
    np.testing.assert_array_equal(st["preds"][i], ref.preds)
    np.testing.assert_array_equal(st["mem"][i], ref.mem)
    assert int(st["finished"][i]) == ref.finished
    assert trace == ref.trace
    assert int(st["steps"][i]) == ref.steps
    assert int(st["fuel"][i]) == ref.fuel_left


# ---------------------------------------------------------------------------
# figures, suite, skips and traps: one batch a configuration
# ---------------------------------------------------------------------------

RUNS = {"w4": (CFG4, True),
        "w4_nbx2_minority": (CFG4._replace(n_bx=2), False),
        # more predicates than one 32-bit word a lane
        "w4_npreds40": (CFG4._replace(n_preds=40), True)}
CASES = {run: _cases(cfg) for run, (cfg, _) in RUNS.items()}
# a divergent branch and guards on predicates past the first word
CASES["w4_npreds40"]["preds40"] = (jprograms.assemble("""
    LANEID R1
    ISETP.GE P35, R1, 2
    ISETP.LT P39, R1, 3
    @P35 IADDI R2, R1, 7
    @!P39 IADDI R3, R1, 9
    BSSY B0, join
    @P35 BRA right
    IADDI R4, R1, 1
    BRA join
right:
    IADDI R4, R1, 2
join:
    BSYNC B0
    ISETP.EQ P33, R4, 3
    @P33 MOV R5, 11
    @!P0 MOV R6, 5
    EXIT
"""), None, None, None, ())


@pytest.fixture(scope="module")
def batches():
    """run -> (names, JAX states, port states), computed on first use."""
    cache = {}

    def get(run):
        if run not in cache:
            cfg, mf = RUNS[run]
            names, *arrays = _arrays(CASES[run], cfg)
            cache[run] = (names, _jax_states(cfg, mf, *arrays),
                          _torch_states(cfg, mf, *arrays))
        return cache[run]
    return get


@pytest.mark.parametrize("run,name", [(run, name) for run in RUNS
                                      for name in CASES[run]])
def test_plain_matches_jax(batches, run, name):
    names, want, got = batches(run)
    assert_state_equal(got, want, names.index(name))


@pytest.mark.parametrize("run,name", [
    (run, name) for run in RUNS for name in CASES[run]
    if not name.startswith("trap:")])
def test_plain_matches_numpy(batches, run, name):
    cfg, mf = RUNS[run]
    names, _, got = batches(run)
    assert_matches_numpy(got, names.index(name),
                         _numpy_result(cfg, CASES[run][name], mf), cfg)


# ---------------------------------------------------------------------------
# the progen corpus
# ---------------------------------------------------------------------------

def _corpus_cases(n_bx, sync):
    """Every program of the corpus with (sync) or without the sync
    features, annotated and unannotated, grouped by machine config."""
    groups = collections.defaultdict(dict)
    for unannotated in (False, True):
        for label, prog, cfg in corpus(SYNC_SEEDS if sync else 40, n_bx,
                                       unannotated=unannotated):
            if label.startswith("sync") != sync:
                continue
            if sync:
                cfg = cfg._replace(max_steps=SYNC_FUEL)
            tag = ("un:" if unannotated else "") + label
            groups[cfg][tag] = (prog, None, None, None, ())
    [(cfg, cases)] = groups.items()
    return cfg, cases


@pytest.mark.parametrize("n_bx,sync,with_jax", [
    (8, False, True), (8, True, True), (2, False, False), (2, True, False)])
def test_corpus_matches_jax_and_numpy(n_bx, sync, with_jax):
    cfg, cases = _corpus_cases(n_bx, sync)
    names, *arrays = _arrays(cases, cfg)
    got = _torch_states(cfg, True, *arrays)
    want = _jax_states(cfg, True, *arrays) if with_jax else None
    for i, name in enumerate(names):
        if want is not None:
            assert_state_equal(got, want, i)
        assert_matches_numpy(got, i, _numpy_result(cfg, cases[name], True),
                             cfg)


# ---------------------------------------------------------------------------
# entry points and goldens
# ---------------------------------------------------------------------------

def test_run_hanoi_single_warp_entry_point():
    prog = tprograms.fig6_program()
    st = th.run_hanoi(prog, CFG4, pad_to=64, device="cpu")
    ref = _numpy_result(CFG4, (prog, None, None, None, ()), True)
    assert st.trace_pc.shape == (1, CFG4.max_steps)
    assert th.state_trace(st) == list(ref.trace)
    assert th.state_deadlocked(st, CFG4) == ref.deadlocked
    np.testing.assert_array_equal(st.regs[0].numpy(), ref.regs)
    skips = tuple(int(pc) for pc in np.flatnonzero(prog[:, 0] == Op.BSYNC))
    st = th.run_hanoi(prog, CFG4, bsync_skip_pcs=skips, device="cpu")
    ref = _numpy_result(CFG4, (prog, None, None, None, skips), True)
    assert th.state_trace(st) == list(ref.trace)


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    with pytest.raises(RuntimeError, match="no.*visible"):
        th.run_hanoi(tprograms.fig5_program(), CFG4)
    with pytest.raises(ValueError, match="n_threads"):
        th.run_hanoi(tprograms.fig5_program(),
                     MachineConfig(n_threads=33), device="cpu")


@pytest.mark.parametrize("prog_name", ["diamond", "fig5", "fig6", "warpsync"])
def test_hanoi_torch_matches_golden_trace(prog_name):
    """tests/goldens/<prog>__hanoi.jsonl: every issued (pc, mask) and the
    end summary, through ``Simulator.run(mechanism="hanoi_torch")``."""
    events = [json.loads(line) for line in
              (GOLDEN_DIR / f"{prog_name}__hanoi.jsonl").read_text()
              .splitlines()]
    begin, end = events[0], events[-1]
    cfg = MachineConfig(**begin["replay"]["cfg"])
    prog = np.asarray(begin["replay"]["program"], np.int32)
    res = Simulator().run(prog, cfg, mechanism="hanoi_torch",
                          meta={"device": "cpu"})
    assert list(res.trace) == [(e["pc"], e["mask"]) for e in events
                               if e["event"] == "issue"]
    assert (res.status.value, res.steps, res.fuel_left, res.finished,
            res.utilization, res.error) == (
        end["status"], end["steps"], end["fuel_left"], end["finished"],
        end["utilization"], end["error"])
