"""``sm_torch`` — the whole SM grid on the card: K1 for the warps, K2 for
the issue schedule.

Port of ``repro.engine.mechanisms.sm_jax``.  ``sm_interleave`` time-
multiplexes warps in Python, one issue slot per iteration of
:func:`repro_torch.timing.schedule_cycle`.  This module runs the same SM
model as two launches on the card for a whole grid of SM cells:

1. **warp phase** — the grid's warp rows, hash-consed (identical rows run
   once), run the paper's Hanoi mechanism in one launch of K1
   (:func:`repro_torch.kernels.ops.hanoi_run`), the kernel behind
   ``hanoi_torch``;
2. **scheduler phase** — one launch of K2
   (:func:`repro_torch.kernels.ops.sm_schedule`) steps every cell: per-warp
   trace cursors, ready times and memory-blocked flags, and the issue
   policy as an argmin over the
   :func:`repro_torch.timing.policies.priority_keys` formulation.  K1's
   trace buffers stay on the device and K2 reads them there; only the
   per-slot outputs and the counters come back.

The schedule reproduces :func:`repro_torch.timing.schedule_cycle`'s
trace-conservative single-issue fixed-latency mode bit for bit: the
``(warp, pc, mask)`` SM trace, cycle count and the busy / issue /
scoreboard / memory stall taxonomy all equal ``sm_interleave``'s.
Scoreboard mode, dual issue and stochastic memory models stay
``sm_interleave``'s; requests asking for them are rejected, never
approximated.

Request options mirror ``sm_interleave`` (``sm_warps`` / ``sm_policy``);
``sm_inner`` must name a Hanoi engine (``hanoi`` or ``hanoi_torch``: the
warp phase *is* K1, bit-identical to both).  The device is the card unless
the requests ask for the CPU by name (``meta={"device": "cpu"}``), where K1
and K2 are replaced by their plain twins.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core.isa import ATOMIC_OPS, F_OP, MEMORY_OPS, Op
from repro_torch.core.timing import TimingConfig
from repro_torch.timing import CycleConfig
from repro_torch.timing.policies import resolve_policy_name
from repro_torch.timing.sm_model import _CONTROL_LAT_OPS

from ..adapters import (_batch_arrays, _device_of, _sync, padded_len,
                        prepare_launch, state_results)
from ..registry import get_mechanism, register_mechanism
from ..types import SimRequest, SimResult, SmResult, worst_status
from .sm import DEFAULT_POLICY, _sm_options

__all__ = ["run_cells"]

# hanoi engines the warp phase is bit-identical to (it *is* K1, the
# hanoi_torch kernel); anything else must go through sm_interleave
_SUPPORTED_INNER = ("hanoi", "hanoi_torch")

_N_OPS = max(int(op) for op in Op) + 1


def _supported_cycle_cfg(tcfg) -> CycleConfig:
    """Validate that the cycle model requested is the one sm_torch runs."""
    ccfg = CycleConfig.from_timing(tcfg)     # default lift: trace-conservative
    if ccfg.scoreboard or ccfg.issue_width != 1 \
            or ccfg.memory_model != "fixed":
        raise ValueError(
            "sm_torch schedules in the trace-conservative, single-issue, "
            "fixed-latency mode (the sm_interleave default); use "
            "sm_interleave for scoreboard / dual-issue / stochastic-memory "
            "cycle models")
    if min(ccfg.alu_latency, ccfg.control_latency,
           ccfg.memory_latency, ccfg.atomic_latency) < 1:
        raise ValueError("sm_torch requires all class latencies >= 1")
    return ccfg


def _latency_tables(ccfg: CycleConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per-opcode ``(issue latency, blocks-on-memory?)`` lookup tables —
    the array form of ``schedule_cycle``'s latency classification."""
    lat = np.full(_N_OPS, ccfg.alu_latency, np.int32)
    for op in _CONTROL_LAT_OPS:
        lat[int(op)] = ccfg.control_latency
    for op in MEMORY_OPS:                    # includes atomics; atomics
        lat[int(op)] = ccfg.memory_latency   # override below
    for op in ATOMIC_OPS:
        lat[int(op)] = ccfg.atomic_latency
    is_mem = np.zeros(_N_OPS, bool)
    for op in MEMORY_OPS:
        is_mem[int(op)] = True
    return lat, is_mem


def _out_capacity(n: int) -> int:
    """Issue-slot capacity class: a power of two with a floor, so the
    schedule buffers take a few coarse shapes, not one per grid."""
    return max(256, 1 << max(0, int(n) - 1).bit_length())


def _dedupe_rows(progs: np.ndarray, skips: np.ndarray, regs: np.ndarray,
                 mems: np.ndarray, lanes: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Hash-cons warp rows: ``(first, inv)`` with ``first`` the indices of
    the unique rows (in first-seen order) and ``inv[i]`` the unique slot of
    row ``i``.  Execution is a pure function of the row operands (the
    resolved config and ``majority_first`` are grid-wide), so identical
    rows — N replicated warps of a cell, repeated cells of a grid — run
    the lane program once and share one result."""
    uniq: dict[bytes, int] = {}
    first: list[int] = []
    inv = np.empty(progs.shape[0], np.int64)
    for i in range(progs.shape[0]):
        key = (progs[i].tobytes() + skips[i].tobytes() + regs[i].tobytes()
               + mems[i].tobytes() + lanes[i].tobytes())
        u = uniq.get(key)
        if u is None:
            u = len(first)
            uniq[key] = u
            first.append(i)
        inv[i] = u
    return np.asarray(first, np.int64), inv


class Grid(NamedTuple):
    """One validated grid of SM cells and its warp-phase operands."""

    cells: tuple            # cells[c][w]: SimRequest
    flat: tuple             # the warps, cell-major
    cfg: object             # the resolved MachineConfig, grid-wide
    majority_first: bool
    record_trace: bool
    policy: str             # canonical policy name
    ccfg: CycleConfig       # the cycle model (trace-conservative)
    inner: str
    device: object          # torch.device
    first: np.ndarray       # unique rows: indices into flat
    inv: np.ndarray         # flat row -> unique row
    warp_operands: tuple    # (progs, skips, regs, mems, lanes) of the rows
    ops: object             # i32[U, L] each unique row's opcode column


def grid_of(cells: Sequence[Sequence[SimRequest]], *,
            policy: str = DEFAULT_POLICY,
            timing_cfg: "TimingConfig | CycleConfig" = TimingConfig(),
            inner_label: str = "hanoi_torch") -> Grid:
    """Validate a grid (everything ``sm_jax`` rejects is rejected here) and
    build its hash-consed warp operands on the requests' device."""
    import torch

    policy_name = resolve_policy_name(policy)
    ccfg = _supported_cycle_cfg(timing_cfg)
    if inner_label not in _SUPPORTED_INNER:
        raise ValueError(
            f"sm_torch executes warps on the hanoi lane step (kernel K1); "
            f"inner must be one of {_SUPPORTED_INNER}, got {inner_label!r} "
            f"— use sm_interleave for other inner mechanisms")
    if not cells or any(not cell for cell in cells):
        raise ValueError("run_cells needs at least one warp per cell")
    n_warps = len(cells[0])
    if any(len(cell) != n_warps for cell in cells):
        raise ValueError("all cells in one sm_torch grid must share a warp "
                         "count")
    flat = [q for cell in cells for q in cell]
    cfg = flat[0].resolved_cfg()
    mf, record = flat[0].majority_first, flat[0].record_trace
    device = flat[0].meta.get("device")
    for q in flat:
        if q.resolved_cfg() != cfg or q.majority_first != mf \
                or q.record_trace != record \
                or q.meta.get("device") != device:
            raise ValueError("sm_torch warps must share cfg, majority_first "
                             "and record_trace (and the device) across the "
                             "grid")
        if q.active0 is not None:
            raise ValueError("sm_torch assumes a full entry mask "
                             "(active0=None)")
    dev = _device_of(flat[0])
    L = padded_len(max(int(np.asarray(q.program).shape[0]) for q in flat))
    arrays = _batch_arrays(flat, cfg, L)
    first, inv = _dedupe_rows(*arrays)
    rows = [torch.from_numpy(np.ascontiguousarray(a[first])).to(dev)
            for a in arrays]
    ops = rows[0][:, :, F_OP].contiguous()
    return Grid(tuple(tuple(c) for c in cells), tuple(flat), cfg, bool(mf),
                bool(record), policy_name, ccfg, inner_label, dev, first,
                inv, tuple(rows), ops)


def schedule_operands(grid: Grid, state):
    """K2's grid operands from the warp phase's Hanoi state:
    ``(warp_map, trace_n, out_cap)``, or None when nothing is scheduled (no
    traces recorded, or every trace empty).  Only the unique rows' trace
    lengths come to the host."""
    import torch

    if not grid.record_trace:
        return None
    C, N = len(grid.cells), len(grid.cells[0])
    trace_n = state.trace_n.cpu().numpy()[grid.inv].reshape(C, N)
    if int(trace_n.max(initial=0)) <= 0:
        return None
    out_cap = _out_capacity(int(trace_n.sum(axis=1).max()))
    warp_map = torch.from_numpy(grid.inv.reshape(C, N).astype(np.int32))
    return (warp_map.to(grid.device),
            torch.from_numpy(trace_n.astype(np.int32)).to(grid.device),
            out_cap)


def assemble(grid: Grid, state, sched, *, exec_s: float = 0.0,
             compile_s: "float | None" = None) -> list[SmResult]:
    """One :class:`SmResult` per cell from the warp phase's state and the
    scheduler phase's :class:`~repro_torch.kernels.sm_sched.Schedule`
    (None when nothing was scheduled).  The per-slot outputs come to the
    host up to the longest cell's total."""
    C, N = len(grid.cells), len(grid.cells[0])
    warp_wall = exec_s / max(1, len(grid.flat))
    cell_wall = exec_s / max(1, C)
    sm_meta = {"compile_time_s": compile_s} if compile_s else {}
    width = grid.cfg.n_threads
    # one SimResult per unique row, shared by every warp that hash-consed
    # onto it (SimResult is frozen; SmResult.requests keeps per-warp names)
    uniq_results = state_results([grid.flat[int(i)] for i in grid.first],
                                 state, warp_wall)
    if sched is not None:
        counters = {k: getattr(sched, k).cpu().numpy().tolist() for k in
                    ("issued", "cycle", "busy", "istall", "sstall", "mstall",
                     "tinstr")}
        n_max = max(counters["issued"])
        ow, opc, om = (t[:, :n_max].cpu().numpy()
                       for t in (sched.warp, sched.pc, sched.mask))
        om = om.view(np.uint32)
    sms: list[SmResult] = []
    for c, cell in enumerate(grid.cells):
        warps = tuple(uniq_results[grid.inv[i]]
                      for i in range(c * N, (c + 1) * N))
        if sched is not None:
            n_c = counters["issued"][c]
            sm_trace = tuple(zip(ow[c, :n_c].tolist(), opc[c, :n_c].tolist(),
                                 om[c, :n_c].tolist()))
            tinstr = counters["tinstr"][c]
            kw = dict(steps=n_c, cycles=counters["cycle"][c],
                      thread_instructions=tinstr,
                      utilization=tinstr / max(1, n_c * width),
                      busy_cycles=counters["busy"][c],
                      issue_stall_cycles=counters["istall"][c],
                      scoreboard_stall_cycles=counters["sstall"][c],
                      memory_stall_cycles=counters["mstall"][c])
        else:
            sm_trace = ()
            kw = dict(steps=0, cycles=0, thread_instructions=0,
                      utilization=0.0, busy_cycles=0, issue_stall_cycles=0,
                      scoreboard_stall_cycles=0, memory_stall_cycles=0)
        sms.append(SmResult(
            mechanism="sm_torch", inner=grid.inner, policy=grid.policy,
            warps=warps, sm_trace=sm_trace,
            status=worst_status([r.status for r in warps]),
            requests=tuple(cell), wall_time_s=cell_wall, meta=sm_meta,
            **kw))
    return sms


def run_cells(cells: Sequence[Sequence[SimRequest]], *,
              policy: str = DEFAULT_POLICY,
              timing_cfg: "TimingConfig | CycleConfig" = TimingConfig(),
              inner_label: str = "hanoi_torch") -> list[SmResult]:
    """Run a grid of SM cells — ``cells[c][w]`` is cell *c*'s warp *w* —
    in one launch of K1 and one of K2; returns one
    :class:`~repro_torch.engine.types.SmResult` per cell.

    Every warp request across the grid must share its resolved config,
    ``majority_first``, ``record_trace``, its device and a full entry mask;
    warps may differ in program, memory image, registers and lane ids
    (heterogeneous cells).  All cells must have the same warp count.

    Wall-time accounting as ``hanoi_torch``'s: execution only (both
    launches), a kernel-cache miss's library load in
    ``meta["compile_time_s"]``.  The K1 launch counts into the kernel cache
    under ``("hanoi_torch", cfg, majority_first, unique rows, pad_len)``,
    the K2 launch under ``("sm_torch", cfg, majority_first, warps a cell,
    pad_len)``.
    """
    from repro_torch.kernels import ops

    grid = grid_of(cells, policy=policy, timing_cfg=timing_cfg,
                   inner_label=inner_label)
    dev = grid.device
    key = (grid.cfg, grid.majority_first)
    L = grid.ops.shape[1]
    # the warp phase's K1 launch counts into the kernel cache under the
    # hanoi_torch key of its unique rows, as sm_jax's under hanoi_jax's
    compile_s = prepare_launch("hanoi_torch", *key, len(grid.first), L, dev)
    _sync(dev)
    t0 = time.perf_counter()
    state = ops.hanoi_run(*grid.warp_operands, grid.cfg,
                          majority_first=grid.majority_first)
    _sync(dev)
    exec_s = time.perf_counter() - t0
    sched = None
    operands = schedule_operands(grid, state)
    if operands is not None:
        warp_map, trace_n, out_cap = operands
        lat, is_mem = _latency_tables(grid.ccfg)
        sched_s = prepare_launch("sm_torch", *key, len(grid.cells[0]), L,
                                 dev)
        if sched_s is not None:
            compile_s = (compile_s or 0.0) + sched_s
        _sync(dev)
        t0 = time.perf_counter()
        sched = ops.sm_schedule(warp_map, trace_n, grid.ops, state.trace_pc,
                                state.trace_mask, lat, is_mem,
                                out_cap=out_cap, policy=grid.policy)
        _sync(dev)
        exec_s += time.perf_counter() - t0
    return assemble(grid, state, sched, exec_s=exec_s, compile_s=compile_s)


def _sm_torch_options(req: SimRequest) -> tuple[int, str, str]:
    n_warps, inner_name, policy = _sm_options(req)
    inner = get_mechanism(inner_name)
    if "composite" in inner.tags:
        raise ValueError("sm_inner must be a single-warp mechanism, not "
                         f"the composite {inner.name!r}")
    if inner.name not in _SUPPORTED_INNER:
        raise ValueError(
            f"sm_torch executes warps on the hanoi lane step (kernel K1); "
            f"sm_inner must be one of {_SUPPORTED_INNER} (got "
            f"{inner.name!r}) — use sm_interleave for other inner "
            f"mechanisms")
    return n_warps, inner.name, policy


def _run_sm_torch_batch(reqs: Sequence[SimRequest]) -> list[SimResult]:
    """Native batch runner: a whole grid of signature-homogeneous SM cells
    as one K1 launch plus one K2 launch."""
    n_warps, inner_name, policy = _sm_torch_options(reqs[0])
    cells = []
    for req in reqs:
        stripped = {k: v for k, v in req.meta.items()
                    if not k.startswith("sm_")}
        cells.append([dataclasses.replace(req, meta=stripped,
                                          name=f"{req.name or 'warp'}/w{w}")
                      for w in range(n_warps)])
    sms = run_cells(cells, policy=policy, inner_label=inner_name)
    out = []
    for sm in sms:
        w0 = sm.warps[0]
        out.append(SimResult(
            mechanism="sm_torch", status=sm.status,
            regs=w0.regs, preds=w0.preds, mem=w0.mem, finished=w0.finished,
            steps=sm.steps, fuel_left=min(r.fuel_left for r in sm.warps),
            trace=tuple((pc, mask) for _, pc, mask in sm.sm_trace),
            utilization=sm.utilization,
            error=next((r.error for r in sm.warps if r.error), None),
            wall_time_s=sm.wall_time_s, meta={"sm": sm}))
    return out


@register_mechanism(
    "sm_torch", backend="torch", batch_runner=_run_sm_torch_batch,
    tags=("sm", "multi-warp", "composite", "vectorized"),
    description="per-SM model on the card: warps run in one launch of the "
                "hanoi kernel K1, the SM issue scheduler is kernel K2 with "
                "the issue policy as an argmin over a priority vector "
                "(meta: sm_warps, sm_inner in {hanoi, hanoi_torch}, "
                "sm_policy; device 'cpu' runs the plain twins); SM traces "
                "bit-identical to sm_interleave")
def _run_sm_torch(req: SimRequest) -> SimResult:
    return _run_sm_torch_batch([req])[0]
