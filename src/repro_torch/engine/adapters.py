"""Built-in mechanism adapters: existing engines -> normalized SimResult.

Port of ``repro.engine.adapters``.  Five mechanisms ship with the port's
engine: the reference's four numpy mechanisms, copied, and ``hanoi_torch``,
the counterpart of the reference's ``hanoi_jax``:

==============  =======  ====================================================
name            backend  model
==============  =======  ====================================================
simt_stack      numpy    pre-Volta SIMT-Stack, IPDom reconvergence (SS II)
hanoi           numpy    the paper's Hanoi mechanism (SS VII)
turing_oracle   numpy    Hanoi + the runtime skip heuristic (SS IX); consumes
                         ``SimRequest.bsync_skip_pcs``
dualpath        numpy    Dual-Path execution model (Rhu & Erez, HPCA'13)
hanoi_torch     torch    Hanoi as a batched state machine, a whole batch in
                         one launch of kernel K1 on the card.  Drop-in for
                         ``hanoi``: like ``hanoi_jax`` it *ignores*
                         ``bsync_skip_pcs`` (the low-level
                         ``repro_torch.core.hanoi.run_hanoi`` honors them)
==============  =======  ====================================================

``hanoi_torch`` runs on the card.  A request runs on the CPU (the plain
PyTorch step) only when it asks for it by name, ``meta={"device": "cpu"}``;
``meta`` is part of the execution signature, so such a request never shares
a batch with a card request.  Without a card and without that ask it
raises.

Each adapter funnels through :func:`~repro_torch.engine.types.classify_status`,
so ``SimResult.status`` means the same thing no matter which engine produced
it.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from repro_torch.core.dualpath import run_dual_path
from repro_torch.core.interp import RunResult, run_hanoi, run_simt_stack, \
    simd_utilization
from repro_torch.core.isa import Op

from .registry import register_mechanism
from .types import SimRequest, SimResult, classify_status

__all__ = ["PAD_QUANTUM", "padded_len", "result_from_runresult"]


def result_from_runresult(mechanism: str, r: RunResult, req: SimRequest,
                          wall_time_s: float = 0.0) -> SimResult:
    """Map a legacy numpy ``RunResult`` onto the normalized schema."""
    cfg = req.resolved_cfg()
    trace = tuple(r.trace)
    return SimResult(
        mechanism=mechanism,
        status=classify_status(finished=r.finished, full_mask=cfg.full_mask,
                               fuel_left=r.fuel_left, error=r.error),
        regs=np.asarray(r.regs), preds=np.asarray(r.preds),
        mem=np.asarray(r.mem), finished=int(r.finished), steps=int(r.steps),
        fuel_left=int(r.fuel_left), trace=trace,
        utilization=simd_utilization(r.trace, cfg.n_threads),
        error=r.error, wall_time_s=wall_time_s)


# ---------------------------------------------------------------------------
# numpy mechanisms
# ---------------------------------------------------------------------------

@register_mechanism(
    "hanoi", backend="numpy", tags=("paper", "reference"),
    description="Hanoi WS/REC-stack mechanism (paper SS VII), numpy "
                "reference interpreter")
def _run_hanoi(req: SimRequest) -> SimResult:
    cfg = req.resolved_cfg()
    t0 = time.perf_counter()
    r = run_hanoi(req.program, cfg, init_regs=req.init_regs,
                  init_mem=req.init_mem, lane_ids=req.lane_ids,
                  active0=req.active0, majority_first=req.majority_first,
                  record_trace=req.record_trace)
    return result_from_runresult("hanoi", r, req, time.perf_counter() - t0)


@register_mechanism(
    "turing_oracle", backend="numpy", uses_skip_pcs=True, tags=("paper",),
    description="Hanoi plus the Turing runtime skip heuristic (paper SS IX);"
                " skips reconvergence at SimRequest.bsync_skip_pcs")
def _run_turing_oracle(req: SimRequest) -> SimResult:
    cfg = req.resolved_cfg()
    t0 = time.perf_counter()
    r = run_hanoi(req.program, cfg, init_regs=req.init_regs,
                  init_mem=req.init_mem, lane_ids=req.lane_ids,
                  active0=req.active0, majority_first=req.majority_first,
                  bsync_skip_pcs=frozenset(req.bsync_skip_pcs),
                  record_trace=req.record_trace)
    return result_from_runresult("turing_oracle", r, req,
                                 time.perf_counter() - t0)


@register_mechanism(
    "simt_stack", backend="numpy", tags=("paper", "baseline"),
    description="pre-Volta SIMT-Stack with compile-time IPDom reconvergence "
                "(paper SS II)")
def _run_simt_stack(req: SimRequest) -> SimResult:
    cfg = req.resolved_cfg()
    t0 = time.perf_counter()
    r = run_simt_stack(req.program, cfg, init_regs=req.init_regs,
                       init_mem=req.init_mem, lane_ids=req.lane_ids,
                       record_trace=req.record_trace)
    return result_from_runresult("simt_stack", r, req,
                                 time.perf_counter() - t0)


@register_mechanism(
    "dualpath", backend="numpy", tags=("related-work",),
    description="Dual-Path execution model (Rhu & Erez, HPCA'13), the "
                "paper's SS X comparison point")
def _run_dualpath(req: SimRequest) -> SimResult:
    cfg = req.resolved_cfg()
    t0 = time.perf_counter()
    r = run_dual_path(req.program, cfg, init_regs=req.init_regs,
                      init_mem=req.init_mem, lane_ids=req.lane_ids,
                      record_trace=req.record_trace)
    return result_from_runresult("dualpath", r, req,
                                 time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the batched torch mechanism (K1 on the card)
# ---------------------------------------------------------------------------

PAD_QUANTUM = 32       # pad program length up to a multiple -> fewer shapes


def padded_len(n: int) -> int:
    """The padding class of an ``n``-instruction program: its length rounded
    up to the next :data:`PAD_QUANTUM` multiple.  Programs in the same class
    batch into the same padded shape; the service planner uses it as part
    of the execution signature."""
    return -(-n // PAD_QUANTUM) * PAD_QUANTUM


def _batch_arrays(reqs: Sequence[SimRequest], cfg, pad_len: int
                  ) -> tuple[np.ndarray, ...]:
    """``(progs, skips, regs, mems, lanes)`` operand arrays for one
    signature-homogeneous batch, programs padded with unreachable EXITs to
    ``pad_len``."""
    W = cfg.n_threads
    progs = np.zeros((len(reqs), pad_len, 8), np.int32)
    progs[:, :, 0] = int(Op.EXIT)                      # unreachable pad
    skips = np.zeros((len(reqs), pad_len), bool)       # hanoi: no oracle skips
    regs = np.zeros((len(reqs), W, cfg.n_regs), np.int32)
    mems = np.zeros((len(reqs), cfg.mem_size), np.int32)
    lanes = np.broadcast_to(np.arange(W, dtype=np.int32),
                            (len(reqs), W)).copy()
    for i, r in enumerate(reqs):
        p = np.asarray(r.program, np.int32)
        progs[i, :p.shape[0]] = p
        if r.init_regs is not None:
            regs[i] = np.asarray(r.init_regs, np.int32).reshape(W, cfg.n_regs)
        if r.init_mem is not None:
            mems[i] = np.asarray(r.init_mem, np.int32).reshape(cfg.mem_size)
        if r.lane_ids is not None:
            lanes[i] = np.asarray(r.lane_ids, np.int32).reshape(W)
    return progs, skips, regs, mems, lanes


def _device_of(req: SimRequest):
    """The card, unless the request asks for the CPU by name."""
    from repro_torch.device import resolve
    return resolve(req.meta.get("device"))


def _build_kernel(dev) -> float | None:
    """Build and load K1 before its first launch in this process; returns
    the seconds that took, or None when it was loaded already."""
    if dev.type == "cpu":
        return None
    from repro_torch.kernels import _build
    if "hanoi_step" in _build._LIBS:
        return None
    t0 = time.perf_counter()
    _build.load("hanoi_step")
    return time.perf_counter() - t0


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def _popcounts(masks: np.ndarray) -> np.ndarray:
    """The set bits of each u32 mask."""
    return _POP8[masks.astype("<u4").view(np.uint8)].reshape(-1, 4).sum(1)


def _run_hanoi_torch_batch(reqs: Sequence[SimRequest], *,
                           active0: int | None = None) -> list[SimResult]:
    """Native batched execution: every warp of the batch in one launch of K1
    (or, for a CPU request, the plain step vectorized over the batch).

    All requests must share cfg / majority_first / active0=None / meta (the
    planner's execution signature guarantees it before dispatching here);
    the per-request path passes one request with its ``active0``.
    Programs of different lengths are padded with unreachable EXITs to one
    padding class.

    Wall-time accounting: ``wall_time_s`` is execution-only, amortized per
    request.  K1's first build in the process is measured separately and
    stamped as ``meta["compile_time_s"]`` on that batch's results; it never
    inflates latency percentiles.  Result assembly copies each warp's
    ``trace[:trace_n]`` and its small state to the host, never the whole
    ``max_steps`` trace buffer.
    """
    import torch

    from repro_torch.core.hanoi import ERR_NO_FREE_BX
    from repro_torch.kernels import ops

    cfg = reqs[0].resolved_cfg()
    dev = _device_of(reqs[0])
    L = padded_len(max(int(np.asarray(r.program).shape[0]) for r in reqs))
    arrays = _batch_arrays(reqs, cfg, L)
    compile_s = _build_kernel(dev)
    progs, skips, regs, mems, lanes = (torch.from_numpy(a).to(dev)
                                       for a in arrays)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    st = ops.hanoi_run(progs, skips, regs, mems, lanes, cfg,
                       majority_first=reqs[0].majority_first, active0=active0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / max(1, len(reqs))
    meta = None if compile_s is None else {"compile_time_s": compile_s}

    # the traces, gathered on the device to their trace_n entries a warp
    n = st.trace_n.to(torch.int64)
    width = max(1, int(n.max()))
    keep = torch.arange(width, device=dev) < n.unsqueeze(1)
    pcs = st.trace_pc[:, :width][keep].cpu().numpy()
    masks = st.trace_mask[:, :width][keep].cpu().numpy().view(np.uint32)
    ends = np.cumsum(n.cpu().numpy())
    starts = ends - n.cpu().numpy()
    ones = np.concatenate([[0], np.cumsum(_popcounts(masks))])
    pc_list, mask_list = pcs.tolist(), masks.tolist()
    host = {k: getattr(st, k).cpu().numpy() for k in
            ("regs", "preds", "mem", "finished", "steps", "fuel", "error")}
    scalars = {k: host[k].tolist() for k in
               ("finished", "steps", "fuel", "error")}
    out = []
    for i, req in enumerate(reqs):
        lo, hi = int(starts[i]), int(ends[i])
        error = ("WARPSYNC: no free Bx register"
                 if scalars["error"][i] & ERR_NO_FREE_BX else None)
        fuel_left, finished = scalars["fuel"][i], scalars["finished"][i]
        if req.record_trace and hi > lo:
            trace = tuple(zip(pc_list[lo:hi], mask_list[lo:hi]))
            util = int(ones[hi] - ones[lo]) / ((hi - lo) * cfg.n_threads)
        else:
            trace, util = (), 0.0
        out.append(SimResult(
            mechanism="hanoi_torch",
            status=classify_status(finished=finished,
                                   full_mask=cfg.full_mask,
                                   fuel_left=fuel_left, error=error),
            regs=host["regs"][i], preds=host["preds"][i], mem=host["mem"][i],
            finished=finished, steps=scalars["steps"][i],
            fuel_left=fuel_left, trace=trace, utilization=util, error=error,
            wall_time_s=wall, meta=meta or {}))
    return out


@register_mechanism(
    "hanoi_torch", backend="torch",
    batch_runner=_run_hanoi_torch_batch, tags=("paper", "vectorized"),
    description="Hanoi as a batched state machine, one launch of the CUDA "
                "kernel K1 a batch on the card (meta={'device': 'cpu'} runs "
                "the plain PyTorch step); bit-identical to the numpy "
                "reference. Ignores bsync_skip_pcs — drop-in for 'hanoi'; "
                "use the low-level run_hanoi for oracle-mode batches")
def _run_hanoi_torch(req: SimRequest) -> SimResult:
    return _run_hanoi_torch_batch([req], active0=req.active0)[0]
