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

The kernel cache (:func:`batch_cache_stats`, :func:`reset_batch_caches`,
:func:`set_batch_cache_capacity`) counts the port's prepared launches as the
reference counts its compiled executables: one entry a (mechanism, cfg,
majority_first, batch, pad_len) key, a miss the first launch at a key in
this process, a disk hit a key whose libraries an installed
:mod:`~repro_torch.engine.compile_cache` found built.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Sequence

import numpy as np

from repro_torch.core.dualpath import run_dual_path
from repro_torch.core.interp import RunResult, run_hanoi, run_simt_stack, \
    simd_utilization
from repro_torch.core.isa import Op

from .registry import register_mechanism
from .types import SimRequest, SimResult, classify_status

__all__ = ["PAD_QUANTUM", "padded_len", "result_from_runresult",
           "state_results", "batch_cache_stats", "reset_batch_caches",
           "set_batch_cache_capacity", "prepare_launch"]


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


def _build_kernel(dev, names: Sequence[str] = ("hanoi_step",)
                  ) -> float | None:
    """Build and load the named kernels (K1 by default) before their first
    launch in this process; returns the seconds that took, or None when
    they were loaded already."""
    if dev.type == "cpu":
        return None
    from repro_torch.kernels import _build
    if all(n in _build._LIBS for n in names):
        return None
    t0 = time.perf_counter()
    for n in names:
        _build.load(n)
    return time.perf_counter() - t0


def _sync(dev) -> None:
    """Wait for the work queued on this thread's current stream.  Never
    the whole device: with two service workers each on its own stream, a
    device-wide synchronize would time one batch's launch into the other's
    ``wall_time_s``."""
    if dev.type == "cuda":
        import torch
        torch.cuda.current_stream(dev).synchronize()


# ---------------------------------------------------------------------------
# the kernel cache: prepared launches and their counters
# ---------------------------------------------------------------------------

#: the kernel library each counted mechanism's launch needs: ``hanoi_torch``
#: (and ``sm_torch``'s warp phase) K1, ``sm_torch``'s scheduler phase K2
KERNELS = {"hanoi_torch": ("hanoi_step",), "sm_torch": ("sm_sched",)}


class _LruDict(OrderedDict):
    """A bounded mapping with LRU eviction and an eviction counter.

    ``__setitem__`` evicts the least-recently-used entry past ``maxsize``;
    ``get`` refreshes recency.  Callers serialize access through
    ``_CACHE_LOCK`` — the class itself is not thread-safe.
    """

    def __init__(self, maxsize: int):
        super().__init__()
        self.maxsize = int(maxsize)
        self.evictions = 0

    def get(self, key, default=None):
        try:
            self.move_to_end(key)
        except KeyError:
            return default
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        self.trim()

    def trim(self) -> None:
        while len(self) > self.maxsize:
            self.popitem(last=False)
            self.evictions += 1


_CACHE_CAPACITY = 256
_CACHE_LOCK = threading.Lock()
# serializes the miss path (a library load can take an nvcc build), so two
# threads that reach a cold key together count one miss and one hit
_PREPARE_LOCK = threading.Lock()
# key -> the kernel libraries its launch uses
_PREPARED = _LruDict(_CACHE_CAPACITY)
#: a miss is the first launch at a key in this process (on the card it pays
#: the library load, which trace_time_s sums, CUDA's lazy load of the
#: kernel's instance and the caching allocator's first segments at that
#: shape; on the CPU nothing); a disk hit is a key the installed compile
#: cache's manifest holds, with its libraries found built on disk
_STATS = {"hits": 0, "misses": 0, "disk_hits": 0, "trace_time_s": 0.0}


def batch_cache_stats() -> dict:
    """Snapshot of the kernel cache: ``hits``, ``misses`` (first launches
    at a key in this process, the "re-trace" the warm-start gate asserts to
    zero), ``disk_hits`` (keys an installed compile cache supplied),
    ``trace_time_s`` (seconds misses spent loading libraries, ``nvcc``
    included), ``entries``, ``capacity`` and ``evictions``."""
    with _CACHE_LOCK:
        return {**_STATS, "entries": len(_PREPARED),
                "capacity": _PREPARED.maxsize,
                "evictions": _PREPARED.evictions}


def reset_batch_caches() -> None:
    """Drop every prepared launch and zero the counters — a process restart
    for warm-start tests, without respawning the interpreter (the loaded
    libraries stay loaded)."""
    with _CACHE_LOCK:
        _PREPARED.clear()
        _PREPARED.evictions = 0
        for k in _STATS:
            _STATS[k] = 0.0 if k == "trace_time_s" else 0


def set_batch_cache_capacity(executables: int | None = None) -> None:
    """Re-bound the cache of prepared launches (overflow evicts eagerly)."""
    with _CACHE_LOCK:
        if executables is not None:
            _PREPARED.maxsize = int(executables)
            _PREPARED.trim()


def prepare_launch(mechanism: str, cfg, majority_first: bool, batch: int,
                   pad_len: int, dev) -> float | None:
    """Account one launch of ``mechanism``'s kernel at the key
    ``(mechanism, cfg, majority_first, batch, pad_len)`` and make its
    library ready; returns the seconds a miss spent loading it (the
    batch's ``compile_time_s``), or None.

    Lookup order, as the reference's executables: in-memory LRU -> the
    installed compile cache (its manifest holds the key and the library is
    built on disk: loaded, no ``nvcc``) -> a miss, which loads (and if need
    be builds) the library and records the key in the installed cache's
    manifest.  A hit whose key the installed manifest lacks is adopted
    into it, so a warm start replays it too.
    """
    from .compile_cache import installed_cache

    key = (mechanism, cfg, bool(majority_first), int(batch), int(pad_len))
    names = KERNELS[mechanism]
    with _CACHE_LOCK:
        hit = _PREPARED.get(key) is not None
        if hit:
            _STATS["hits"] += 1
    cache = installed_cache()
    if hit:
        if cache is not None and not cache.has(*key):
            cache.store_executable(*key)
        return None
    with _PREPARE_LOCK:
        with _CACHE_LOCK:
            if _PREPARED.get(key) is not None:     # prepared meanwhile
                _STATS["hits"] += 1
                return None
        if cache is not None and cache.load_executable(*key, device=dev):
            with _CACHE_LOCK:
                _STATS["disk_hits"] += 1
                _PREPARED[key] = names
            return None
        compile_s = _build_kernel(dev, names)
        with _CACHE_LOCK:
            _STATS["misses"] += 1
            _STATS["trace_time_s"] += compile_s or 0.0
            _PREPARED[key] = names
        if cache is not None:
            cache.store_executable(*key, compile_s)
        return compile_s


def warm_launch(mechanism: str, cfg, majority_first: bool, batch: int,
                pad_len: int, dev) -> None:
    """Prepare the key and launch its kernel once on a dummy operand set of
    the key's shape (programs of EXITs; for ``sm_torch``, one cell of
    ``batch`` warps with empty traces under the default issue policy), so
    the first request at the key pays none of a miss's costs."""
    import torch

    from repro_torch.kernels import ops

    prepare_launch(mechanism, cfg, majority_first, batch, pad_len, dev)
    if mechanism == "hanoi_torch":
        req = SimRequest(program=np.full((1, 8), int(Op.EXIT), np.int32),
                         cfg=cfg)
        arrays = _batch_arrays([req] * batch, cfg, pad_len)
        ops.hanoi_run(*(torch.from_numpy(a).to(dev) for a in arrays), cfg,
                      majority_first=majority_first)
    else:
        from .mechanisms.sm import DEFAULT_POLICY
        from .mechanisms.sm_torch import _latency_tables, \
            _supported_cycle_cfg
        from repro_torch.core.timing import TimingConfig
        lat, is_mem = _latency_tables(_supported_cycle_cfg(TimingConfig()))

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        ops.sm_schedule(zeros(1, batch), zeros(1, batch), zeros(1, pad_len),
                        zeros(1, 1), zeros(1, 1), lat, is_mem, out_cap=256,
                        policy=DEFAULT_POLICY)
    _sync(dev)


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
    request.  A kernel-cache miss's library load (K1's first build in the
    process) is measured separately and stamped as
    ``meta["compile_time_s"]`` on that batch's results; it never inflates
    latency percentiles.
    """
    import torch

    from repro_torch.kernels import ops

    cfg = reqs[0].resolved_cfg()
    dev = _device_of(reqs[0])
    L = padded_len(max(int(np.asarray(r.program).shape[0]) for r in reqs))
    arrays = _batch_arrays(reqs, cfg, L)
    compile_s = prepare_launch("hanoi_torch", cfg, reqs[0].majority_first,
                               len(reqs), L, dev)
    progs, skips, regs, mems, lanes = (torch.from_numpy(a).to(dev)
                                       for a in arrays)
    _sync(dev)
    t0 = time.perf_counter()
    st = ops.hanoi_run(progs, skips, regs, mems, lanes, cfg,
                       majority_first=reqs[0].majority_first, active0=active0)
    _sync(dev)
    wall = (time.perf_counter() - t0) / max(1, len(reqs))
    meta = None if compile_s is None else {"compile_time_s": compile_s}
    return state_results(reqs, st, wall, meta=meta)


def state_results(reqs: Sequence[SimRequest], st, wall_time_s: float, *,
                  meta: "dict | None" = None) -> list[SimResult]:
    """One ``hanoi_torch`` :class:`SimResult` per row of the Hanoi state
    ``st`` (request ``i`` ran as row ``i``).  Each warp's
    ``trace[:trace_n]`` and its small state reach the host, never the whole
    ``max_steps`` trace buffer."""
    import torch

    from repro_torch.core.hanoi import ERR_NO_FREE_BX

    cfg = reqs[0].resolved_cfg()
    dev = st.trace_n.device
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
            wall_time_s=wall_time_s, meta=meta or {}))
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
