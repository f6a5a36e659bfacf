"""K1, the Hanoi step machine on the card: the CUDA kernel's launcher.

Port of the device half of ``repro.core.hanoi`` (``_run``, vmapped by
``repro.engine.adapters._jitted_batch_runner``).  One launch of
``csrc/hanoi_step.cu`` builds each warp's initial state, runs every warp of
the batch to its end and writes the final :class:`HanoiState`, the trace's
``-1`` / ``0`` fill past ``trace_n`` included.  Its plain twin is
:func:`repro_torch.core.hanoi.hanoi_run_plain` (the same work: initial
state, then the plain step until every warp stops); the two agree bit for
bit in every field.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.hanoi import HanoiState, check_cfg
from ..core.isa import MachineConfig
from . import _build


class Layout(NamedTuple):
    """Where K1 keeps a warp's state for one shape (see :func:`layout`)."""

    warps: int               # simulated warps a CTA, one hardware warp each
    global_mem: bool         # the memory image, worked on in the mem output
    global_prog: bool        # program rows and skips, read-only path
    global_regs: bool        # the register file, in a global scratch buffer
    smem_bytes: int          # shared memory of one CTA


def layout(cfg: MachineConfig, L: int) -> Layout:
    """K1's layout for ``cfg`` and an ``L``-row program, chosen from the
    shape alone before the launch by the kernel's own host code
    (``choose_layout`` in ``csrc/hanoi_step.cu``, which ``hanoi_run``
    applies); this asks it, so it needs the built kernel.

    Everything in shared memory with 4 simulated warps a CTA, else 2, else
    1: the most whose slices fit the 232,448 bytes a CTA may use.  Past one
    warp's limit, one warp a CTA with the memory image in global memory;
    past that, the program rows too; past that, the register file too.
    Raises ``ValueError`` when even the stacks, the Bx file and the
    predicates do not fit (an ``n_bx`` or ``n_preds`` in the tens of
    thousands)."""
    check_cfg(cfg)
    out = (ctypes.c_int * 5)()
    _build.load("hanoi_step").hanoi_layout(
        L, cfg.n_threads, cfg.n_regs, cfg.n_preds, cfg.n_bx, cfg.mem_size,
        out)
    if out[0] == 0:
        raise ValueError("a warp's stacks, Bx file and predicates do not fit "
                         f"a CTA's shared memory: n_bx {cfg.n_bx}, n_preds "
                         f"{cfg.n_preds}")
    return Layout(out[0], bool(out[1]), bool(out[2]), bool(out[3]), out[4])


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "prog", "skip", "regs_in", "mem_in", "lanes_in",
        "ws_pc", "ws_mask", "ws_top", "rec_pc", "rec_bx", "rec_top",
        "bx_val", "bx_valid", "waiting", "finished",
        "regs", "preds", "mem", "lane_ids", "trace_pc", "trace_mask",
        "trace_n", "steps", "fuel", "halted", "error", "regs_work",
        "work")]
        + [(n, ctypes.c_int) for n in ("N", "L", "W", "NR", "NP", "NB",
                                       "M", "T")]
        + [("full", ctypes.c_uint), ("active0", ctypes.c_uint)]
        + [("majority_first", ctypes.c_int)])


def hanoi_run_cuda(programs, skips, regs, mems, lanes, cfg: MachineConfig, *,
                   majority_first: bool = True,
                   active0: int | None = None) -> HanoiState:
    """Launch K1 on contiguous CUDA tensors: programs [N, L, 8] int32,
    skips [N, L] bool, regs [N, W, NR], mems [N, M] and lanes [N, W]
    int32.  The kernel's layout is :func:`layout`'s for ``cfg`` and the
    program length.  Raises on anything the kernel does not take; never
    falls back."""
    check_cfg(cfg)
    dev = programs.device
    ins = (programs, skips, regs, mems, lanes)
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError("hanoi_run_cuda needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in ins]}")
    N, L = programs.shape[0], programs.shape[1]
    W, NR, M = cfg.n_threads, cfg.n_regs, cfg.mem_size
    want = {"programs": ((N, L, 8), torch.int32), "skips": ((N, L), torch.bool),
            "regs": ((N, W, NR), torch.int32), "mems": ((N, M), torch.int32),
            "lanes": ((N, W), torch.int32)}
    for (name, (shape, dtype)), t in zip(want.items(), ins):
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if N < 1 or L < 1:
        raise ValueError(f"empty batch: {N} warps of {L} rows")
    lay = layout(cfg, L)
    SD, NB, NP, T = W + 2, cfg.n_bx, cfg.n_preds, cfg.max_steps

    def out(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    st = HanoiState(
        ws_pc=out(N, SD), ws_mask=out(N, SD, dtype=torch.int64),
        ws_top=out(N), rec_pc=out(N, SD), rec_bx=out(N, SD), rec_top=out(N),
        bx_val=out(N, NB, dtype=torch.int64),
        bx_valid=out(N, NB, dtype=torch.bool),
        waiting=out(N, dtype=torch.int64), finished=out(N, dtype=torch.int64),
        regs=out(N, W, NR), preds=out(N, W, NP, dtype=torch.bool),
        mem=out(N, M), lane_ids=out(N, W), trace_pc=out(N, T),
        trace_mask=out(N, T), trace_n=out(N), steps=out(N), fuel=out(N),
        halted=out(N, dtype=torch.bool), error=out(N))
    regs_work = out(N, NR, 32) if lay.global_regs else None
    # the kernel's counters and each warp's state and filled range (zeros)
    work = torch.zeros(2 + 2 * N, dtype=torch.int32, device=dev)
    full = cfg.full_mask
    params = _Params(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in st),
        None if regs_work is None else regs_work.data_ptr(), work.data_ptr(),
        N, L, W, NR, NP, NB, M, T, full,
        full if active0 is None else int(active0) & 0xFFFFFFFF,
        int(bool(majority_first)))
    lib = _build.load("hanoi_step")
    err = lib.hanoi_run(ctypes.byref(params),
                        ctypes.c_void_p(torch.cuda.current_stream(dev)
                                        .cuda_stream))
    if err:
        raise RuntimeError(f"hanoi_step kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return st


def _argtypes(lib):
    lib.hanoi_run.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.hanoi_run.restype = ctypes.c_int
    lib.hanoi_layout.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.hanoi_layout.restype = None


_build.register("hanoi_step", "hanoi_step.cu", _argtypes)


def run_bytes(state: HanoiState, L: int) -> int:
    """Bytes a run must move: the operands read once (programs, skips,
    registers, memories, lane ids) and every field of the final state
    written once, the whole trace buffer included."""
    N = state.regs.shape[0]
    operands = N * L * (8 * 4 + 1) + state.regs.numel() * 4 \
        + state.mem.numel() * 4 + state.lane_ids.numel() * 4
    return operands + sum(t.numel() * t.element_size() for t in state)
