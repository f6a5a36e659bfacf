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

import torch

from ..core.hanoi import HanoiState, check_cfg
from ..core.isa import MachineConfig
from . import _build

WARPS_PER_CTA = 4        # simulated warps per CTA, one hardware warp each
SMEM_LIMIT = 232_448     # shared memory a CTA can use on an H100


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(cfg: MachineConfig, L: int) -> int:
    """Shared memory of one CTA (``layout`` in the source): each warp's
    program rows, memory image, register file ([NR][32]), WS and REC
    stacks, Bx file and skip flags."""
    SD = cfg.n_threads + 2
    per_warp = (_align16(L * 32) + _align16(cfg.mem_size * 4)
                + _align16(cfg.n_regs * 128) + 4 * _align16(SD * 4)
                + _align16(cfg.n_bx * 4) + _align16(cfg.n_bx) + _align16(L))
    return WARPS_PER_CTA * per_warp


class _Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "prog", "skip", "regs_in", "mem_in", "lanes_in",
        "ws_pc", "ws_mask", "ws_top", "rec_pc", "rec_bx", "rec_top",
        "bx_val", "bx_valid", "waiting", "finished",
        "regs", "preds", "mem", "lane_ids", "trace_pc", "trace_mask",
        "trace_n", "steps", "fuel", "halted", "error")]
        + [(n, ctypes.c_int) for n in ("N", "L", "W", "NR", "NP", "NB",
                                       "M", "T")]
        + [("full", ctypes.c_uint), ("active0", ctypes.c_uint),
           ("majority_first", ctypes.c_int)])


def hanoi_run_cuda(programs, skips, regs, mems, lanes, cfg: MachineConfig, *,
                   majority_first: bool = True,
                   active0: int | None = None) -> HanoiState:
    """Launch K1 on contiguous CUDA tensors: programs [N, L, 8] int32,
    skips [N, L] bool, regs [N, W, NR], mems [N, M] and lanes [N, W]
    int32.  Raises on anything the kernel does not take; never falls
    back."""
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
    if smem_bytes(cfg, L) > SMEM_LIMIT:
        raise ValueError(f"a CTA would need {smem_bytes(cfg, L)} bytes of "
                         f"shared memory (limit {SMEM_LIMIT}): L {L}, "
                         f"mem_size {M}, n_regs {NR}")
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
    full = cfg.full_mask
    params = _Params(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in st),
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


_build.register("hanoi_step", "hanoi_step.cu", _argtypes)


def run_bytes(state: HanoiState, L: int) -> int:
    """Bytes a run must move: the operands read once (programs, skips,
    registers, memories, lane ids) and every field of the final state
    written once, the whole trace buffer included."""
    N = state.regs.shape[0]
    operands = N * L * (8 * 4 + 1) + state.regs.numel() * 4 \
        + state.mem.numel() * 4 + state.lane_ids.numel() * 4
    return operands + sum(t.numel() * t.element_size() for t in state)
