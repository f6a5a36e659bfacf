"""RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over [B, S, W]: the
CUDA kernel's launcher and its plain-torch twin.

Port of ``repro.kernels.rglru_scan``.  Both follow one schedule, set by the
segment length ``seg``: time is cut into segments of ``seg`` steps; each
segment's aggregate (the product P of its a, in token order, and its result
R from a zero start) is taken on its own; the carry into segment g+1 is
``P_g * carry_g + R_g``, taken in segment order; then each segment is
walked again from its carry-in and writes h.  Every product and sum is
rounded on its own (never contracted into an FMA), so on the card the
kernel (``csrc/rglru_scan.cu``) and :func:`rglru_scan_plain` agree bit for
bit.  With one segment (``seg >= S``) the twin is the sequential
recurrence, bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_SEG = 16     # time steps per segment (one thread's steps in the kernel)
MAX_SEG = 32         # the kernel holds a thread's segment in registers
SEGS_PER_CTA = 8     # one warp per segment, 32 channels a warp (csrc)
CHANNELS_PER_CTA = 32


def rglru_scan_plain(a, b, *, seg: int = DEFAULT_SEG):
    """a, b: [B, S, W] float32 -> h [B, S, W] float32, h_{-1} = 0.

    Walks the kernel's schedule with every segment at once: step j of every
    segment is ``a[:, j::seg]``, of which only the last segment can lack
    a step."""
    if seg < 1:
        raise ValueError(f"seg {seg} must be at least 1")
    B, S, W = a.shape
    G = -(-S // seg)
    P = torch.ones((B, G, W), dtype=torch.float32, device=a.device)
    R = torch.zeros((B, G, W), dtype=torch.float32, device=a.device)
    for j in range(min(seg, S)):
        aj, bj = a[:, j::seg], b[:, j::seg]
        n = aj.shape[1]                      # the segments that have step j
        P[:, :n] = P[:, :n] * aj
        R[:, :n] = aj * R[:, :n] + bj
    carry = torch.zeros((B, G, W), dtype=torch.float32, device=a.device)
    for g in range(G - 1):
        carry[:, g + 1] = P[:, g] * carry[:, g] + R[:, g]
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for j in range(min(seg, S)):
        aj, bj = a[:, j::seg], b[:, j::seg]
        n = aj.shape[1]
        carry[:, :n] = aj * carry[:, :n] + bj
        h[:, j::seg] = carry[:, :n]
    return h


def scratch_shape(B: int, S: int, W: int, seg: int) -> tuple[int, int]:
    """(int32 words, f32 words) of the kernel's scratch: a ticket and one
    progress flag per (batch, channel block); one carry per channel and
    block of SEGS_PER_CTA segments but the last."""
    chains = B * -(-W // CHANNELS_PER_CTA)
    blocks = -(-S // (seg * SEGS_PER_CTA))
    return 1 + chains, chains * (blocks - 1) * CHANNELS_PER_CTA


def rglru_scan_cuda(a, b, *, seg: int = DEFAULT_SEG):
    """Launch the CUDA kernel on [B, S, W] float32 tensors read through
    their strides (W must be contiguous).  Raises on anything the kernel
    does not take; never falls back."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("rglru_scan_cuda needs a and b on one CUDA device, "
                         f"got {a.device}, {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a, b must be float32, got {a.dtype}, {b.dtype}")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b {tuple(b.shape)}")
    if not 1 <= seg <= MAX_SEG:
        raise ValueError(f"seg {seg} out of range 1..{MAX_SEG}")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("the channel dimension must be contiguous")
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    n_sync, n_carry = scratch_shape(B, S, W, seg)
    sync = torch.zeros(n_sync, dtype=torch.int32, device=a.device)
    carry = torch.empty(max(n_carry, 1), dtype=torch.float32, device=a.device)
    lib = _build.load("rglru_scan")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    err = lib.rglru_scan_fwd(
        ptr(a.data_ptr()), ptr(b.data_ptr()), ptr(h.data_ptr()),
        ptr(carry.data_ptr()), ptr(sync.data_ptr()), B, S, W, seg,
        *(i64(s) for t in (a, b, h) for s in t.stride()[:2]),
        ptr(torch.cuda.current_stream(a.device).cuda_stream))
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return h


def _argtypes(lib):
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.rglru_scan_fwd.argtypes = [ptr] * 5 + [i32] * 4 + [i64] * 6 + [ptr]
    lib.rglru_scan_fwd.restype = i32


_build.register("rglru_scan", "rglru_scan.cu", _argtypes)


def scan_bytes(a) -> int:
    """Bytes the scan must move: a and b read once, h written once."""
    return 3 * a.numel() * 4


def scan_flops(a) -> int:
    """f32 operations: one multiply and one add per element."""
    return 2 * a.numel()
