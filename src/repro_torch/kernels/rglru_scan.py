"""RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over [B, S, W]: the
CUDA kernel's launcher and its plain-torch twin.

Port of ``repro.kernels.rglru_scan``.  The kernel is
``csrc/rglru_scan.cu``: one thread per (b, w) channel walks t = 0..S-1 with
h in a register; ``bw`` channels make one CTA.  :func:`rglru_scan_plain`
walks S in chunks of ``bs`` with the carry handed from chunk to chunk, as
the TPU body does, and rounds each product and sum on its own as the kernel
does, so on the card the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_BS = 256     # time-steps per chunk of the plain version
DEFAULT_BW = 64      # channels per CTA of the kernel
_MAX_BW = 1024


def rglru_scan_plain(a, b, *, bs: int = DEFAULT_BS):
    """a, b: [B, S, W] float32 -> h [B, S, W] float32, h_{-1} = 0."""
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    carry = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for s0 in range(0, S, bs):
        for t in range(s0, min(S, s0 + bs)):
            carry = a[:, t] * carry + b[:, t]
            h[:, t] = carry
    return h


def rglru_scan_cuda(a, b, *, bw: int = DEFAULT_BW):
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
    if not 1 <= bw <= _MAX_BW:
        raise ValueError(f"bw {bw} out of range 1..{_MAX_BW}")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("the channel dimension must be contiguous")
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    lib = _build.load("rglru_scan")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    err = lib.rglru_scan_fwd(
        ptr(a.data_ptr()), ptr(b.data_ptr()), ptr(h.data_ptr()), B, S, W,
        *(i64(s) for t in (a, b, h) for s in t.stride()[:2]), bw,
        ptr(torch.cuda.current_stream(a.device).cuda_stream))
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return h


def _argtypes(lib):
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.rglru_scan_fwd.argtypes = [ptr] * 3 + [i32] * 3 + [i64] * 6 + [i32, ptr]
    lib.rglru_scan_fwd.restype = i32


_build.register("rglru_scan", "rglru_scan.cu", _argtypes)


def scan_bytes(a) -> int:
    """Bytes the scan must move: a and b read once, h written once."""
    return 3 * a.numel() * 4


def scan_flops(a) -> int:
    """f32 operations: one multiply and one add per element."""
    return 2 * a.numel()
