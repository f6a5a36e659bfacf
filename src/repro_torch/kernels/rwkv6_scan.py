"""RWKV-6 (Finch) wkv recurrence: the CUDA kernel's launcher and its
plain-torch twin.

Port of ``repro.kernels.rwkv6_scan``.  Per (batch, head):
out_t = r_t . (S + diag(u) k_t v_t^T);  S <- diag(w_t) S + k_t v_t^T, with
the [hd, hd] f32 state starting at zero.  The kernel is
``csrc/rwkv6_scan.cu``: one CTA per (batch, head) walks the whole sequence
and reads [B, S, H, hd] through strides, so none of the JAX wrapper's
``moveaxis`` copies or tail padding exist.  :func:`rwkv6_scan_plain` walks
S in chunks of ``bs`` with the state carried across, as the TPU body does.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import rwkv6_scan_ref

DEFAULT_BS = 128     # time-steps per chunk of the plain version
_HEAD_DIMS = (8, 16, 32, 64)


def rwkv6_scan_plain(r, k, v, w, u, *, bs: int = DEFAULT_BS):
    """r,k,v,w: [B, S, H, hd] f32; u: [H, hd].  Returns (out [B, S, H, hd],
    s_last [B, H, hd, hd])."""
    S = r.shape[1]
    s, outs = None, []
    for s0 in range(0, S, bs):
        chunk = slice(s0, s0 + bs)
        out, s = rwkv6_scan_ref(r[:, chunk], k[:, chunk], v[:, chunk],
                                w[:, chunk], u, s0=s)
        outs.append(out)
    return torch.cat(outs, dim=1), s


def rwkv6_scan_cuda(r, k, v, w, u):
    """Launch the CUDA kernel.  r,k,v,w: [B, S, H, hd] float32, read
    through their strides (hd must be contiguous); u: [H, hd].  Raises on
    anything the kernel does not take; never falls back."""
    ins = (r, k, v, w, u)
    if not all(t.is_cuda and t.device == r.device for t in ins):
        raise ValueError("rwkv6_scan_cuda needs r, k, v, w, u on one CUDA "
                         f"device, got {[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError("r, k, v, w, u must be float32, got "
                        f"{[t.dtype for t in ins]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"bad shapes {[tuple(t.shape) for t in ins]}")
    B, S, H, hd = r.shape
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u {tuple(u.shape)} is not [H, hd] = {(H, hd)}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("the head dimension must be contiguous")
    u = u.contiguous()
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    lib = _build.load("rwkv6_scan")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    err = lib.rwkv6_scan_fwd(
        *(ptr(t.data_ptr()) for t in (r, k, v, w, u, out, s_last)),
        B, S, H, hd,
        *(i64(s) for t in (r, k, v, w, out) for s in t.stride()[:3]),
        ptr(torch.cuda.current_stream(r.device).cuda_stream))
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return out, s_last


def _argtypes(lib):
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.rwkv6_scan_fwd.argtypes = [ptr] * 7 + [i32] * 4 + [i64] * 15 + [ptr]
    lib.rwkv6_scan_fwd.restype = i32


_build.register("rwkv6_scan", "rwkv6_scan.cu", _argtypes)


def scan_bytes(r) -> int:
    """Bytes the scan must move: r, k, v, w read once, u read once, out and
    the final state written once."""
    B, S, H, hd = r.shape
    return 4 * (5 * r.numel() + H * hd + B * H * hd * hd)


def scan_flops(r) -> int:
    """Least f32 operations: per token and state element, r.S (2) and
    diag(w) S + k v^T (3); the diag(u) bonus is O(hd) per token."""
    B, S, H, hd = r.shape
    return 5 * B * S * H * hd * hd
