"""RWKV-6 (Finch) wkv recurrence: the CUDA kernel's launcher and its
plain-torch twin.

Port of ``repro.kernels.rwkv6_scan``.  Per (batch, head):
out_t = r_t . (S + diag(u) k_t v_t^T);  S <- diag(w_t) S + k_t v_t^T, with
the [hd, hd] f32 state starting at zero.  The kernel
(``csrc/rwkv6_scan.cu``) and :func:`rwkv6_scan_plain` follow one schedule,
set by the segment length ``seg``: time is cut into segments of ``seg``
tokens; each segment's aggregate (D, the product of its decays in token
order, and dS, its state from a zero start) is taken on its own; the state
carried into segment g+1 is ``D_g * S_g + dS_g``, taken in segment order,
and the last segment's is s_last; then each segment is walked again from
its carry-in, writing out.  The state is rounded product by product and
sum by sum in both, so s_last agrees bit for bit; out sums over k in
another order.  With one segment (``seg >= S``) the twin is the sequential
recurrence (:func:`ref.rwkv6_scan_ref`).  The kernel reads [B, S, H, hd]
through strides, so none of the JAX wrapper's ``moveaxis`` copies or tail
padding exist.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_SEG = 64     # tokens per segment: one CTA per (batch, head, segment)
_HEAD_DIMS = (8, 16, 32, 64)
_MAX_SMEM = 232_448


def _padded_hd(hd: int) -> int:
    """Floats per staged row in the kernel: rows of 64 take 4 floats of pad
    after their first 32, so a warp's 8 row groups hit 8 distinct banks."""
    return hd + 4 * ((hd - 1) // 32)


def smem_bytes(hd: int, seg: int) -> int:
    """Shared memory of one CTA: r, k, v, w and each token's bonus weight
    of its segment, then D and the ticket."""
    return 4 * (seg * (4 * _padded_hd(hd) + 1) + hd + 1)


def max_seg(hd: int) -> int:
    return (_MAX_SMEM - smem_bytes(hd, 0)) // (4 * (4 * _padded_hd(hd) + 1))


def rwkv6_scan_plain(r, k, v, w, u, *, seg: int = DEFAULT_SEG):
    """r,k,v,w: [B, S, H, hd] f32; u: [H, hd].  Returns (out [B, S, H, hd],
    s_last [B, H, hd, hd]).

    Walks the kernel's schedule with every segment at once: step j of every
    segment is ``x[:, j::seg]``, of which only the last segment can lack
    a step."""
    if seg < 1:
        raise ValueError(f"seg {seg} must be at least 1")
    B, S, H, hd = r.shape
    G = max(1, -(-S // seg))
    dev = r.device
    D = torch.ones((B, G, H, hd, 1), dtype=torch.float32, device=dev)
    dS = torch.zeros((B, G, H, hd, hd), dtype=torch.float32, device=dev)
    for j in range(min(seg, S)):
        wj = w[:, j::seg, :, :, None]
        n = wj.shape[1]                  # the segments that have token j
        at = k[:, j::seg, :, :, None] * v[:, j::seg, :, None, :]
        D[:, :n] = D[:, :n] * wj
        dS[:, :n] = wj * dS[:, :n] + at
    # s[:, g] is the state carried into segment g; s[:, G] is s_last
    s = torch.zeros((B, G + 1, H, hd, hd), dtype=torch.float32, device=dev)
    for g in range(G):
        s[:, g + 1] = D[:, g] * s[:, g] + dS[:, g]
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    for j in range(min(seg, S)):
        wj = w[:, j::seg, :, :, None]
        n = wj.shape[1]
        at = k[:, j::seg, :, :, None] * v[:, j::seg, :, None, :]
        out[:, j::seg] = torch.einsum(
            "bghk,bghkv->bghv", r[:, j::seg],
            s[:, :n] + u[None, None, :, :, None] * at)
        s[:, :n] = wj * s[:, :n] + at
    return out, s[:, G]


def scratch_shape(B: int, S: int, H: int, hd: int,
                  seg: int) -> tuple[int, int]:
    """(int32 words, f32 words) of the kernel's scratch: a ticket and one
    progress flag per (batch, head); one carried state per segment but the
    first."""
    G = max(1, -(-S // seg))
    return 1 + B * H, B * H * (G - 1) * hd * hd


def rwkv6_scan_cuda(r, k, v, w, u, *, seg: int = DEFAULT_SEG):
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
    if not 1 <= seg <= max_seg(hd):
        raise ValueError(f"seg {seg} out of range 1..{max_seg(hd)} at "
                         f"head_dim {hd}")
    if any(t.stride(3) != 1 for t in (r, k, v, w)):
        raise ValueError("the head dimension must be contiguous")
    u = u.contiguous()
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, hd, hd), dtype=torch.float32,
                         device=r.device)
    n_sync, n_carry = scratch_shape(B, S, H, hd, seg)
    sync = torch.zeros(n_sync, dtype=torch.int32, device=r.device)
    carry = torch.empty(max(n_carry, 1), dtype=torch.float32,
                        device=r.device)
    lib = _build.load("rwkv6_scan")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    err = lib.rwkv6_scan_fwd(
        *(ptr(t.data_ptr()) for t in (r, k, v, w, u, out, s_last, carry,
                                      sync)),
        B, S, H, hd, seg,
        *(i64(s) for t in (r, k, v, w, out) for s in t.stride()[:3]),
        ptr(torch.cuda.current_stream(r.device).cuda_stream))
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return out, s_last


def _argtypes(lib):
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.rwkv6_scan_fwd.argtypes = [ptr] * 9 + [i32] * 5 + [i64] * 15 + [ptr]
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
