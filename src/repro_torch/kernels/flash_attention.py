"""Divergence-aware flash attention: the CUDA kernel's launcher, its tile
schedule, and its plain-torch twin.

Port of ``repro.kernels.flash_attention``.  The (q-block, kv-block) grid is
an active-mask grid; each tile is EMPTY (never visited), PARTIAL (computed
under the causal / window / kv-tail mask) or FULL (computed unmasked).  The
kernel itself is ``csrc/flash_attention.cu``: one CTA per (q-tile, head,
batch) walks the kv tiles of :func:`kv_tile_range`, which are exactly the
non-EMPTY tiles of :func:`_tile_class`.  bf16 at hd 64, 128, 256 and 320
runs on the tensor cores, and so does latent attention's (192, 128): q and
k at head dim 192, v and o at 128 (DeepSeek-V3's 128 + 64 and 128), scaled
by 192 ** -0.5; f32, and bf16 at hd 8, 16 and 32, run on the CUDA cores.
:func:`flash_attention_plain` walks the same schedule in plain torch, at
any v head dim; the CPU path and the on-card check use it.

Both take ``q_offset``, the global position of q's row 0 (keys sit at 0 ..
Sk-1): a rank that holds query rows [q_offset, q_offset + Sq) of a split
sequence attends over every key with the masks and the kv-tile range of its
own rows.  A q tile is ``bq`` of q's rows, so at an offset that is not a
multiple of ``bq`` it straddles the diagonal, and the mask handles it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DEFAULT_BQ = 128
DEFAULT_BK = 128
NEG_INF = -1e30

# (q/k hd, v hd) -> (largest bq, default bk) of each tensor-core
# instantiation (bf16): 4 warps of 16 q rows, at most its default bk: 64
# keys while hd + hdv is at most 320, else 32, where the accumulator fills
# the registers.  hd -> the same for the CUDA-core kernel (f32; bf16 at hd
# 8-32), which holds a q row in one thread up to hd 128 (128 rows a CTA),
# in 4 threads at hd 256 and in 8 at hd 320 (256 threads a CTA); its bk is
# bounded by its f32 k/v tiles in shared memory, and its v hd is its hd.
_TC_TILES = {(64, 64): (64, 64), (128, 128): (64, 64), (256, 256): (64, 32),
             (320, 320): (64, 32), (192, 128): (64, 64)}
_CORE_TILES = {8: (128, 128), 16: (128, 128), 32: (128, 128),
               64: (128, 128), 128: (128, 128), 256: (64, 64), 320: (32, 64)}
_BF16_CORE_HEAD_DIMS = (8, 16, 32)
_MAX_SMEM = 232_448
_CHUNK = 16        # keys per online-softmax step in the CUDA-core kernel


def _tile_class(qs, ks, bq, bk, *, causal: bool, window: int, kv_len: int):
    """Classify tile [qs:qs+bq) x [ks:ks+bk), both in global positions (a
    q tile of a rank's rows starts at q_offset + its first row).  Returns
    (empty, full)."""
    q_min, q_max = qs, qs + bq - 1
    k_min, k_max = ks, ks + bk - 1
    empty, full = False, True
    if causal:
        empty |= k_min > q_max                     # entirely in the future
        full &= k_max <= q_min                     # all pairs past-or-diag
    if window > 0:
        empty |= k_max < q_min - window + 1        # entirely older than window
        full &= k_min >= q_max - window + 1        # all pairs inside window
    # kv padding tail
    empty |= k_min >= kv_len
    full &= k_max < kv_len
    return empty, full


def kv_tile_range(qs: int, bq: int, bk: int, nk: int, *, causal: bool,
                  window: int, kv_len: int) -> tuple[int, int]:
    """[lo, hi) of the kv tiles a q tile visits: the first tile not EMPTY
    under the window, up to the last not EMPTY under causal and kv_len.
    ``qs`` is the global position of the tile's first row, so the range
    stops at the tile's last row and tiles past a rank's rows are never
    read.  Mirrored line for line by ``kv_tile_range`` in the CUDA
    source."""
    lo = max(0, qs - window + 1) // bk if window > 0 else 0
    hi = min(nk, -(-kv_len // bk))
    if causal:
        hi = min(hi, (qs + bq - 1) // bk + 1)
    return lo, hi


def tile_stats(Sq: int, Sk: int, *, causal: bool, window: int,
               kv_len: int | None = None, bq: int = DEFAULT_BQ,
               bk: int = DEFAULT_BK) -> dict:
    """Schedule-time tile census of the mask grid (how much work the
    EMPTY-tile skipping saves)."""
    kv_len = Sk if kv_len is None else kv_len
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    empty = full = partial = 0
    for i in range(nq):
        for j in range(nk):
            e, f = _tile_class(i * bq, j * bk, bq, bk, causal=causal,
                               window=window, kv_len=kv_len)
            if e:
                empty += 1
            elif f:
                full += 1
            else:
                partial += 1
    total = nq * nk
    return {"total": total, "empty": empty, "full": full, "partial": partial,
            "flops_kept_frac": (full + partial) / total,
            "mask_overhead_frac": partial / max(1, full + partial)}


def _instance(dtype, hd: int, hdv: int | None = None
              ) -> tuple[bool, int, int] | None:
    """(tensor cores, largest bq, default bk) of the kernel instantiation
    that takes (dtype, hd, hdv: v's head dim, hd when None), or None where
    none does."""
    hdv = hd if hdv is None else hdv
    if dtype == torch.bfloat16 and (hd, hdv) in _TC_TILES:
        return (True, *_TC_TILES[hd, hdv])
    if hdv == hd and hd in _CORE_TILES and (dtype == torch.float32
                                            or hd in _BF16_CORE_HEAD_DIMS):
        return (False, *_CORE_TILES[hd])
    return None


def tiles(Sq: int, Sk: int, hd: int, bq: int | None = None,
          bk: int | None = None, *, dtype,
          hdv: int | None = None) -> tuple[int, int]:
    """The (bq, bk) the wrapper runs with: the defaults of the kernel that
    takes (dtype, hd, hdv) where not given, bq cut to q's rows and bk to
    the keys (at least 8 each; Sq < Sk for a rank's own rows)."""
    inst = _instance(dtype, hd, hdv)
    _, bq0, bk0 = inst if inst else (False, DEFAULT_BQ, DEFAULT_BK)
    bq = bq0 if bq is None else bq
    bk = bk0 if bk is None else bk
    return min(bq, max(8, Sq)), min(bk, max(8, Sk))


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK,
                          q_offset: int = 0):
    """The kernel's function in plain torch, on its tile schedule.

    q: [B, Sq, H, hd], rows at global positions q_offset ..; k: [B, Sk,
    K, hd] (GQA); v: [B, Sk, K, hdv].  m, l and acc are f32 and carried
    across the kv tiles of each q tile; the result [B, Sq, H, hdv] is in
    q's dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    G = H // K
    kv_len = Sk
    nk = -(-Sk // bk)
    scale = hd ** -0.5
    qf = q.float().reshape(B, Sq, K, G, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Sq, K, G, hdv), dtype=torch.float32,
                      device=q.device)
    for qs in range(0, Sq, bq):
        qt = qf[:, qs:qs + bq]
        n_q = qt.shape[1]
        m = torch.full((B, K, G, n_q), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, n_q), device=q.device)
        acc = torch.zeros((B, K, G, n_q, hdv), device=q.device)
        lo, hi = kv_tile_range(q_offset + qs, bq, bk, nk, causal=causal,
                               window=window, kv_len=kv_len)
        for j in range(lo, hi):
            ks = j * bk
            kt, vt = kf[:, ks:ks + bk], vf[:, ks:ks + bk]
            s = torch.einsum("bqkgh,bskh->bkgqs", qt, kt) * scale
            _, full = _tile_class(q_offset + qs, ks, bq, bk, causal=causal,
                                  window=window, kv_len=kv_len)
            if not full:
                qi = q_offset + qs + torch.arange(n_q,
                                                  device=q.device)[:, None]
                kj = ks + torch.arange(kt.shape[1], device=q.device)[None, :]
                live = kj < kv_len
                if causal:
                    live = live & (qi >= kj)
                if window > 0:
                    live = live & (qi - kj < window)
                s = torch.where(live, s, torch.tensor(NEG_INF, device=q.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskh->bkgqh",
                                                        p, vt)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, qs:qs + n_q] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hdv).to(q.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(tensor_cores: bool, hd: int, bk: int, hdv: int) -> int:
    """Dynamic shared memory of one CTA: the tensor-core kernel's bf16 q
    tile and 2-stage k/v ring, or the CUDA-core kernel's f32 k/v tile."""
    if tensor_cores:
        bq, bk0 = _TC_TILES[hd, hdv]
        return (bq * hd + 2 * bk0 * (hd + hdv)) * 2
    return 2 * -(-bk // _CHUNK) * _CHUNK * hd * 4


def flash_attention_cuda(q, k, v, *, causal: bool, window: int, bq: int,
                         bk: int, q_offset: int = 0):
    """Launch the CUDA kernel on BSHD tensors, read through their strides.

    Raises on anything the kernel does not take; never falls back."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape[:3] != v.shape[:3] \
            or v.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA attention")
    inst = _instance(q.dtype, hd, hdv)
    if inst is None:
        raise ValueError(f"head dims (q/k {hd}, v {hdv}) are not taken in "
                         f"{q.dtype}: f32 takes {tuple(_CORE_TILES)} (v's "
                         f"equal to q's), bf16 {_BF16_CORE_HEAD_DIMS} and "
                         f"(q/k, v) {tuple(_TC_TILES)}")
    tensor_cores, max_bq, max_bk = inst
    if (not (1 <= bq <= max_bq) or bk < 1
            or (tensor_cores and bk > max_bk)
            or _smem_bytes(tensor_cores, hd, bk, hdv) > _MAX_SMEM):
        raise ValueError(f"tile {bq}x{bk} out of range for head_dim {hd} in "
                         f"{q.dtype}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be at least 0")
    if min(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("the head dimension must be contiguous")
    # the tensor-core kernel copies rows 16 bytes at a time (cp.async)
    if tensor_cores and any(t.data_ptr() % 16 or any(s % 8 for s in
                                                     t.stride()[:3])
                            for t in (q, k, v)):
        raise ValueError("bf16 q, k, v must start on 16 bytes and have "
                         "batch, seq and head strides that are multiples "
                         "of 8 elements")
    o = torch.empty((B, Sq, H, hdv), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    ptr = ctypes.c_void_p
    i64 = ctypes.c_int64
    err = lib.flash_attention_fwd(
        ptr(q.data_ptr()), ptr(k.data_ptr()), ptr(v.data_ptr()),
        ptr(o.data_ptr()), _DTYPES[q.dtype], B, Sq, Sk, H, K, hd, hdv,
        *(i64(s) for t in (q, k, v, o) for s in t.stride()[:3]),
        int(causal), int(window), bq, bk, int(q_offset),
        ptr(torch.cuda.current_stream(q.device).cuda_stream))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{_build.cuda_error_string(lib, err)}")
    return o


def _argtypes(lib):
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = (
        [ptr] * 4 + [i32] * 8 + [i64] * 12 + [i32] * 5 + [ptr])
    lib.flash_attention_fwd.restype = i32


_build.register("flash_attention", "flash_attention.cu", _argtypes)


def attention_flops(B: int, Sq: int, Sk: int, H: int, hd: int, *,
                    causal: bool, window: int, q_offset: int = 0) -> int:
    """FLOPs the masked attention needs: 4*hd per live (q, k) pair (q.k and
    p.v), counted over the live pairs of this mask (q's rows at global
    positions q_offset ..), not the tiles visited."""
    live = 0
    for i in range(q_offset, q_offset + Sq):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(Sk, i + 1) if causal else Sk
        live += max(0, hi - lo)
    return 4 * hd * B * H * live


def attention_bytes(q, k, v) -> int:
    """Bytes the attention must move: q, k, v read once, o written once."""
    return (2 * q.numel() + k.numel() + v.numel()) * q.element_size()

