"""The port's flash attention against the JAX package's Pallas kernel (run in
interpret mode) and its dense oracle, plus the tile schedule; also on a
rank's own query rows (``q_offset``), against the JAX kernel's whole rows
sliced to them.

Inputs come from numpy with a fixed seed and go to both packages.  The
machine with the card has no JAX: there this module skips as a whole."""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _qkv(seed, B, S, H, Kh, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd)).astype(np.float32)
                 for n in (H, Kh, Kh))


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


SHAPES = [
    (64, 4, 4, 32, True, 0),        # causal full
    (64, 4, 2, 32, True, 0),        # GQA
    (64, 4, 1, 32, True, 16),       # MQA + window (SWA)
    (96, 2, 2, 64, True, 32),       # non-multiple of block, window
    (64, 2, 2, 32, False, 0),       # encoder (bidirectional)
    (64, 2, 1, 256, True, 16),      # recurrentgemma's hd 256, MQA + window
    (64, 8, 2, 128, True, 0),       # hd 128, GQA 4:1
    (96, 8, 4, 320, True, 24),      # gemma3-4b's local layers: hd 320
    (64, 8, 4, 320, True, 0),       # gemma3-4b's global layers
]


@pytest.mark.parametrize("S,H,Kh,hd,causal,window", SHAPES)
def test_flash_attention_matches_jax(S, H, Kh, hd, causal, window):
    q, k, v = _qkv(S + H + Kh + window, 2, S, H, Kh, hd)
    want_kernel = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=32, bk=32, interpret=True))
    want_ref = np.asarray(jref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    tq, tk, tv = (_torch(x) for x in (q, k, v))
    outs = {
        "ops": tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                    bq=32, bk=32),
        "plain": tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                           window=window, bq=32, bk=32),
        "ref": tref.attention_ref(tq, tk, tv, causal=causal, window=window),
    }
    for name, out in outs.items():
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(out.numpy(), want, rtol=2e-5,
                                       atol=2e-5, err_msg=name)


# a rank's own query rows [off, off + n) of S, over every key: offsets 0,
# on the q tile (32) and off it; causal with and without a window; GQA
OFFSETS = [
    (96, 4, 2, 32, 0, 0, 32),
    (96, 4, 2, 32, 0, 32, 32),
    (96, 4, 2, 32, 0, 40, 24),
    (96, 4, 2, 32, 16, 40, 24),
    (96, 4, 1, 64, 24, 64, 32),
    (96, 4, 4, 32, 16, 0, 48),
    (128, 8, 2, 32, 0, 77, 51),      # rows to the end, off every tile
]


@pytest.mark.parametrize("S,H,Kh,hd,window,off,n", OFFSETS)
def test_flash_attention_offset_matches_jax_rows(S, H, Kh, hd, window, off,
                                                 n):
    """K3's twin (and the wrapper on the CPU) on rows [off, off + n) with
    ``q_offset=off`` equals the JAX kernel's whole-row output, in interpret
    mode, sliced to those rows."""
    q, k, v = _qkv(S + off + n + window, 2, S, H, Kh, hd)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, bq=32, bk=32, interpret=True))[:, off:off + n]
    tq, tk, tv = (_torch(x) for x in (q[:, off:off + n], k, v))
    outs = {
        "ops": tops.flash_attention(tq, tk, tv, causal=True, window=window,
                                    bq=32, bk=32, q_offset=off),
        "plain": tfa.flash_attention_plain(tq, tk, tv, causal=True,
                                           window=window, bq=32, bk=32,
                                           q_offset=off),
        "default tiles": tops.flash_attention(tq, tk, tv, causal=True,
                                              window=window, q_offset=off),
    }
    for name, out in outs.items():
        np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_flash_attention_dtypes(dtype, tol):
    q, k, v = _qkv(1, 1, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=True, bq=32, bk=32,
                                interpret=True)
    want_ref = jref.attention_ref(jq, jk, jv, causal=True)
    tq, tk, tv = (_torch(x, getattr(torch, dtype)) for x in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=True, bq=32, bk=32)
    assert out.dtype == getattr(torch, dtype)
    for w in (want, want_ref):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Sk,causal,window,bq,bk", [
    (1024, 1024, True, 0, 128, 128),
    (4096, 4096, True, 512, 128, 128),
    (512, 512, False, 0, 128, 128),
    (96, 96, True, 32, 32, 32),
    (100, 130, False, 24, 16, 32),
    (2048, 2048, True, 0, 128, 128),
])
def test_tile_stats_equal_jax(Sq, Sk, causal, window, bq, bk):
    kw = dict(causal=causal, window=window, bq=bq, bk=bk)
    assert tfa.tile_stats(Sq, Sk, **kw) == jfa.tile_stats(Sq, Sk, **kw)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 7, 32, 100])
def test_kv_tile_range_is_the_non_empty_tiles(causal, window):
    """The kernel visits exactly the tiles _tile_class does not call EMPTY."""
    for bq, bk, Sk in [(32, 32, 96), (16, 32, 100), (8, 8, 8), (128, 64, 300)]:
        nk = -(-Sk // bk)
        for qs in range(0, Sk + bq, bq):
            lo, hi = tfa.kv_tile_range(qs, bq, bk, nk, causal=causal,
                                       window=window, kv_len=Sk)
            kept = [j for j in range(nk) if not tfa._tile_class(
                qs, j * bk, bq, bk, causal=causal, window=window,
                kv_len=Sk)[0]]
            assert list(range(lo, hi)) == kept, (bq, bk, Sk, qs)


@pytest.mark.parametrize("window", [0, 1, 7, 32])
def test_kv_tile_range_with_an_offset_is_the_live_tiles(window):
    """With q's rows at global positions off .. off + Sq - 1, the range of
    a q tile from its global first row is every kv tile that holds a live
    key of one of its rows under the brute-force causal (and window)
    mask, and ``_tile_class`` calls a tile FULL exactly when every pair
    is live."""
    for bq, bk, Sk in [(32, 32, 96), (16, 32, 100), (8, 8, 40), (64, 64, 300)]:
        nk = -(-Sk // bk)
        for off in (0, 1, bq, bq + 3, Sk // 2, Sk - 5):
            Sq = Sk - off
            for qs in range(0, Sq, bq):
                rows = np.arange(off + qs, off + min(qs + bq, Sq))
                cols = np.arange(Sk)
                live = rows[:, None] >= cols[None, :]
                if window > 0:
                    live &= rows[:, None] - cols[None, :] < window
                want = [j for j in range(nk)
                        if live[:, j * bk:(j + 1) * bk].any()]
                lo, hi = tfa.kv_tile_range(off + qs, bq, bk, nk, causal=True,
                                           window=window, kv_len=Sk)
                assert list(range(lo, hi)) == want, (bq, bk, Sk, off, qs)
                if len(rows) < bq:
                    continue       # the last tile's mask covers padding
                for j in range(lo, hi):
                    full = tfa._tile_class(off + qs, j * bk, bq, bk,
                                           causal=True, window=window,
                                           kv_len=Sk)[1]
                    tile = live[:, j * bk:(j + 1) * bk]
                    assert full == (tile.all() and tile.shape[1] == bk), \
                        (bq, bk, Sk, off, qs, j)


def test_attention_flops_counts_live_pairs():
    # causal: S(S+1)/2 live pairs; window w: min(i+1, w) per row
    assert tfa.attention_flops(1, 8, 8, 1, 4, causal=True, window=0) \
        == 4 * 4 * 36
    assert tfa.attention_flops(2, 8, 8, 3, 4, causal=True, window=2) \
        == 4 * 4 * 2 * 3 * (1 + 2 * 7)
    assert tfa.attention_flops(1, 8, 8, 1, 4, causal=False, window=0) \
        == 4 * 4 * 64
    # rows 4..7 of 8: 5 + 6 + 7 + 8 causal pairs; window 3: 3 a row
    assert tfa.attention_flops(1, 4, 8, 1, 4, causal=True, window=0,
                               q_offset=4) == 4 * 4 * 26
    assert tfa.attention_flops(1, 4, 8, 2, 4, causal=True, window=3,
                               q_offset=4) == 4 * 4 * 2 * 12



@pytest.mark.parametrize("Sq,hd,dtype,given,want", [
    (2048, 64, torch.float32, (None, None), (128, 128)),
    (2048, 256, torch.float32, (None, None), (64, 64)),   # 4 threads a row
    (2048, 320, torch.float32, (None, None), (32, 64)),   # 8 threads a row
    (2048, 32, torch.bfloat16, (None, None), (128, 128)), # CUDA cores
    (2048, 64, torch.bfloat16, (None, None), (64, 64)),   # tensor cores
    (2048, 128, torch.bfloat16, (None, None), (64, 64)),
    (2048, 256, torch.bfloat16, (None, None), (64, 32)),
    (2048, 320, torch.bfloat16, (None, None), (64, 32)),
    (20, 256, torch.float32, (None, None), (20, 20)),
    (20, 320, torch.bfloat16, (None, None), (20, 20)),
    (4, 64, torch.float32, (None, None), (8, 8)),
    (2048, 256, torch.float32, (32, 16), (32, 16)),
    (2048, 48, torch.bfloat16, (None, None), (128, 128)), # no kernel: plain
])
def test_tiles_follow_the_head_dim(Sq, hd, dtype, given, want):
    assert tfa.tiles(Sq, Sq, hd, *given, dtype=dtype) == want
