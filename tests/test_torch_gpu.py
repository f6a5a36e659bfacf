"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the smoke models' prefill on the card held against the port's
CPU path (which ``test_torch_models.py`` and ``test_torch_recurrent.py``
hold against JAX).  K1, the Hanoi step machine, is held to its twin bit for
bit in every field of the state, on the suite and on the divergence traps
(:func:`hanoi_traps`, which ``test_torch_hanoi.py`` holds to JAX), and at
each of its layouts' boundaries.  K2, the SM issue scheduler, is held to
its twin bit for bit in every output, on K1's traces and on synthetic
grids (:func:`sched_grid`, on which ``test_torch_sm.py`` holds the twin to
JAX's scheduler).  K3-K5's wrappers refuse autograd on CUDA tensors, and
two training steps of the smoke model on the card are held against the
CPU's (which ``test_torch_train.py`` holds against JAX).  The smoke
recurrent models' prefills take K4 / K5 by default, held against
``use_kernel=False``, and their training launches neither.  Distribution:
two ranks sharing the card over gloo prefill the smoke model through K3
on their heads and run the int8 all-reduce (equal to the CPU's), and a
world of one over NCCL trains on a (1, 1) mesh as one rank does.

Every test here needs an NVIDIA GPU: it carries the ``gpu`` marker and skips
without one.  Run them on the card with
``python -m pytest -m gpu tests/test_torch_*.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.launch.steps import prefill
from repro_torch.models import Transformer, forward, init_params, model_struct
from repro_torch.models import recurrent
from repro_torch.models.base import tree_leaves, tree_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(seed, B, S, H, Kh, hd, dtype, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, S, n, hd))
                                  .astype(np.float32)).to(device, dtype)
                 for n in (H, Kh, Kh))


@pytest.mark.parametrize("B,S,H,Kh,hd,causal,window,dtype,tol", [
    (2, 256, 8, 2, 64, True, 0, torch.float32, 2e-5),
    (2, 256, 8, 2, 64, True, 0, torch.bfloat16, 2e-2),
    (1, 300, 4, 1, 64, True, 64, torch.float32, 2e-5),
    (1, 200, 4, 4, 32, False, 0, torch.float32, 2e-5),
    (1, 77, 2, 2, 128, False, 16, torch.bfloat16, 2e-2),
    (2, 12, 4, 2, 16, True, 0, torch.float32, 2e-5),
    (2, 300, 4, 1, 256, True, 64, torch.float32, 2e-5),     # hd 256
    (1, 200, 10, 1, 256, True, 128, torch.bfloat16, 2e-2),
    (1, 77, 2, 2, 256, False, 0, torch.float32, 2e-5),
    # the tensor-core kernel (bf16, hd 64-320): GQA groups of 1, 4 and 10,
    # ragged S, windows under a tile and past S, non-causal
    (2, 1000, 8, 8, 64, True, 0, torch.bfloat16, 2e-2),
    (1, 333, 16, 4, 64, True, 5, torch.bfloat16, 2e-2),
    (2, 513, 16, 4, 128, True, 0, torch.bfloat16, 2e-2),
    (1, 190, 8, 2, 128, False, 0, torch.bfloat16, 2e-2),
    (1, 300, 8, 8, 128, True, 1000, torch.bfloat16, 2e-2),
    (2, 700, 10, 1, 256, True, 2048, torch.bfloat16, 2e-2),
    (1, 129, 4, 4, 256, False, 40, torch.bfloat16, 2e-2),
    (2, 450, 8, 4, 320, True, 100, torch.bfloat16, 2e-2),   # gemma3-4b
    (1, 257, 8, 4, 320, True, 0, torch.bfloat16, 2e-2),
    (1, 100, 10, 1, 320, False, 0, torch.bfloat16, 2e-2),
    (1, 9, 8, 4, 320, True, 3, torch.bfloat16, 2e-2),
    (1, 450, 8, 4, 320, True, 100, torch.float32, 2e-5),
    (1, 77, 4, 2, 320, False, 0, torch.float32, 2e-5),
    # the MoE models' hd 128: full multi-head (deepseek-moe-16b), and a
    # window shorter than the sequence with GQA 4:1 (mixtral-8x7b)
    (2, 600, 16, 16, 128, True, 0, torch.bfloat16, 2e-2),
    (1, 300, 4, 4, 128, True, 0, torch.float32, 2e-5),
    (1, 1200, 8, 2, 128, True, 512, torch.bfloat16, 2e-2),
    (1, 700, 8, 2, 128, True, 256, torch.float32, 2e-5),
    # the GQA groups of 6, 3 and 2 at hd 128 (internlm2-20b, minitron-4b,
    # internvl2-2b), and gemma3-4b's global layers (hd 320, no window)
    (2, 256, 48, 8, 128, True, 0, torch.bfloat16, 2e-2),
    (2, 256, 24, 8, 128, True, 0, torch.bfloat16, 2e-2),
    (2, 256, 16, 8, 128, True, 0, torch.bfloat16, 2e-2),
    (2, 256, 8, 4, 320, True, 0, torch.bfloat16, 2e-2),
    (1, 300, 12, 2, 128, True, 0, torch.float32, 2e-5),
    (1, 200, 6, 2, 128, True, 0, torch.float32, 2e-5),
    (1, 150, 8, 4, 320, True, 0, torch.float32, 2e-5),
])
def test_cuda_kernel_matches_plain(cuda, B, S, H, Kh, hd, causal, window,
                                   dtype, tol):
    q, k, v = _qkv(S, B, S, H, Kh, hd, dtype, cuda)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    bq, bk = fa.tiles(S, S, hd, dtype=dtype)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    bq=bq, bk=bk)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,rows,H,Kh,hd,window,dtype,tol", [
    # a rank's rows of a split sequence: on the q tile, off it, to the end
    (512, (128, 256), 10, 1, 256, 512, torch.bfloat16, 2e-2),
    (512, (100, 300), 8, 2, 64, 0, torch.bfloat16, 2e-2),
    (512, (333, 512), 8, 2, 128, 96, torch.bfloat16, 2e-2),
    (512, (100, 300), 8, 2, 64, 0, torch.float32, 2e-5),
    (400, (37, 211), 4, 4, 320, 64, torch.float32, 2e-5),
    (256, (9, 100), 4, 2, 32, 0, torch.bfloat16, 2e-2),
])
def test_cuda_kernel_on_a_ranks_query_rows(cuda, S, rows, H, Kh, hd, window,
                                           dtype, tol):
    """Rows [a, b) of S at ``q_offset=a`` over every key: the twin's
    output at that offset, and the whole-row kernel's rows."""
    q, k, v = _qkv(S + rows[0], 2, S, H, Kh, hd, dtype, cuda)
    a, b = rows
    before = ops.flash_attention.launches
    out = ops.flash_attention(q[:, a:b], k, v, causal=True, window=window,
                              q_offset=a)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.shape == q[:, a:b].shape
    bq, bk = fa.tiles(b - a, S, hd, dtype=dtype)
    want = fa.flash_attention_plain(q[:, a:b], k, v, causal=True,
                                    window=window, bq=bq, bk=bk, q_offset=a)
    whole = ops.flash_attention(q, k, v, causal=True, window=window)[:, a:b]
    for w in (want, whole):
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("bq,bk", [(16, 16), (37, 24), (64, 64)])
def test_cuda_kernel_takes_smaller_tiles(cuda, bq, bk):
    """A tile under the kernel's own still walks the plain twin's schedule."""
    q, k, v = _qkv(8, 1, 200, 4, 2, 64, torch.bfloat16, cuda)
    out = ops.flash_attention(q, k, v, causal=True, window=50, bq=bq, bk=bk)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=50, bq=bq,
                                    bk=bk)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernel_reads_strided_inputs(cuda, dtype, tol):
    """q, k, v as slices of one fused qkv tensor: read through strides."""
    qkv = _qkv(5, 2, 130, 12, 1, 64, dtype, cuda)[0]           # [2,130,12,64]
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:12]
    out = ops.flash_attention(q, k, v, causal=True)
    bq, bk = fa.tiles(130, 130, 64, dtype=dtype)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True, bq=bq, bk=bk)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def test_cuda_kernel_rejects_what_it_does_not_take(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 8, 2, 48), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="head_dim"):
            ops.flash_attention(q, q, q)
    q = torch.zeros((1, 128, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="tile"):
        ops.flash_attention(q, q, q, bq=128)       # f32 hd 256 takes 64 rows
    q = torch.zeros((1, 128, 2, 320), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile"):
        ops.flash_attention(q, q, q, bk=64)        # bf16 hd 320 takes 32 keys
    with pytest.raises(ValueError, match="16 bytes"):
        # a view one element in: its rows do not start on 16 bytes
        x = torch.zeros((1, 64, 2, 65), device=cuda, dtype=torch.bfloat16)
        y = x[..., 1:]
        ops.flash_attention(y, y, y)
    h = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(h, h, h)


def test_smoke_prefill_on_card_matches_cpu(cuda):
    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(4),
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 40)))
    want, _, _ = forward(Transformer(cfg, params), cfg, {"tokens": toks})
    gpu_model = Transformer(cfg, tree_map(lambda t: t.to(cuda), params))
    before = ops.flash_attention.launches
    got, _ = prefill(gpu_model, cfg.replace(attn_impl="flash"),
                     {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)



@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_smoke_frontend_prefill_on_card_matches_cpu(cuda, arch):
    """The frontends' ``frontend_proj`` and hubert-xlarge's non-causal
    encoder on the card against the CPU path (which
    ``test_torch_configs.py`` holds against JAX), on batches from the
    port's ``synthetic_batch``."""
    from repro_torch.data import synthetic_batch
    cfg = get_config(arch, smoke=True)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(9),
                         device="cpu")
    seq = 40 + cfg.n_patches
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 2, seq, step=9).items()}
    want, _, _ = forward(Transformer(cfg, params), cfg, batch)
    gpu_model = Transformer(cfg, tree_map(lambda t: t.to(cuda), params))
    before = ops.flash_attention.launches
    got, caches = prefill(gpu_model, cfg.replace(attn_impl="flash"),
                          {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + (
        cfg.n_layers if cfg.causal else 0)
    assert (caches is None) == (not cfg.is_decoder)
    assert got.shape == (2, seq, cfg.vocab_size)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_smoke_moe_model_on_card_matches_cpu(cuda, arch):
    """The MoE models' prefill through K3 on the card, and one MoE layer's
    routing and dispatch, against the CPU path (which
    ``test_torch_moe.py`` holds against JAX)."""
    from repro_torch.models import moe
    cfg = get_config(arch, smoke=True)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(7),
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 40)))
    cpu_model = Transformer(cfg, params)
    want, want_aux, _ = forward(cpu_model, cfg, {"tokens": toks})
    gpu_model = Transformer(cfg, tree_map(lambda t: t.to(cuda), params))
    before = ops.flash_attention.launches
    got, _ = prefill(gpu_model, cfg.replace(attn_impl="flash"),
                     {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)

    # a capacity small enough to drop: the same slots dropped on the card
    small = cfg.replace(capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32))
    seg = cfg.first_dense_layers and 1
    lp, clp = gpu_model.segments[seg][0], cpu_model.segments[seg][0]
    _, g_slots, _, g_eidx, _ = moe.dispatch(getattr(lp, "0").ffn, x.to(cuda),
                                            small)
    _, c_slots, _, c_eidx, C = moe.dispatch(getattr(clp, "0").ffn, x, small)
    assert torch.equal(g_eidx.cpu(), c_eidx)
    assert torch.equal(g_slots.dest.cpu(), c_slots.dest)
    assert torch.equal(g_slots.src_token.cpu(), c_slots.src_token)
    assert bool((c_slots.dest == cfg.n_experts * C).any())
    out, _ = moe.moe(getattr(lp, "0").ffn, x.to(cuda), small)
    want_out, _ = moe.moe(getattr(clp, "0").ffn, x, small)
    np.testing.assert_allclose(out.cpu().numpy(), want_out.numpy(),
                               rtol=2e-4, atol=2e-4)
    # the combine takes no atomics: a second run gives the same bits
    again, _ = moe.moe(getattr(lp, "0").ffn, x.to(cuda), small)
    assert torch.equal(out, again)


def test_smoke_moe_prefill_traced_on_card(cuda):
    """Spans and counters on the card: no read back to the host while the
    prefill runs (the same synchronizing calls as with tracing off), the
    same logits, and the drop count the CPU's run gives."""
    import contextlib
    import warnings

    from repro_torch import tracing
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(
        capacity_factor=0.5)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(3),
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=(2, 48)).astype(np.int32))
    gpu_model = Transformer(cfg, tree_map(lambda t: t.to(cuda), params))
    with tracing.recording(spans=False, counters=True) as cpu_rec:
        prefill(Transformer(cfg, params), cfg, {"tokens": toks})

    def run(**kw):
        # the recording reads its counters back once, when it ends: after
        # the prefill, outside the calls counted here
        with (tracing.recording(**kw) if kw else contextlib.nullcontext()) \
                as rec:
            batch = {"tokens": toks.to(cuda)}
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    out = prefill(gpu_model, cfg, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in caught if "synchroniz" in str(w.message)]
        return out[0], len(syncs), rec

    want, off_syncs, _ = run()
    got, on_syncs, rec = run(spans=True, counters=True)
    assert on_syncs == off_syncs
    assert torch.equal(got, want)
    assert rec.counters == cpu_rec.counters and rec.counters["moe.dropped"]
    assert {s.name for s in rec.spans} >= {"prefill", "moe", "moe.dispatch"}


def test_smoke_moe_prefill_bits_and_batched_dispatch_on_card(cuda):
    """The smoke deepseek prefill on the card gives the same bits with
    tracing off and on and on a second run (the combine adds each token's
    slots in one fixed order, with no atomics); and the dispatch of 16
    groups at once, with drops, gives the CPU's destinations and source
    tokens slot for slot."""
    from repro_torch import tracing
    from repro_torch.models import moe
    from repro_torch.models.base import Params
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(
        capacity_factor=0.5)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(5),
                         device="cpu")
    gpu_model = Transformer(cfg, tree_map(lambda t: t.to(cuda), params))
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(16, 32))).to(cuda)

    def run(**kw):
        if not kw:
            return prefill(gpu_model, cfg, {"tokens": toks})
        with tracing.recording(**kw):
            return prefill(gpu_model, cfg, {"tokens": toks})

    want, want_caches = run()
    for kw in ({}, {"spans": True, "counters": True}, {}):
        got, caches = run(**kw)
        assert torch.equal(got, want)
        for a, b in zip(caches, want_caches):
            for j in a:
                for name in a[j]:
                    assert torch.equal(a[j][name], b[j][name]), (j, name)

    # the router rounded to multiples of 2^-10 and the input drawn from
    # {-1, 0, 1}: its logits are exact in f32 on either device, so the
    # routing is the same and a difference would be the dispatch's
    tree = init_params(moe.moe_struct(cfg), torch.Generator().manual_seed(6),
                       device="cpu")
    tree["router"] = torch.round(tree["router"] * 1024) / 1024
    x = torch.randint(-1, 2, (16, 24, cfg.d_model),
                      generator=torch.Generator().manual_seed(6)).float()
    _, c_slots, _, c_eidx, C = moe.dispatch(Params(tree), x, cfg)
    _, g_slots, _, g_eidx, _ = moe.dispatch(
        Params(tree_map(lambda t: t.to(cuda), tree)), x.to(cuda), cfg)
    assert torch.equal(g_eidx.cpu(), c_eidx)
    assert c_slots.dest.shape == (16, 24 * cfg.experts_per_token)
    assert torch.equal(g_slots.dest.cpu(), c_slots.dest)
    assert torch.equal(g_slots.src_token.cpu(), c_slots.src_token)
    assert torch.equal(g_slots.by_token.cpu(), c_slots.by_token)
    assert bool((c_slots.dest == cfg.n_experts * C).any())


def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def _rglru_inputs(gen, B, S, W, device):
    a = torch.rand((B, S, W), generator=gen, device=device) * 0.499 + 0.5
    return a, _randn(gen, (B, S, W), device)


# K4's h and K5's s_last round as their plain twins do, on the twins' own
# schedule: they must be bit-equal; K5's out sums over k in another order
# and is held at the JAX package's kernel tolerance.
@pytest.mark.parametrize("B,S,W,seg", [
    (4, 256, 2560, rg.DEFAULT_SEG),
    (2, 1000, 2500, rg.DEFAULT_SEG),    # ragged S and W
    (1, 37, 70, 7),
    (3, 5, 3, 32),
    (2, 1, 64, rg.DEFAULT_SEG),         # S = 1
    (1, 11, 100, rg.DEFAULT_SEG),       # S under one segment
    (2, 300, 33, 1),                    # one step a segment
    (2, 4099, 130, 5),                  # ragged everywhere
    (2, 20000, 2560, rg.DEFAULT_SEG),   # a grid of many resident waves
])
def test_rglru_kernel_matches_plain(cuda, B, S, W, seg):
    gen = torch.Generator(device=cuda).manual_seed(S + W)
    a, b = _rglru_inputs(gen, B, S, W, cuda)
    before = ops.rglru_scan.launches
    h = ops.rglru_scan(a, b, seg=seg)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    want = rg.rglru_scan_plain(a, b, seg=seg)
    np.testing.assert_allclose(h.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(h, want)


def test_rglru_kernel_gives_the_same_bits_twice(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    a, b = _rglru_inputs(gen, 4, 16384, 2560, cuda)
    first = ops.rglru_scan(a, b)
    assert torch.equal(first, ops.rglru_scan(a, b))


def test_rglru_kernel_reads_strided_inputs(cuda):
    """a and b as halves of one [B, S, 2W] tensor, in time-major order."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    ab = _randn(gen, (300, 2, 2 * 96), cuda).transpose(0, 1)
    a, b = torch.sigmoid(ab[..., :96]), ab[..., 96:]
    h = ops.rglru_scan(a, b)
    want = rg.rglru_scan_plain(a.contiguous(), b.contiguous())
    np.testing.assert_allclose(h.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(h, want)


def test_rglru_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        ops.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="seg"):
        ops.rglru_scan(a, a, seg=rg.MAX_SEG + 1)
    with pytest.raises(ValueError, match="seg"):
        ops.rglru_scan(a, a, seg=0)


def _rwkv_inputs(gen, B, S, H, hd, device):
    r, k, v = (_randn(gen, (B, S, H, hd), device) for _ in range(3))
    w = torch.rand((B, S, H, hd), generator=gen, device=device) * 0.199 + 0.8
    u = _randn(gen, (H, hd), device) * 0.1
    return r, k, v, w, u


@pytest.mark.parametrize("B,S,H,hd,seg", [
    (2, 256, 40, 64, rw.DEFAULT_SEG),
    (1, 1000, 4, 64, rw.DEFAULT_SEG),   # ragged: the JAX wrapper would pad
    (2, 48, 2, 16, 16),
    (1, 24, 2, 8, 7),
    (1, 33, 3, 32, 5),
    (2, 1, 3, 64, rw.DEFAULT_SEG),      # S = 1
    (1, 0, 2, 16, 4),                   # S = 0: s_last is zero
    (1, 50, 2, 64, rw.DEFAULT_SEG),     # S under one segment
    (1, 130, 2, 32, 1),                 # one token a segment
    (2, 8192, 40, 64, rw.DEFAULT_SEG),  # a grid of many resident waves
])
def test_rwkv6_kernel_matches_plain(cuda, B, S, H, hd, seg):
    gen = torch.Generator(device=cuda).manual_seed(S + hd)
    ins = _rwkv_inputs(gen, B, S, H, hd, cuda)
    before = ops.rwkv6_scan.launches
    out, s_last = ops.rwkv6_scan(*ins, seg=seg)
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.launches == before + 1
    want, s_want = rw.rwkv6_scan_plain(*ins, seg=seg)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_last.cpu().numpy(), s_want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(s_last, s_want)


def test_rwkv6_kernel_gives_the_same_bits_twice(cuda):
    gen = torch.Generator(device=cuda).manual_seed(10)
    ins = _rwkv_inputs(gen, 4, 16384, 40, 64, cuda)
    out, s_last = ops.rwkv6_scan(*ins)
    out2, s_last2 = ops.rwkv6_scan(*ins)
    assert torch.equal(out, out2) and torch.equal(s_last, s_last2)


@pytest.mark.parametrize("off", [0, 1])
def test_rwkv6_kernel_reads_strided_inputs(cuda, off):
    """r, k, v, w as slices of one fused [B, S, H, 4 hd + 4] tensor; at
    ``off`` 1 their rows do not start on 16 bytes."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    fused = _randn(gen, (2, 70, 3, 4 * 16 + 4), cuda)[..., off:off + 64]
    r, k, v = (fused[..., i * 16:(i + 1) * 16] for i in range(3))
    w = torch.sigmoid(fused[..., 48:])
    u = _randn(gen, (3, 16), cuda) * 0.1
    out, s_last = ops.rwkv6_scan(r, k, v, w, u, seg=16)
    want, s_want = rw.rwkv6_scan_plain(*(t.contiguous()
                                         for t in (r, k, v, w, u)), seg=16)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_last.cpu().numpy(), s_want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(s_last, s_want)


def test_rwkv6_kernel_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    ins = _rwkv_inputs(gen, 1, 8, 2, 128, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.rwkv6_scan(*ins)
    ins = _rwkv_inputs(gen, 1, 8, 2, 16, cuda)
    with pytest.raises(TypeError):
        ops.rwkv6_scan(*(t.bfloat16() for t in ins))
    with pytest.raises(ValueError, match="u"):
        ops.rwkv6_scan(*ins[:4], ins[4][:1])
    with pytest.raises(ValueError, match="seg"):
        ops.rwkv6_scan(*ins, seg=rw.max_seg(16) + 1)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_smoke_recurrent_model_on_card_matches_cpu(cuda, arch):
    cfg = get_config(arch, smoke=True)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(5),
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 40)))
    cpu_model = Transformer(cfg, params)
    want, _, _ = forward(cpu_model, cfg, {"tokens": toks})
    gpu_params = tree_map(lambda t: t.to(cuda), params)
    gpu_model = Transformer(cfg, gpu_params)
    kw = {"attn_impl": "flash"} if arch == "recurrentgemma-2b" else {}
    before = ops.flash_attention.launches
    got, _ = prefill(gpu_model, cfg.replace(**kw), {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    n_local = cfg.kinds.count("local")
    assert ops.flash_attention.launches == before + n_local
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)

    # the layer entry point with use_kernel=True: one launch, same result
    lp, clp = gpu_model.segments[0][0], cpu_model.segments[0][0]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    if arch == "recurrentgemma-2b":
        layer, counter = recurrent.rglru, ops.rglru_scan
        args = (getattr(lp, "0").rglru, getattr(clp, "0").rglru)
    else:
        layer, counter = recurrent.rwkv6_time_mix, ops.rwkv6_scan
        args = (getattr(lp, "0").tm, getattr(clp, "0").tm)
    before = counter.launches
    out, state = layer(args[0], x.to(cuda), cfg=cfg, use_kernel=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want_out, want_state = layer(args[1], x, cfg=cfg, use_kernel=True)
    np.testing.assert_allclose(out.cpu().numpy(), want_out.numpy(),
                               rtol=2e-4, atol=2e-4)
    for name in want_state:
        np.testing.assert_allclose(state[name].cpu().numpy(),
                                   want_state[name].numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


# A prefill's scans through K4 / K5 against the plain form: chip_smoke.py's
# hold of a layer through a kernel against its plain branch, absolute
LAYER_TOL = 1e-4
SCAN_KERNELS = {"recurrentgemma-2b": "rglru_scan", "rwkv6-3b": "rwkv6_scan"}


def _smoke_recurrent(arch, cuda):
    """The smoke model on the card (f32 weights from a seed), its number of
    recurrent layers and a batch of 2 x 40 tokens."""
    cfg = get_config(arch, smoke=True)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(7),
                         device="cpu")
    model = Transformer(cfg, tree_map(lambda t: t.to(cuda), params))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 40))).to(cuda)
    n_rec = sum(k in ("recurrent", "rwkv") for k in cfg.kinds)
    return cfg, model, {"tokens": toks}, n_rec


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_smoke_recurrent_prefill_takes_the_scan_kernel(cuda, arch,
                                                       monkeypatch):
    """The prefill on the card with the default use_kernel launches K5 /
    K4 once a recurrent layer and runs no plain scan; its logits and
    caches agree with the same prefill through use_kernel=False, which
    runs the plain scans and launches nothing, within LAYER_TOL."""
    import functools

    from repro_torch.models import transformer as tm
    cfg, model, batch, n_rec = _smoke_recurrent(arch, cuda)
    counter = getattr(ops, SCAN_KERNELS[arch])
    plain = []
    for name in ("rglru_scan_ref", "rwkv6_scan_ref"):
        fn = getattr(recurrent, name)
        monkeypatch.setattr(recurrent, name, lambda *a, fn=fn, **kw: (
            plain.append(fn), fn(*a, **kw))[1])
    before = counter.launches
    got, caches = prefill(model, cfg, batch)
    torch.cuda.synchronize()
    assert counter.launches == before + n_rec and plain == []
    for name in ("rglru", "rwkv6_time_mix"):
        monkeypatch.setattr(tm, name, functools.partial(
            getattr(recurrent, name), use_kernel=False))
    want, want_caches = prefill(model, cfg, batch)
    assert counter.launches == before + n_rec and len(plain) == n_rec
    assert (got - want).abs().max().item() <= LAYER_TOL
    for a, b in zip(tree_leaves(caches), tree_leaves(want_caches),
                    strict=True):
        assert (a.float() - b.float()).abs().max().item() <= LAYER_TOL


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-2b"])
def test_smoke_recurrent_layers_under_autograd_launch_nothing(cuda, arch):
    """Training needs gradients and K4 / K5 have no backward pass: the loss
    of the trainable smoke model on the card runs the plain scans, launches
    neither kernel and gives finite gradients."""
    from repro_torch.data import synthetic_batch
    from repro_torch.models.transformer import loss_fn
    cfg, model, _, _ = _smoke_recurrent(arch, cuda)
    grads = model.trainable()
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in synthetic_batch(cfg, 2, 40, step=0).items()}
    before = (ops.rglru_scan.launches, ops.rwkv6_scan.launches)
    loss, _ = loss_fn(model, cfg, batch)
    loss.backward()
    torch.cuda.synchronize()
    assert (ops.rglru_scan.launches, ops.rwkv6_scan.launches) == before
    leaves = tree_leaves(grads)
    assert all(bool(torch.isfinite(g).all()) for g in leaves)
    assert sum(g.abs().sum().item() for g in leaves) > 0


# ---------------------------------------------------------------------------
# K1, the Hanoi step machine
# ---------------------------------------------------------------------------

def hanoi_traps(W: int):
    """Programs for the places where a literal CUDA port of
    ``repro.core.hanoi`` would diverge from it, as ``{name: (program,
    init_regs or None, init_mem or None, active0 or None)}`` for
    ``MachineConfig(n_threads=W)`` (16 registers, 4 predicates, 8 Bx, 256
    words).  ``test_torch_hanoi.py`` holds the plain path to the JAX
    reference on them; the tests below hold K1 to the plain path."""
    from repro_torch.core.isa import Instr, Op, encode_program

    def prog(*rows):
        return encode_program([Instr(*r) for r in rows])

    rng = np.random.default_rng(W)
    mem = rng.integers(-50, 50, size=256).astype(np.int32)
    regs = rng.integers(-9, 9, size=(W, 16)).astype(np.int32)
    regs[0, 3], regs[1 % W, 3] = 0b0110, 0b1001
    I32_MAX = 0x7FFFFFFF
    return {
        # _first_lane of an empty mask is lane 0: WARPSYNC's mask register
        # is read from lane 0 when the path's mask is empty (active0=0)
        "first_lane_of_empty_mask": (prog(
            (Op.WARPSYNC, 0, 3), (Op.EXIT,)), regs, None, 0),
        # int32 add, mul and shl wrap; shifts take imm & 31; SHR is logical
        "int32_wrap": (prog(
            (Op.MOV, 1, 0, 0, 0, I32_MAX), (Op.IADDI, 2, 1, 0, 0, 1),
            (Op.IADD, 3, 1, 1), (Op.MOV, 4, 0, 0, 0, 0x10001),
            (Op.IMUL, 5, 4, 4), (Op.LANEID, 6), (Op.IMUL, 7, 1, 6),
            (Op.SHL, 8, 1, 0, 0, 33), (Op.SHL, 9, 6, 0, 0, -1),
            (Op.MOV, 10, 0, 0, 0, -8), (Op.SHR, 11, 10, 0, 0, 2),
            (Op.SHR, 12, 10, 0, 0, 35), (Op.EXIT,)), None, None, None),
        # addresses are (R + imm) floor-mod mem_size, after an int32 wrap
        "floor_mod_address": (prog(
            (Op.LANEID, 1), (Op.IADDI, 2, 1, 0, 0, -3),
            (Op.LDG, 3, 2, 0, 0, -300), (Op.STG, 0, 2, 1, 0, -1),
            (Op.MOV, 4, 0, 0, 0, I32_MAX), (Op.LDG, 5, 4, 0, 0, 5),
            (Op.STG, 0, 4, 6, 0, 9), (Op.EXIT,)), None, mem, None),
        # STG applies lanes in lane order, the last writer wins
        "stg_lane_order": (prog(
            (Op.LANEID, 1), (Op.MOV, 2, 0, 0, 0, 7), (Op.STG, 0, 2, 1),
            (Op.SHR, 3, 1, 0, 0, 1), (Op.STG, 0, 3, 1, 0, 20),
            (Op.ISETP, 0, 1, -1, 2, 2), (Op.STG, 0, 2, 1, 0, 1, 1),
            (Op.EXIT,)), None, mem, None),
        # the atomics too, each lane seeing the lanes before it; the old
        # value goes to Rdst clipped at 0 (dst -2 writes R0, dst 20 nothing)
        "atomic_lane_order": (prog(
            (Op.LANEID, 1), (Op.MOV, 2, 0, 0, 0, 9), (Op.MOV, 9, 0, 0, 0, -1),
            (Op.ISETP, 1, 1, -1, 0, 0), (Op.STG, 0, 2, 9, 0, 2, 2),
            (Op.ATOMADD, 5, 2, 1), (Op.ATOMEXCH, 6, 2, 1, 0, 1),
            (Op.IADDI, 8, 1, 0, 0, -1), (Op.ATOMCAS, 7, 2, 8, 1, 2),
            (Op.ATOMADD, -2, 2, 1, 0, 3), (Op.ATOMEXCH, 20, 2, 1, 0, 4),
            (Op.EXIT,)), None, np.zeros(256, np.int32), None),
        # register and predicate fields out of range: gathers clamp,
        # writes out of range write nothing, guard indices clamp
        "register_fields": (prog(
            (Op.MOV, 20, 0, 0, 0, 5), (Op.MOV, -1, 0, 0, 0, 6),
            (Op.MOVR, 1, 40), (Op.MOVR, 2, -3), (Op.LANEID, 3),
            (Op.ISETP, 6, 3, -1, 0, 1), (Op.ISETP, 3, 3, -1, 9, 1),
            (Op.MOV, 4, 0, 0, 0, 11, 9), (Op.MOV, 5, 0, 0, 0, 12, -9),
            (Op.IADD, 6, 30, -7), (Op.EXIT,)), regs, None, None),
        # Bx fields out of range: a negative index counts from the end
        # once, a scatter past it is dropped, a gather clamps
        # (the last BSYNC waits on a Bx that was never set: the warp
        # halts with its threads unfinished)
        "bx_fields": (prog(
            (Op.LANEID, 1), (Op.BSSY, -1, 0, 0, 0, 4),
            (Op.ISETP, 0, 1, -1, 2, 1), (Op.BRA, 0, 0, 0, 0, 4, 1),
            (Op.BSYNC, -1), (Op.BMOV_B2R, 3, 50), (Op.BMOV_R2B, -20, 1),
            (Op.BMOV_R2B, 2, 1), (Op.BREAK, -6),
            (Op.BSSY, -20, 0, 0, 0, 10), (Op.BSYNC, -20)),
            None, None, None),
        # an opcode past ATOMADD runs as ATOMADD, a negative one as NOP
        "opcode_clamp": (prog(
            (Op.LANEID, 1), (40, 5, 1, 1, 0, 3), (-3, 5, 1, 1),
            (Op.EXIT,)), None, mem, None),
        # a pc outside the program is an implicit EXIT
        "pc_out_of_program": (prog(
            (Op.LANEID, 1), (Op.ISETP, 0, 1, -1, 2, 2),
            (Op.BRA, 0, 0, 0, 0, 1000, 1), (Op.BRA, 0, 0, 0, 0, -5)),
            None, None, None),
        # BSSY in a loop pushes the REC stack past its depth: the pushes
        # past it are dropped, the top is read clamped
        "rec_stack_overflow": (prog(
            (Op.MOV, 1, 0, 0, 0, 0), (Op.BSSY, 0, 0, 0, 0, 5),
            (Op.IADDI, 1, 1, 0, 0, 1), (Op.ISETP, 0, 1, -1, 2, 3 * W + 9),
            (Op.BRA, 0, 0, 0, 0, 1, 1), (Op.EXIT,)), None, None, None),
        # WARPSYNC with every Bx taken sets the error flag
        "no_free_bx": (prog(
            *[(Op.BSSY, b, 0, 0, 0, 9) for b in range(8)],
            (Op.WARPSYNC, 0, -1, 0, 0, (1 << W) - 1), (Op.EXIT,)),
            None, None, None),
        # a loop that never ends spends all its fuel: the trace is full
        "out_of_fuel": (prog((Op.NOP,), (Op.BRA, 0, 0, 0, 0, 0)),
                        None, None, None),
    }


def _hanoi_operands(cases, cfg, device):
    """Batch arrays of ``{name: (program, regs, mem, skips)}`` as tensors
    on ``device``: programs padded with EXIT rows to a multiple of 32."""
    from repro_torch.core.isa import Op
    names = list(cases)
    N, W = len(names), cfg.n_threads
    L = -(-max(c[0].shape[0] for c in cases.values()) // 32) * 32
    progs = np.zeros((N, L, 8), np.int32)
    progs[:, :, 0] = int(Op.EXIT)
    skips = np.zeros((N, L), bool)
    regs = np.zeros((N, W, cfg.n_regs), np.int32)
    mems = np.zeros((N, cfg.mem_size), np.int32)
    for i, name in enumerate(names):
        prog, r, m, sk = cases[name]
        progs[i, :prog.shape[0]] = prog
        skips[i, list(sk)] = True
        if r is not None:
            regs[i] = r
        if m is not None:
            mems[i] = m
    lanes = np.broadcast_to(np.arange(W, dtype=np.int32), (N, W)).copy()
    return names, [torch.from_numpy(a).to(device)
                   for a in (progs, skips, regs, mems, lanes)]


def _suite_cases(cfg):
    """The figures, the spinlock and the suite, also with every BSYNC an
    oracle skip."""
    from repro_torch.core import programs as P
    from repro_torch.core.isa import Op
    out = {"fig5": (P.fig5_program(), None, None, ()),
           "fig6": (P.fig6_program(), None, None, ()),
           "warpsync": (P.warpsync_program(cfg.n_threads), None, None, ()),
           "spinlock": (P.spinlock_program(), None, None, ())}
    for b in P.make_suite(cfg):
        out[b.name] = (b.program, None, b.init_mem, b.skip_bsync_pcs)
        out[b.name + "+skip"] = (b.program, None, b.init_mem, tuple(
            np.flatnonzero(b.program[:, 0] == int(Op.BSYNC)).tolist()))
    return out


def _assert_states_equal(got, want, names):
    from repro_torch.core.hanoi import HanoiState
    for k in HanoiState._fields:
        g, w = getattr(got, k), getattr(want, k)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        rows = (g != w).reshape(g.shape[0], -1).any(1).nonzero().flatten()
        assert not len(rows), f"{k} differs for {[names[i] for i in rows]}"


def _k1_and_twin(names, ops_in, cfg, **kw):
    from repro_torch.core.hanoi import hanoi_run_plain
    before = ops.hanoi_run.launches
    got = ops.hanoi_run(*ops_in, cfg, **kw)
    torch.cuda.synchronize()
    assert ops.hanoi_run.launches == before + 1
    want = hanoi_run_plain(*ops_in, cfg, **kw)
    _assert_states_equal(got, want, names)
    return got


@pytest.mark.parametrize("W", [4, 32])
def test_hanoi_kernel_matches_plain_on_traps(cuda, W):
    """K1 against its twin, every field bit for bit, on the programs where
    a literal port would diverge from the reference.  1,000 slots of fuel:
    the out-of-fuel trap ends on a partial 32-entry trace block."""
    from repro_torch.core.isa import MachineConfig
    cfg = MachineConfig(n_threads=W, max_steps=1000)
    traps = hanoi_traps(W)
    for active0 in {t[3] for t in traps.values()}:
        cases = {n: (p, r, m, ()) for n, (p, r, m, a) in traps.items()
                 if a == active0}
        names, ops_in = _hanoi_operands(cases, cfg, cuda)
        _k1_and_twin(names, ops_in, cfg, active0=active0)


@pytest.mark.parametrize("W,n_bx,majority_first", [
    (4, 8, True), (4, 2, False), (32, 8, True), (32, 2, False)])
def test_hanoi_kernel_matches_plain_on_suite(cuda, W, n_bx, majority_first):
    from repro_torch.core.isa import MachineConfig
    cfg = MachineConfig(n_threads=W, n_bx=n_bx, max_steps=4096)
    names, ops_in = _hanoi_operands(_suite_cases(cfg), cfg, cuda)
    st = _k1_and_twin(names, ops_in, cfg, majority_first=majority_first)
    assert int(st.steps.max()) > 0


def test_hanoi_kernel_gives_the_same_bits_twice(cuda):
    from repro_torch.core.isa import MachineConfig
    cfg = MachineConfig(n_threads=32, max_steps=4096)
    names, ops_in = _hanoi_operands(_suite_cases(cfg), cfg, cuda)
    a = ops.hanoi_run(*ops_in, cfg)
    b = ops.hanoi_run(*ops_in, cfg)
    torch.cuda.synchronize()
    _assert_states_equal(a, b, names)


def test_hanoi_torch_on_card_matches_numpy(cuda):
    """``Simulator.run_batch(mechanism="hanoi_torch")`` on the card: one
    launch for each execution signature of the batch (BFSD's oracle skips
    make it a group of its own, as for ``hanoi_jax``), every result equal
    to the numpy ``hanoi``."""
    from repro_torch.core.isa import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import Simulator, as_request, get_mechanism
    from repro_torch.service.planner import plan_dispatch
    cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    suite = make_suite(cfg)
    groups = plan_dispatch(get_mechanism("hanoi_torch"),
                           [as_request(b, cfg) for b in suite])
    assert len(groups) == 2
    before = ops.hanoi_run.launches
    got = Simulator().run_batch(suite, cfg, mechanism="hanoi_torch")
    assert ops.hanoi_run.launches == before + len(groups)
    want = Simulator("hanoi").run_batch(suite, cfg)
    for a, b in zip(got, want):
        assert (a.status, a.trace, a.steps, a.fuel_left, a.finished,
                a.utilization, a.error) == (b.status, b.trace, b.steps,
                                            b.fuel_left, b.finished,
                                            b.utilization, b.error)
        for f in ("regs", "preds", "mem"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_replayer_on_card_ignores_archived_device(cuda, tmp_path):
    """An archive written on the CPU, its requests rewritten to name
    ``device: "cpu"`` as another writer might: ``Replayer()`` replays it on
    the card all the same (one launch of K1 for the suite's one signature
    group), bit-equal to the archive."""
    import json

    from repro_torch.archive import ArchiveReader, Replayer
    from repro_torch.core.isa import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import RotatingJsonlSink, Simulator
    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    suite = [b for b in make_suite(cfg, datasets=1) if not b.skip_bsync_pcs]
    sink = RotatingJsonlSink(str(tmp_path))
    Simulator(device="cpu", sink=sink).run_batch(suite, cfg)
    sink.close()
    for path in sink.paths:
        with open(path, encoding="utf-8") as fh:
            events = [json.loads(line) for line in fh]
        for ev in events:
            if ev["event"] == "begin":
                assert "device" not in ev["replay"]["meta"]
                ev["replay"]["meta"]["device"] = "cpu"
        with open(path, "w", encoding="utf-8") as fh:
            fh.writelines(json.dumps(ev) + "\n" for ev in events)
    runs = ArchiveReader(str(tmp_path)).runs()
    assert all(r.request().meta["device"] == "cpu" for r in runs)
    before = ops.hanoi_run.launches
    report = Replayer().replay(runs)
    assert ops.hanoi_run.launches == before + 1
    assert report.replayed == len(suite) == len(runs) > 0
    assert report.mean_discrepancy() == 0.0


def test_hanoi_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.core.isa import MachineConfig
    from repro_torch.kernels import hanoi_step
    cfg = MachineConfig(n_threads=4, max_steps=64)
    names, ops_in = _hanoi_operands(_suite_cases(cfg), cfg, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        hanoi_step.hanoi_run_cuda(ops_in[0].cpu(), *ops_in[1:], cfg)
    with pytest.raises(ValueError, match="regs"):
        hanoi_step.hanoi_run_cuda(ops_in[0], ops_in[1], ops_in[2][:, :2],
                                  *ops_in[3:], cfg)
    with pytest.raises(ValueError, match="n_threads"):
        hanoi_step.hanoi_run_cuda(*ops_in, cfg._replace(n_threads=33))
    # a Bx file that alone overflows a CTA's shared memory
    big = cfg._replace(n_bx=50_000)
    _, big_in = _hanoi_operands({"fig5": _suite_cases(cfg)["fig5"]}, big,
                                cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hanoi_step.hanoi_run_cuda(*big_in, big)


def test_hanoi_kernel_matches_plain_at_odd_shapes(cuda):
    """Shapes no other test takes: 7 threads, 12 registers, 3 predicates,
    3 Bx, 100 words of memory, 777 slots of fuel, and programs padded to
    an odd length (the shared-memory layout's alignment)."""
    from repro_torch.core.isa import MachineConfig, Op
    cfg = MachineConfig(n_threads=7, n_regs=12, n_preds=3, n_bx=3,
                        mem_size=100, max_steps=777)
    cases = {n: (p, r, m, ()) for n, (p, r, m, a) in hanoi_traps(7).items()
             if a is None}
    cases = {n: (p, None if r is None else r[:, :12],
                 None if m is None else m[:100], sk)
             for n, (p, r, m, sk) in cases.items()}
    cases.update({n: c for n, c in _suite_cases(cfg).items()
                  if not n.endswith("+skip")})
    names, ops_in = _hanoi_operands(cases, cfg, cuda)
    L = max(c[0].shape[0] for c in cases.values()) | 1    # EXIT-padded
    ops_in[0], ops_in[1] = ops_in[0][:, :L].contiguous(), \
        ops_in[1][:, :L].contiguous()
    for majority_first in (True, False):
        _k1_and_twin(names, ops_in, cfg, majority_first=majority_first)


def _shape_cases(cfg, extra=()):
    """The figures and the suite's programs (their memories drawn at the
    shape's mem_size), and the programs in ``extra``."""
    from repro_torch.core import programs as P
    out = {"fig5": (P.fig5_program(), None, None, ()),
           "fig6": (P.fig6_program(), None, None, ())}
    for b in P.make_suite(cfg)[:12]:
        out[b.name] = (b.program, None, b.init_mem, ())
    out.update(extra)
    return out


# the cases of _k1_layout_boundaries, by name: their shapes come from the
# layout the built kernel chooses, so they are found on the card
_K1_LAYOUT_CASES = ("largest_4_warp", "smallest_2_warp", "smallest_1_warp",
                    "global_memory", "global_program", "global_registers",
                    "mem_size_16384", "program_2048_rows", "n_regs_512",
                    "n_preds_40")


def _k1_layout_boundaries():
    """(name, cfg, program rows) at each boundary of K1's layouts: the
    largest memory image of 4 warps a CTA and the smallest of 2, the first
    of 1 warp and of the memory image in global memory; the program and
    then the registers in global memory; and the four shapes the JAX
    package runs that the first K1 refused."""
    from repro_torch.core.isa import MachineConfig
    from repro_torch.kernels import hanoi_step as hs
    base = MachineConfig(n_threads=32, mem_size=256, max_steps=512)

    def first_mem(pred, lo=1, hi=1 << 20):
        while lo < hi:                       # smallest mem_size with pred
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if not pred(mid) else (lo, mid)
        return lo

    def lay(m):
        return hs.layout(base._replace(mem_size=m), 32)

    m2 = first_mem(lambda m: lay(m).warps < 4)
    m1 = first_mem(lambda m: lay(m).warps < 2)
    mg = first_mem(lambda m: lay(m).global_mem)
    return [("largest_4_warp", base._replace(mem_size=m2 - 1), 32),
            ("smallest_2_warp", base._replace(mem_size=m2), 32),
            ("smallest_1_warp", base._replace(mem_size=m1), 32),
            ("global_memory", base._replace(mem_size=mg), 32),
            ("global_program", base._replace(mem_size=mg), 8192),
            ("global_registers", base._replace(mem_size=mg, n_regs=2048),
             8192),
            ("mem_size_16384", base._replace(mem_size=16_384), 32),
            ("program_2048_rows", base, 2048),
            ("n_regs_512", base._replace(n_regs=512), 32),
            ("n_preds_40", base._replace(n_preds=40), 32)]


def _wide_programs(cfg):
    """Programs that reach what the repaired shapes add: high registers,
    predicates past the first word, a long straight line."""
    from repro_torch.core.asm import assemble
    hi_r = min(cfg.n_regs - 1, 511)
    out = {"high_regs": (assemble(f"""
        LANEID R1
        IADDI R{hi_r}, R1, 5
        IADDI R{hi_r - 1}, R{hi_r}, 7
        STG [R1+3], R{hi_r - 1}
        EXIT"""), None, None, ())}
    if cfg.n_preds > 32:
        out["high_preds"] = (assemble("""
            LANEID R1
            ISETP.GE P35, R1, 9
            ISETP.LT P39, R1, 20
            @P35 IADDI R2, R1, 7
            @!P39 IADDI R3, R1, 9
            BSSY B0, join
            @P35 BRA right
            IADDI R4, R1, 1
            BRA join
        right:
            IADDI R4, R1, 2
        join:
            BSYNC B0
            ISETP.EQ P33, R4, 11
            @P33 MOV R5, 11
            EXIT"""), None, None, ())
    return out


@pytest.mark.parametrize("name", _K1_LAYOUT_CASES)
def test_hanoi_kernel_matches_plain_at_layout_boundaries(cuda, name):
    """K1 against its twin, every field bit for bit, at each layout
    boundary; the layout is the one ``hanoi_step.layout`` chose."""
    from repro_torch.core.isa import Op
    from repro_torch.kernels import hanoi_step as hs
    bounds = _k1_layout_boundaries()
    assert tuple(c[0] for c in bounds) == _K1_LAYOUT_CASES
    _, cfg, L = next(c for c in bounds if c[0] == name)
    cases = _shape_cases(cfg, _wide_programs(cfg))
    if L >= 2048:                      # a straight line through every row
        line = np.zeros((L - 1, 8), np.int32)
        line[:, 0], line[:, 1], line[:, 2], line[:, 5] = (
            int(Op.IADDI), 2, 2, 1)
        cases["straight_line"] = (np.concatenate(
            [line, [[int(Op.EXIT)] + [0] * 7]]).astype(np.int32), None,
            None, ())
    names, ops_in = _hanoi_operands(cases, cfg, cuda)
    pad = L - ops_in[0].shape[1]
    if pad > 0:                        # EXIT rows nobody reaches
        progs = torch.zeros((len(names), L, 8), dtype=torch.int32,
                            device=cuda)
        progs[:, :, 0] = int(Op.EXIT)
        progs[:, :ops_in[0].shape[1]] = ops_in[0]
        skips = torch.zeros((len(names), L), dtype=torch.bool, device=cuda)
        ops_in[0], ops_in[1] = progs, skips
    lay = hs.layout(cfg, ops_in[0].shape[1])
    expect = {"largest_4_warp": 4, "smallest_2_warp": 2,
              "smallest_1_warp": 1}
    if name in expect:
        assert (lay.warps, lay.global_mem) == (expect[name], False)
    if name.startswith("global"):
        assert lay.warps == 1 and lay.global_mem
        assert lay.global_prog == (name != "global_memory")
        assert lay.global_regs == (name == "global_registers")
    st = _k1_and_twin(names, ops_in, cfg)
    assert int(st.steps.max()) > 0


def _trace_of_length(t):
    """A program whose trace is ``t`` entries long when its fuel lasts: a
    straight line to EXIT, or a counted loop (MOV, then IADDI / ISETP /
    BRA n times, EXIT) after 0 to 2 NOPs."""
    from repro_torch.core.asm import assemble
    if t < 5:
        return assemble("NOP\n" * (t - 1) + "EXIT")
    n, k = divmod(t - 2, 3)
    return assemble("NOP\n" * k + f"MOV R2, {n}\nloop:\nIADDI R2, R2, -1\n"
                    "ISETP.GT P0, R2, 0\n@P0 BRA loop\nEXIT")


@pytest.mark.parametrize("name", _K1_LAYOUT_CASES)
def test_hanoi_kernel_fill_matches_plain(cuda, name):
    """K1's trace fill against its twin at each layout: traces of T, T - 1
    and T - 2 entries (no fill, one word, two), of T - 300 (at T 1001 a
    fill shorter than one bulk tile) and of 1 (the shortest a warp writes:
    its first slot always records an entry), at Ts not divisible by 4, so
    that each warp's row starts at another offset from a 16-byte boundary,
    and at one that is.  At T 3001 the rows are filled during the run from
    their end down, and the longer traces then grow into the filled range;
    two launches alike."""
    from repro_torch.core.isa import Op
    _, cfg, L = next(c for c in _k1_layout_boundaries() if c[0] == name)
    for T in (1001, 1024, 3001):
        tcfg = cfg._replace(max_steps=T)
        targets = (T, T - 1, T - 2, T - 300, 1, 7, T - 3)
        cases = {f"trace_{t}": (_trace_of_length(t), None, None, ())
                 for t in targets}
        names, ops_in = _hanoi_operands(cases, tcfg, cuda)
        progs = torch.zeros((len(names), L, 8), dtype=torch.int32,
                            device=cuda)
        progs[:, :, 0] = int(Op.EXIT)
        progs[:, :ops_in[0].shape[1]] = ops_in[0]
        ops_in[0] = progs
        ops_in[1] = torch.zeros((len(names), L), dtype=torch.bool,
                                device=cuda)
        st = _k1_and_twin(names, ops_in, tcfg)
        assert st.trace_n.tolist() == list(targets)
        _assert_states_equal(st, ops.hanoi_run(*ops_in, tcfg), names)


# ---------------------------------------------------------------------------
# K2, the SM issue scheduler
# ---------------------------------------------------------------------------

def sched_grid(seed, C, N, *, U=7, L=9, T=40, all_memory=False):
    """A synthetic K2 grid as numpy: ``(warp_map, trace_n, ops, trace_pc,
    trace_mask)`` with pcs out of the program (they read as NOP), opcodes
    out of range (clipped), empty traces and random u32 masks; with
    ``all_memory`` every opcode is LDG, so every warp waits on memory."""
    rng = np.random.default_rng(seed)
    trace_n = rng.integers(0, T + 1, (C, N)).astype(np.int32)
    trace_n[rng.random((C, N)) < 0.15] = 0
    warp_map = rng.integers(0, U, (C, N)).astype(np.int32)
    trace_pc = rng.integers(-2, L + 2, (U, T)).astype(np.int32)
    trace_mask = rng.integers(0, 1 << 32, (U, T), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    ops = (np.full((U, L), 24, np.int32) if all_memory
           else rng.integers(-3, 33, (U, L)).astype(np.int32))
    return warp_map, trace_n, ops, trace_pc, trace_mask


SCHED_LATENCIES = {"default": {}, "alu4_mem100": {"alu_latency": 4,
                                                  "memory_latency": 100}}


def _sched_tables(which):
    from repro_torch.engine.mechanisms.sm_torch import _latency_tables
    from repro_torch.timing import CycleConfig
    return _latency_tables(CycleConfig(scoreboard=False,
                                       **SCHED_LATENCIES[which]))


def _k2_and_twin(args, lat, is_mem, *, out_cap, policy):
    from repro_torch.kernels.sm_sched import sm_schedule_plain
    before = ops.sm_schedule.launches
    got = ops.sm_schedule(*args, lat, is_mem, out_cap=out_cap, policy=policy)
    again = ops.sm_schedule(*args, lat, is_mem, out_cap=out_cap,
                            policy=policy)
    torch.cuda.synchronize()
    assert ops.sm_schedule.launches == before + 2
    want = sm_schedule_plain(*args, lat, is_mem, out_cap=out_cap,
                             policy=policy)
    for k in want._fields:
        g, a, w = getattr(got, k), getattr(again, k), getattr(want, k)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert torch.equal(g, w), k
        assert torch.equal(g, a), k
    return got


@pytest.mark.parametrize("N", [1, 7, 32, 64, 100])
@pytest.mark.parametrize("policy", ["greedy_then_oldest", "round_robin",
                                    "oldest_first"])
def test_sm_sched_kernel_matches_plain(cuda, N, policy):
    """K2 against its twin, every output bit for bit (the fill included)
    and two launches alike, on synthetic grids: one hardware warp a cell up
    to 32 warps, a CTA a cell past that; default and slow latencies, and a
    grid where every warp waits on memory."""
    for seed, which, all_memory in ((N, "default", False),
                                    (N + 1, "alu4_mem100", False),
                                    (N + 2, "alu4_mem100", True)):
        args = [torch.from_numpy(a).to(cuda)
                for a in sched_grid(seed, 9, N, all_memory=all_memory)]
        total = int(args[1].sum(1).max())
        s = _k2_and_twin(args, *_sched_tables(which),
                         out_cap=max(32, -(-total // 32) * 32),
                         policy=policy)
        if all_memory:
            assert int(s.mstall.sum()) > 0


def _k2_redesign_case(case, N, device):
    """A one-cell K2 grid of ``N`` warps on ``device`` that stresses the narrow layout's
    redesign, as ``(args, lat, is_mem, out_cap)``: every trace entry's pc is
    its own (so a wrong ring entry shows) and its mask is random.

    - ``long_run``: warp 0's trace is 300 entries of single-cycle opcodes,
      so under GTO it issues them in one run and its ring refills at every
      position; the others are short;
    - ``all_gaps``: every latency is 3, the cell's warps issue 1 entry
      each, then warp 0 alone: every slot after the first round is a gap;
    - ``ring_lengths``: traces of 1 entry, of exactly the ring's 64, of
      a top-up's reach (40) and of one block of slots (16);
    - ``cycle_wraps``: latencies of 2^30, so the cycle passes 2^31 and
      wraps, and the waits exceed the packed word;
    - ``wide_waits``: latencies of 3 and of 2^22 (past the packed word's
      2^21 - 1) in one cell."""
    from repro_torch.kernels.sm_sched import N_OPS
    rng = np.random.default_rng(N * 100 + len(case))
    T = 301                               # not a multiple of 4
    L = T
    ops_col = rng.integers(0, N_OPS, (N, L)).astype(np.int32)
    trace_pc = np.tile(np.arange(T, dtype=np.int32), (N, 1))
    trace_mask = rng.integers(0, 1 << 32, (N, T), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    trace_n = np.full(N, 12, np.int32)
    lat = np.full(N_OPS, 2, np.int32)
    is_mem = np.zeros(N_OPS, bool)
    if case == "long_run":
        ops_col[:] = 0                    # NOP: control latency 1
        lat[0] = 1
        trace_n[0] = 300
    elif case == "all_gaps":
        lat[:] = 3
        trace_n[:] = 1
        trace_n[0] = 120
    elif case == "ring_lengths":
        trace_n[:] = np.resize([1, 64, 40, 16], N)
    elif case == "cycle_wraps":
        lat[:] = 1 << 30
        is_mem[::2] = True
        trace_n[:] = 9
    elif case == "wide_waits":
        lat[::3] = 1 << 22
        is_mem[::3] = True
        lat[1::3] = 3
    warp_map = np.arange(N, dtype=np.int32)[None]
    args = [torch.from_numpy(a).to(device) for a in
            (warp_map, trace_n[None], ops_col, trace_pc, trace_mask)]
    out_cap = -(-int(trace_n.sum()) // 32) * 32
    return args, lat, is_mem, out_cap


@pytest.mark.parametrize("N", [1, 7, 32])
@pytest.mark.parametrize("case", ["long_run", "all_gaps", "ring_lengths",
                                  "cycle_wraps", "wide_waits"])
def test_sm_sched_narrow_layout_redesign(cuda, case, N):
    """The narrow layout against its twin, every output bit for bit and two
    launches alike, on the shapes its design puts at risk, every policy."""
    args, lat, is_mem, out_cap = _k2_redesign_case(case, N, cuda)
    for policy in ("greedy_then_oldest", "round_robin", "oldest_first"):
        s = _k2_and_twin(args, lat, is_mem, out_cap=out_cap, policy=policy)
        assert int(s.issued[0]) == int(args[1].sum())
    if case == "all_gaps" and N == 1:
        assert int(s.sstall[0]) == 2 * (120 - 1)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("N", [7, 32])
def test_sm_sched_narrow_layout_unstaged(cuda, N, exact):
    """The narrow layout's builds that read the opcode columns from global
    memory: cells whose N x L opcodes do not fit in shared memory, with
    pcs inside and outside the program and opcodes out of range, waits
    inside and past the packed word, every policy; every output bit for
    bit to the twin and two launches alike."""
    from repro_torch.kernels.sm_sched import N_OPS, narrow_layout
    C, T, L = 3, 300, 224_000 // N
    rng = np.random.default_rng(N + 10 * exact)
    ops_col = rng.integers(-3, N_OPS + 4, (N, L)).astype(np.int32)
    trace_pc = rng.integers(-2, L + 2, (N, T)).astype(np.int32)
    trace_mask = rng.integers(0, 1 << 32, (N, T), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    trace_n = rng.integers(0, 40, (C, N)).astype(np.int32)
    warp_map = rng.integers(0, N, (C, N)).astype(np.int32)
    lat, is_mem = _sched_tables("alu4_mem100")
    if exact:
        lat = lat.copy()
        lat[::3] = 1 << 22
    out_cap = -(-int(trace_n.sum(1).max()) // 32) * 32
    lay = narrow_layout(C, N, L, lat, out_cap=out_cap)
    assert (lay.staged, lay.exact) == (False, exact)
    assert narrow_layout(C, N, 301, lat, out_cap=out_cap).staged
    args = [torch.from_numpy(a).to(cuda) for a in
            (warp_map, trace_n, ops_col, trace_pc, trace_mask)]
    for policy in ("greedy_then_oldest", "round_robin", "oldest_first"):
        s = _k2_and_twin(args, lat, is_mem, out_cap=out_cap, policy=policy)
        assert torch.equal(s.issued, args[1].sum(1).to(torch.int32))


def test_sm_sched_kernel_on_k1_traces(cuda):
    """K2 reads K1's trace buffers in place: the suite at 8 threads, cells
    of 1, 8, 32 and 64 warps drawn from its rows, every policy."""
    from repro_torch.core.isa import MachineConfig
    from repro_torch.engine.mechanisms.sm_torch import _out_capacity
    cfg = MachineConfig(n_threads=8, max_steps=1024)
    names, ops_in = _hanoi_operands(_suite_cases(cfg), cfg, cuda)
    st = ops.hanoi_run(*ops_in, cfg)
    code = ops_in[0][:, :, 0].contiguous()
    rng = np.random.default_rng(0)
    for N in (1, 8, 32, 64):
        warp_map = torch.from_numpy(rng.integers(
            0, len(names), (6, N)).astype(np.int32)).to(cuda)
        trace_n = st.trace_n[warp_map.long()]
        out_cap = _out_capacity(int(trace_n.sum(1).max()))
        for policy in ("greedy_then_oldest", "round_robin", "oldest_first"):
            _k2_and_twin([warp_map, trace_n, code, st.trace_pc,
                          st.trace_mask], *_sched_tables("default"),
                         out_cap=out_cap, policy=policy)


def test_sm_sched_kernel_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import sm_sched
    args = [torch.from_numpy(a).to(cuda) for a in sched_grid(0, 2, 4)]
    lat, is_mem = _sched_tables("default")
    with pytest.raises(ValueError, match="one CUDA device"):
        sm_sched.sm_schedule_cuda(args[0].cpu(), *args[1:], lat, is_mem,
                                  out_cap=64, policy="round_robin")
    with pytest.raises(ValueError, match="multiple of 32"):
        sm_sched.sm_schedule_cuda(*args, lat, is_mem, out_cap=40,
                                  policy="round_robin")
    with pytest.raises(TypeError, match="int32"):
        sm_sched.sm_schedule_cuda(args[0].long(), *args[1:], lat, is_mem,
                                  out_cap=64, policy="round_robin")


def test_sm_torch_on_card_matches_cpu(cuda):
    """``run_batch(mechanism="sm_torch")`` on the card: one K1 and one K2
    launch for the grid, every SmResult equal to the CPU twins' and to
    ``sm_interleave``."""
    from repro_torch.core.isa import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import SimRequest, Simulator
    cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=1024)
    suite = make_suite(cfg)
    sim = Simulator()
    for policy in ("greedy_then_oldest", "round_robin", "oldest_first"):
        meta = {"sm_warps": 8, "sm_policy": policy,
                "sm_inner": "hanoi_torch"}
        reqs = [SimRequest(program=b.program, cfg=cfg, name=b.name,
                           init_mem=b.init_mem, meta=meta) for b in suite]
        k1, k2 = ops.hanoi_run.launches, ops.sm_schedule.launches
        got = sim.run_batch(reqs, mechanism="sm_torch")
        assert (ops.hanoi_run.launches, ops.sm_schedule.launches) == \
            (k1 + 1, k2 + 1)
        want = sim.run_batch([SimRequest(
            program=q.program, cfg=cfg, name=q.name, init_mem=q.init_mem,
            meta={**meta, "device": "cpu"}) for q in reqs[:6]],
            mechanism="sm_torch")
        for a, b in zip(got, want):
            sa, sb = a.meta["sm"], b.meta["sm"]
            assert sa.sm_trace == sb.sm_trace
            assert (sa.cycles, sa.stall_breakdown, sa.busy_cycles,
                    sa.thread_instructions) == (sb.cycles, sb.stall_breakdown,
                                                sb.busy_cycles,
                                                sb.thread_instructions)
        longest = max(got, key=lambda r: r.steps).meta["sm"]
        ref = sim.run_sm(list(longest.requests), policy=policy,
                         inner="hanoi_torch", sm_mechanism="sm_interleave")
        assert ref.mechanism == "sm_interleave"
        assert (longest.sm_trace, longest.cycles, longest.stall_breakdown) \
            == (ref.sm_trace, ref.cycles, ref.stall_breakdown)


def test_build_load_from_two_threads_builds_once(cuda, tmp_path,
                                                 monkeypatch):
    """Two threads that reach a cold ``_build.load`` together run ``nvcc``
    once, load one library, and leave no temporary behind."""
    import subprocess
    import threading

    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    runs, real = [], subprocess.Popen

    def counting(cmd, *a, **kw):
        runs.append(cmd)
        return real(cmd, *a, **kw)
    monkeypatch.setattr(_build.subprocess, "Popen", counting)
    barrier = threading.Barrier(2)
    libs, errors = [None, None], []

    def go(i):
        barrier.wait()
        try:
            libs[i] = _build.load("rglru_scan")
        except Exception as exc:           # reported below
            errors.append(exc)
    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and libs[0] is not None and libs[0] is libs[1]
    assert len(runs) == 1
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".log", ".so"]


def _service_requests(cfg, n):
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import SimRequest
    suite = [b for b in make_suite(cfg) if not b.skip_bsync_pcs]
    return [SimRequest(program=suite[i % len(suite)].program, cfg=cfg,
                       init_mem=suite[i % len(suite)].init_mem,
                       name=f"{suite[i % len(suite)].name}#{i}")
            for i in range(n)]


def _same_result(a, b):
    assert (a.mechanism, a.status, a.trace, a.steps, a.fuel_left,
            a.finished, a.utilization, a.error) == \
        (b.mechanism, b.status, b.trace, b.steps, b.fuel_left, b.finished,
         b.utilization, b.error)
    for f in ("regs", "preds", "mem"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_service_on_card_matches_run_batch(cuda):
    """``SimulationService()`` with its defaults (``hanoi_torch`` on the
    card, two workers each on its own stream) returns, for requests
    submitted one by one, ``Simulator().run_batch``'s results in every
    field, through K1."""
    from repro_torch.core.isa import MachineConfig
    from repro_torch.engine import Simulator
    from repro_torch.service import SimulationService
    cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=8192)
    reqs = _service_requests(cfg, 200)
    want = Simulator().run_batch(reqs)
    before = ops.hanoi_run.launches
    with SimulationService(max_wait_s=600.0) as svc:
        tickets = [svc.submit(r) for r in reqs]
        svc.flush()
        got = [t.result(600) for t in tickets]
        stats = svc.stats()
    assert ops.hanoi_run.launches - before == stats.native_batches >= 4
    assert stats.completed == len(reqs) and stats.failed == 0
    for a, b in zip(got, want):
        _same_result(a, b)
        assert a.meta["service"]["native"] is True


def test_service_warm_restart_on_card_takes_no_miss(cuda, tmp_path):
    """One shard process on the card: a cold service misses and records
    its signatures; a restarted one loads them (the libraries are built)
    and launches K1 once a signature before admitting traffic, then serves
    the same traffic with no miss, bit-equal to the cold run."""
    from repro_torch.core.isa import MachineConfig
    from repro_torch.service import SimulationService
    cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=8192)
    reqs = _service_requests(cfg, 64)
    runs = []
    for _ in range(2):
        with SimulationService(procs=1, max_wait_s=600.0,
                               warm_start=str(tmp_path)) as svc:
            out = svc.run(reqs, timeout=600)
            runs.append((out, svc.stats()))
    (cold, st1), (warm, st2) = runs
    assert st1.cache_misses >= 1
    assert st2.warm_signatures == st2.warm_loaded >= 1
    assert st2.cache_misses == st2.warm_retraced == 0
    assert dict(st2.shards[0].launches)["hanoi_run"] >= \
        st2.warm_signatures + st2.native_batches
    for a, b in zip(warm, cold):
        _same_result(a, b)


def test_replay_through_service_on_card(cuda, tmp_path):
    """A CPU-written archive replayed through ``Replayer(service=)`` on
    the card: K1 launches, exactly 0.0, the report of ``Replayer()``."""
    from repro_torch.archive import Replayer
    from repro_torch.core.isa import MachineConfig
    from repro_torch.engine import RotatingJsonlSink, Simulator
    from repro_torch.service import SimulationService
    cfg = MachineConfig(n_threads=8, mem_size=64, max_steps=8192)
    sink = RotatingJsonlSink(str(tmp_path))
    Simulator(device="cpu", sink=sink).run_batch(_service_requests(cfg, 40))
    sink.close()
    want = Replayer().replay(str(tmp_path))
    before = ops.hanoi_run.launches
    with SimulationService() as svc:
        got = Replayer(service=svc).replay(str(tmp_path))
    assert ops.hanoi_run.launches > before
    assert got.replayed == want.replayed == 40
    assert got.mean_discrepancy() == 0.0
    assert [(r.program, r.discrepancy) for r in got.rows] == \
        [(r.program, r.discrepancy) for r in want.rows]


def test_kernels_refuse_autograd_on_card(cuda):
    """K3-K5 have no backward pass: their wrappers refuse a CUDA input that
    requires grad while grad mode is on, before anything launches."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=cuda)

    calls = {"flash_attention": (ops.flash_attention,
                                 [rand(1, 64, 2, 64) for _ in range(3)]),
             "rglru_scan": (ops.rglru_scan, [rand(1, 64, 8) for _ in
                                             range(2)]),
             "rwkv6_scan": (ops.rwkv6_scan, [rand(1, 64, 2, 64) for _ in
                                             range(4)] + [rand(2, 64)])}
    for name, (fn, args) in calls.items():
        before = fn.launches
        args[0].requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"ops.{name} has no backward"):
            fn(*args)
        assert fn.launches == before
        with torch.no_grad():
            fn(*args)
        assert fn.launches == before + 1


def test_train_step_card_vs_cpu(cuda):
    """Two steps of llama3.2-1b's smoke config from the same f32 weights
    and batches, on the card and on the CPU (TF32 off): losses, grad norms
    and every parameter after them within 1e-5 (f32 products and sums in
    other orders)."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import make_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config("llama3.2-1b", smoke=True)
    params = init_params(model_struct(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    step = make_step(cfg, AdamWConfig(lr=1e-2), total_steps=4)
    runs = {}
    for dev in ("cpu", cuda):
        model = Transformer(cfg, tree_map(lambda t: t.to(dev, copy=True),
                                          params))
        model.trainable()
        opt, losses = adamw_init(model.tree), []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in synthetic_batch(cfg, 2, 64, step=i).items()}
            model, opt, _, m = step(model, opt, None, batch)
            losses.append((m["loss"].item(), m["grad_norm"].item()))
        runs[str(dev)] = (losses, [t.cpu() for t in tree_leaves(model.tree)])
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for a, b in zip(pg, pc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# distribution: ranks that share the card ------------------------------------

def _sharded_prefill_rank(rank, world, toks):
    """Rank ``rank`` of a (1, world) mesh on the card: the smoke llama's
    bf16 prefill through K3 on its heads; (K3 launches, whole logits)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import prefill_config
    from repro_torch.runtime import full_tensor
    from repro_torch.sharding import local_batch, param_pspecs
    dev = torch.device("cuda")
    mesh = make_host_mesh(world, dev)
    cfg = prefill_config("llama3.2-1b", smoke=True, attn_impl="flash",
                         mesh=mesh, batch=toks.shape[0])
    struct = model_struct(cfg)
    model = Transformer(cfg, init_params(
        struct, torch.Generator(device=dev).manual_seed(0),
        dtype=torch.bfloat16, device=dev, mesh=mesh,
        specs=param_pspecs(struct, cfg, mesh)))
    ops.flash_attention.launches = 0
    logits, _ = prefill(model, cfg, local_batch(
        {"tokens": torch.from_numpy(toks).to(dev)}, cfg, mesh))
    torch.cuda.synchronize()
    return ops.flash_attention.launches, full_tensor(logits).float().cpu()


def test_sharded_prefill_on_card_launches_k3_per_rank(cuda):
    """Two ranks sharing the card over gloo, the smoke llama at (1, 2):
    each launches K3 once a layer on its 4 of 8 heads, and the logits
    equal the one-rank prefill's within the bf16 hold of the full-size
    run (5e-2 of the largest logit)."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.steps import prefill_config
    cfg = prefill_config("llama3.2-1b", smoke=True, attn_impl="flash")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    res = spawn_world(_sharded_prefill_rank, 2, toks, device="cuda")
    model = Transformer(cfg, init_params(
        model_struct(cfg), torch.Generator(device=cuda).manual_seed(0),
        dtype=torch.bfloat16, device=cuda))
    want = prefill(model, cfg, {"tokens": torch.from_numpy(toks).to(cuda)}
                   )[0].float().cpu()
    for launches, got in res:
        assert launches == cfg.n_layers
        got = got[..., :cfg.vocab_size]
        assert (got - want).abs().max() <= 5e-2 * want.abs().max()


def _compress_rank(rank, world, xs):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime import compressed_allreduce
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    x = torch.from_numpy(xs[rank])
    return (compressed_allreduce(x.cuda(), mesh, "data").cpu(),
            compressed_allreduce(x, mesh, "data"))


def test_compressed_allreduce_on_card_equals_cpu(cuda):
    """Over two ranks sharing the card: int8 on the wire through gloo,
    the card's result bit-equal to the CPU's on the same inputs."""
    from repro_torch.launch.mesh import spawn_world
    xs = np.random.default_rng(1).standard_normal((2, 5003)).astype(
        np.float32)
    for card, cpu in spawn_world(_compress_rank, 2, xs, device="cuda"):
        assert torch.equal(card, cpu)
        want = torch.from_numpy(xs.sum(0))
        assert (card - want).abs().max() / want.abs().max() < 0.05


def _nccl_step_rank(rank, world):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import mesh_config
    from repro_torch.launch.train import build_train_state, make_step
    from repro_torch.data import synthetic_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import local_batch
    dev = torch.device("cuda")
    cfg = get_config("llama3.2-1b", smoke=True)
    rows = {}
    for key, mesh in (("one", None), ("mesh", make_host_mesh(1, dev))):
        c = cfg if mesh is None else mesh_config(cfg, mesh, 2)
        model, opt = build_train_state(c, 0, dev, mesh)
        step = make_step(c, AdamWConfig(lr=3e-3), total_steps=3)
        out = []
        for i in range(3):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthetic_batch(cfg, 2, 32, step=i).items()}
            if mesh is not None:
                b = local_batch(b, c, mesh)
            model, opt, _, m = step(model, opt, None, b)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        rows[key] = out
    return dist.get_backend(), rows


def test_train_step_on_a_one_rank_nccl_mesh(cuda):
    """A world of one over NCCL: the sharded step on a (1, 1) mesh against
    the one-rank step, within 1e-5 relative (the vocab-parallel CE sums in
    another order)."""
    from repro_torch.launch.mesh import spawn_world
    [(backend, rows)] = spawn_world(_nccl_step_rank, 1, device="cuda")
    assert backend == "nccl"
    np.testing.assert_allclose(rows["mesh"], rows["one"], rtol=1e-5)
