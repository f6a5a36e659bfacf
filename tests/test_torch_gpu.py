"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the smoke models' prefill on the card held against the port's
CPU path (which ``test_torch_models.py`` and ``test_torch_recurrent.py``
hold against JAX).  K1, the Hanoi step machine, is held to its twin bit for
bit in every field of the state, on the suite and on the divergence traps
(:func:`hanoi_traps`, which ``test_torch_hanoi.py`` holds to JAX).

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
from repro_torch.models.base import tree_map

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
    want = Simulator().run_batch(suite, cfg, mechanism="hanoi")
    for a, b in zip(got, want):
        assert (a.status, a.trace, a.steps, a.fuel_left, a.finished,
                a.utilization, a.error) == (b.status, b.trace, b.steps,
                                            b.fuel_left, b.finished,
                                            b.utilization, b.error)
        for f in ("regs", "preds", "mem"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


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
    big = cfg._replace(mem_size=1 << 16)
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
