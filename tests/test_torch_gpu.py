"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the smoke model's prefill through the kernel held against the
port's CPU path (which ``test_torch_models.py`` holds against JAX).

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
from repro_torch.launch.steps import prefill
from repro_torch.models import Transformer, forward, init_params, model_struct
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
])
def test_cuda_kernel_matches_plain(cuda, B, S, H, Kh, hd, causal, window,
                                   dtype, tol):
    q, k, v = _qkv(S, B, S, H, Kh, hd, dtype, cuda)
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    blk = min(fa.DEFAULT_BQ, max(8, S))
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    bq=blk, bk=blk)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def test_cuda_kernel_reads_strided_inputs(cuda):
    """q, k, v as slices of one fused qkv tensor: read through strides."""
    qkv = _qkv(5, 2, 130, 12, 1, 64, torch.float32, cuda)[0]   # [2,130,12,64]
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:12]
    out = ops.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_cuda_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q)
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

