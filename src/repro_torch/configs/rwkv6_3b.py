"""RWKV-6 'Finch' 3B [arXiv:2404.05892]: attention-free; data-dependent decay
time-mix + channel-mix; head dim 64 (40 heads at d=2560)."""
from repro_torch.models.base import RWKV, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    layer_plan=uniform_plan(RWKV, 32), rwkv_head_dim=64,
).validate()

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=96, layer_plan=uniform_plan(RWKV, 2), rwkv_head_dim=16,
).validate()
