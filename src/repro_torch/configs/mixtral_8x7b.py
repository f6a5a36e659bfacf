"""Mixtral 8x7B [arXiv:2401.04088]: 8 experts top-2 MoE with sliding-window
attention (window 4096)."""
from repro_torch.models.base import SWA, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    layer_plan=uniform_plan(SWA, 32), window_size=4096,
    n_experts=8, experts_per_token=2, moe_d_ff=14336,
).validate()

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=96, layer_plan=uniform_plan(SWA, 2), window_size=8,
    n_experts=4, experts_per_token=2, moe_d_ff=128,
).validate()
