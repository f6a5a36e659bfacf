"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained 64 routed experts top-6
plus 2 shared experts; first layer dense (d_ff 10944); expert ff = 1408."""
from repro_torch.models.base import GLOBAL, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    layer_plan=uniform_plan(GLOBAL, 28),
    n_experts=64, experts_per_token=6, moe_d_ff=1408,
    n_shared_experts=2, first_dense_layers=1,
).validate()

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab_size=96, layer_plan=uniform_plan(GLOBAL, 3),
    n_experts=8, experts_per_token=3, moe_d_ff=32, n_shared_experts=2,
    first_dense_layers=1,
).validate()
