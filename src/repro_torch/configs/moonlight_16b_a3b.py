"""Moonlight-16B-A3B (moonshotai, DeepSeek-V3's block at 16 B parameters):
27 layers of multi-head latent attention (no query LoRA; latent rank 512,
head dims 128 nope + 64 rope for q and k, 128 for v), the first layer
dense (d_ff 11264), then 64 routed experts top 6 by sigmoid scores with a
correction bias (one expert group, gates renormalized and scaled by
2.446) and 2 shared experts, 1408 wide.  The port's own architecture: the
JAX package has none."""
from repro_torch.models.base import MLA, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab_size=163840,
    layer_plan=uniform_plan(MLA, 27),
    n_experts=64, experts_per_token=6, moe_d_ff=1408,
    n_shared_experts=2, first_dense_layers=1,
    rope_theta=50_000.0, norm_eps=1e-5,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, kv_norm_eps=1e-6,
    router_score="sigmoid", routed_scale=2.446,
).validate()

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab_size=96, layer_plan=uniform_plan(MLA, 3),
    n_experts=8, experts_per_token=3, moe_d_ff=32, n_shared_experts=2,
    first_dense_layers=1,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16,
).validate()
