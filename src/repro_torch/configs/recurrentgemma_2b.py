"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: RG-LRU recurrent blocks
mixed 2:1 with local attention (window 2048), kv=1 MQA."""
from repro_torch.models.base import LOCAL, RECURRENT, ModelConfig, cycle_plan

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000,
    layer_plan=cycle_plan((RECURRENT, RECURRENT, LOCAL), 26),
    window_size=2048, lru_width=2560, tie_embeddings=True,
).validate()

SMOKE = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=128, layer_plan=cycle_plan((RECURRENT, RECURRENT, LOCAL), 5),
    window_size=8, lru_width=64,
).validate()
