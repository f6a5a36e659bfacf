"""Llama-3.2 1B [hf:meta-llama/Llama-3.2-1B]: small Llama-3, tied embeddings."""
from repro_torch.models.base import GLOBAL, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256,
    layer_plan=uniform_plan(GLOBAL, 16),
    rope_theta=500_000.0, tie_embeddings=True,
).validate()

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab_size=96, layer_plan=uniform_plan(GLOBAL, 2),
).validate()
