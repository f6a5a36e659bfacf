"""Gemma-3 4B [hf:google/gemma-3-*-pt]: 5 local : 1 global attention pattern,
local window 1024, huge 262k vocabulary, tied embeddings."""
from repro_torch.models.base import GLOBAL, LOCAL, ModelConfig, cycle_plan

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab_size=262144,
    layer_plan=cycle_plan((LOCAL,) * 5 + (GLOBAL,), 34),
    window_size=1024, rope_theta=1_000_000.0, tie_embeddings=True,
).validate()

SMOKE = CONFIG.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=128, layer_plan=cycle_plan((LOCAL,) * 5 + (GLOBAL,), 7),
    window_size=8,
).validate()
