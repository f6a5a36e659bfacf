"""Minitron-4B [arXiv:2407.14679]: width/depth-pruned Nemotron-4."""
from repro_torch.models.base import GLOBAL, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    layer_plan=uniform_plan(GLOBAL, 32),
).validate()

SMOKE = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=96, layer_plan=uniform_plan(GLOBAL, 2),
).validate()
