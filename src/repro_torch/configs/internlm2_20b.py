"""InternLM2-20B [arXiv:2403.17297]: the largest dense cell (GQA kv=8)."""
from repro_torch.models.base import GLOBAL, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    layer_plan=uniform_plan(GLOBAL, 48),
).validate()

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=96, layer_plan=uniform_plan(GLOBAL, 2),
).validate()
