"""InternVL2-2B [arXiv:2404.16821]: InternLM2-1.8B language backbone; the
InternViT vision tower is a STUB (precomputed patch embeddings)."""
from repro_torch.models.base import GLOBAL, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    layer_plan=uniform_plan(GLOBAL, 24),
    frontend="vision_stub", frontend_dim=1024, n_patches=256,
).validate()

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=96, layer_plan=uniform_plan(GLOBAL, 2),
    frontend_dim=16, n_patches=4,
).validate()
