"""HuBERT X-Large [arXiv:2106.07447]: 48L encoder-only, same arch as
wav2vec2-XL.  The audio frontend (conv feature encoder) is a STUB: inputs are
precomputed frame embeddings (brief: '[audio] entries specify the transformer
BACKBONE only')."""
from repro_torch.models.base import GLOBAL, ModelConfig, uniform_plan

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    layer_plan=uniform_plan(GLOBAL, 48),
    causal=False,
    frontend="audio_stub", frontend_dim=512,
).validate()

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=64, layer_plan=uniform_plan(GLOBAL, 3), frontend_dim=16,
).validate()
