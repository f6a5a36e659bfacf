from .base import (GLOBAL, LOCAL, MLA, RECURRENT, RWKV, SWA, ModelConfig, P,
                   Params, cycle_plan, init_params, param_count, uniform_plan)
from .transformer import (Transformer, cache_struct, decode_step, forward,
                          loss_fn, model_struct)

__all__ = [
    "GLOBAL", "LOCAL", "MLA", "RECURRENT", "RWKV", "SWA", "ModelConfig", "P",
    "Params", "Transformer", "cache_struct", "cycle_plan", "decode_step",
    "forward", "init_params", "loss_fn", "model_struct", "param_count",
    "uniform_plan",
]
