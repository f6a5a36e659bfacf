"""Architecture registry.  The port carries llama3.2-1b, recurrentgemma-2b
and rwkv6-3b so far; the other seven architectures of the JAX package are
named so that asking for one says where it stands instead of failing as
unknown."""
from __future__ import annotations

from repro_torch.models.base import ModelConfig

from . import llama3_2_1b, recurrentgemma_2b, rwkv6_3b

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "rwkv6-3b": rwkv6_3b,
}

# architecture -> the ROADMAP.md item that ports it
NOT_PORTED = {
    "hubert-xlarge": "item 9",
    "gemma3-4b": "item 9",
    "minitron-4b": "item 9",
    "internlm2-20b": "item 9",
    "internvl2-2b": "item 9",
    "mixtral-8x7b": "items 8 and 9",
    "deepseek-moe-16b": "items 8 and 9",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, Open items, "
            f"{NOT_PORTED[name]})")
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.CONFIG
