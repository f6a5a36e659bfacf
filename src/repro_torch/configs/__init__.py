"""Architecture registry (port of ``repro.configs``): the 10 assigned
configs + reduced smoke variants, and the per-arch input-shape cell map
(which cells run / why skipped).  ``ARCH_NAMES``, the shapes and the cells
stay the JAX package's; the architectures only the port runs
(``PORT_ARCH_NAMES``: moonlight-16b-a3b, latent attention) resolve through
:func:`get_config` beside them."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.base import ModelConfig

from . import (deepseek_moe_16b, gemma3_4b, hubert_xlarge, internlm2_20b,
               internvl2_2b, llama3_2_1b, minitron_4b, mixtral_8x7b,
               moonlight_16b_a3b, recurrentgemma_2b, rwkv6_3b)

_MODULES = {
    "hubert-xlarge": hubert_xlarge,
    "gemma3-4b": gemma3_4b,
    "minitron-4b": minitron_4b,
    "internlm2-20b": internlm2_20b,
    "llama3.2-1b": llama3_2_1b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "internvl2-2b": internvl2_2b,
    "mixtral-8x7b": mixtral_8x7b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "rwkv6-3b": rwkv6_3b,
}

ARCH_NAMES = tuple(_MODULES)

# the port's own architectures: no JAX counterpart, so no shape cells
_PORT_MODULES = {
    "moonlight-16b-a3b": moonlight_16b_a3b,
}

PORT_ARCH_NAMES = tuple(_PORT_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES.get(name) or _PORT_MODULES.get(name)
    if mod is None:
        raise KeyError(f"unknown architecture {name!r}")
    return mod.SMOKE if smoke else mod.CONFIG


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# sub-quadratic sequence mixing (long_500k eligibility)
_SUBQUADRATIC = {"gemma3-4b", "recurrentgemma-2b", "mixtral-8x7b", "rwkv6-3b"}


def cell_status(arch: str, shape_name: str) -> tuple[bool, str]:
    """(runs, reason).  All 40 cells get a verdict; skips are documented."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if shape.kind == "decode" and not cfg.is_decoder:
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k" and arch not in _SUBQUADRATIC:
        return False, "pure full-attention arch; long_500k needs sub-quadratic"
    return True, "runs"


def run_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_NAMES for s in SHAPES
            if cell_status(a, s)[0]]


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for a in ARCH_NAMES:
        for s in SHAPES:
            ok, why = cell_status(a, s)
            if not ok:
                out.append((a, s, why))
    return out
