"""The benchmark's frozen counts equal the program's own functions today,
at the four cells' shapes; a later change to the program's counters shows
here as a difference, never as a moved yardstick."""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from chipbench import counts

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {n: json.loads((ROOT / "chipbench" / "configs"
                          / f"{n}.json").read_text())
           for n in ("deepseek-moe-16b", "rwkv6-3b")}
# (B, S) of the cells of each configuration
SHAPES = {"deepseek-moe-16b": [(4, 2048), (16, 512)],
          "rwkv6-3b": [(4, 2048), (1, 8192)]}


def test_peaks_are_the_programs():
    from repro_torch.launch import hlo_analysis
    assert counts.PEAK_FLOPS == hlo_analysis.PEAK_FLOPS
    assert counts.HBM_BW == hlo_analysis.HBM_BW


@pytest.mark.parametrize("B,S", SHAPES["deepseek-moe-16b"])
def test_attention_counts_are_the_programs(B, S):
    from repro_torch.kernels import flash_attention as fa
    m = CONFIGS["deepseek-moe-16b"]["model"]
    H, K = m["n_heads"], m["n_kv_heads"]
    hd = m["d_model"] // H
    assert counts.attention_flops(B, S, S, H, hd, causal=True, window=0) \
        == fa.attention_flops(B, S, S, H, hd, causal=True, window=0)
    q = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(B, S, K, hd, dtype=torch.bfloat16, device="meta")
    assert counts.attention_bytes(B, S, S, H, K, hd, 2) \
        == fa.attention_bytes(q, kv, kv)


@pytest.mark.parametrize("B,S", SHAPES["rwkv6-3b"])
def test_scan_counts_are_the_programs(B, S):
    from repro_torch.kernels import rwkv6_scan as rw
    m = CONFIGS["rwkv6-3b"]["model"]
    hd = m["rwkv_head_dim"]
    H = m["d_model"] // hd
    r = torch.empty(B, S, H, hd, dtype=torch.float32, device="meta")
    assert counts.scan_bytes(B, S, H, hd) == rw.scan_bytes(r)
    assert counts.scan_flops(B, S, H, hd) == rw.scan_flops(r)


def _product_weights_per_token(name: str) -> float:
    """Weights a token multiplies by, from the program's structure tree:
    every matrix but the embedding table (a lookup) and RWKV-6's bonus and
    mix bases (elementwise), a MoE stack's routed experts at
    experts_per_token / n_experts."""
    from chipbench.loops.closed_prefill import port_config
    from chipbench.weights import leaves
    from repro_torch.models import model_struct
    cfg = port_config(CONFIGS[name])
    total = 0.0
    for path, leaf in leaves(model_struct(cfg)):
        stacked = path[0] == "segments"
        shape = leaf.shape[1:] if stacked else leaf.shape
        if len(shape) < 2 or path[-1] in ("tok", "bonus", "mu_base"):
            continue
        n = math.prod(leaf.shape)
        if path[-2] == "ffn" and path[-1] in ("w_gate", "w_up", "w_down") \
                and len(shape) == 3:
            n = n * cfg.experts_per_token / cfg.n_experts
        total += n
    return total


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_flops_are_twice_the_weights_a_token_uses(name):
    m = CONFIGS[name]["model"]
    assert counts.product_flops_per_token(m) \
        == 2 * _product_weights_per_token(name)


def test_model_flops_of_the_cells():
    """deepseek-moe-16b: 5.47 GFLOP a token at 2048, twice its 2.62e9
    weights a token and the causal scores (4.48e13 a step of 4 x 2048);
    rwkv6-3b's recurrence costs the same at 1 x 8192 as at 4 x 2048."""
    ds = CONFIGS["deepseek-moe-16b"]["model"]
    assert counts.model_flops(ds, 4, 2048) == pytest.approx(4.48e13,
                                                            rel=2e-3)
    rw = CONFIGS["rwkv6-3b"]["model"]
    assert counts.model_flops(rw, 1, 8192) == counts.model_flops(rw, 4, 2048)
