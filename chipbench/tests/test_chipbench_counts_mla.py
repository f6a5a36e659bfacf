"""``chipbench/counts_mla.py`` frozen at the cell
``moonlight-16b-a3b.prefill-1x8192``: K3 at q/k 192 and v 128 over 8,192
causal positions and 16 heads, and the step's model FLOPs at the
configuration's published sizes (343.6 GFLOP of attention a layer, 6.1
TFLOP of MLA projections and 51.5 TFLOP a step)."""
from __future__ import annotations

import json
from pathlib import Path

from chipbench import counts, counts_mla

ROOT = Path(__file__).resolve().parents[2]
CONF = json.loads((ROOT / "chipbench" / "configs"
                   / "moonlight-16b-a3b.json").read_text())
M = CONF["model"]


def test_attention_counts_at_the_cell():
    assert counts_mla.live_pairs(8192) == 33_558_528
    assert counts_mla.attention_flops(1, 8192, 16, 192, 128) \
        == 343_639_326_720
    assert counts_mla.attention_bytes(1, 8192, 16, 192, 128, 2) \
        == 167_772_160
    # equal head dims give the multi-head count (4 hd a pair)
    assert counts_mla.attention_flops(1, 8192, 16, 128, 128) \
        == counts.attention_flops(1, 8192, 8192, 16, 128, causal=True,
                                  window=0)
    least = counts.roofline_s(343_639_326_720, 167_772_160)
    assert least == 343_639_326_720 / counts.PEAK_FLOPS   # bound by FLOPs


def test_model_flops_at_the_cell():
    assert counts_mla.mla_product_flops_per_token(M) == 27_525_120
    assert 27 * 8192 * counts_mla.mla_product_flops_per_token(M) \
        == 6_088_116_142_080
    assert counts_mla.model_flops(M, 1, 8192) == 51_534_297_563_136
