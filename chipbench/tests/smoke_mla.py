"""A checkout-like directory for the CPU tests of the latent-attention
configuration: ``BENCHMARK.json`` with one cell of moonlight-16b-a3b at the
program's smoke sizes (``moonlight-16b-a3b.smoke``), and a copy of
``chipbench/`` beside it.  Beside ``smoke_root.py``, which it leaves as it
is."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from chipbench.tests.smoke_root import ROOT, SMOKE_TRAFFIC

NAME = "moonlight-16b-a3b"
CELL = f"{NAME}.smoke"
SMOKE_MODEL = {
    "n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
    "d_ff": 192, "vocab_size": 96, "layer_plan": [[["mla"], 3]],
    "n_experts": 8, "experts_per_token": 3, "moe_d_ff": 32,
    "n_shared_experts": 2, "first_dense_layers": 1, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16}


def smoke_conf(limits: dict | None = None) -> dict:
    """The configuration file at the program's smoke sizes (no kernel
    launches expected: on the CPU K3's plain twin runs)."""
    conf = json.loads((ROOT / "chipbench" / "configs"
                       / f"{NAME}.json").read_text())
    conf["model"] = {**conf["model"], **SMOKE_MODEL}
    conf["launches"] = {}
    if limits is not None:
        conf["limits"] = limits
    return conf


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tmp`` laid out as a checkout holding the cell :data:`CELL`."""
    shutil.copytree(ROOT / "chipbench", tmp / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp / "chipbench" / "traffic" / "smoke.json").write_text(
        json.dumps(SMOKE_TRAFFIC))
    f = f"chipbench/configs/{NAME}-smoke.json"
    (tmp / f).write_text(json.dumps(smoke_conf(limits)))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": f"{NAME}-smoke", "source": "-", "file": f,
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": CELL, "config": f"{NAME}-smoke",
                           "traffic": "smoke", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if any(
                w.startswith(NAME) for w in m["workloads"]) else []
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
