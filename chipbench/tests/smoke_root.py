"""A checkout-like directory for the CPU tests: ``BENCHMARK.json`` with
cells of the two configurations at the program's smoke sizes, and a copy of
``chipbench/`` beside it."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SMOKE_MODEL = {
    "deepseek-moe-16b": {
        "n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "d_ff": 192, "vocab_size": 96, "layer_plan": [[["global"], 3]],
        "n_experts": 8, "experts_per_token": 3, "moe_d_ff": 32,
        "n_shared_experts": 2, "first_dense_layers": 1},
    "rwkv6-3b": {
        "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "d_ff": 128, "vocab_size": 96, "layer_plan": [[["rwkv"], 2]],
        "rwkv_head_dim": 16},
}
SMOKE_TRAFFIC = {"kind": "closed_prefill", "batch": 2, "seq": 32, "pool": 4,
                 "warmup_steps": 1, "check_requests": 2, "trace_steps": 2}


def smoke_conf(name: str, limits: dict | None = None) -> dict:
    """The configuration file ``name`` at the program's smoke sizes (no
    kernel launches expected: on the CPU the kernels' plain twins run)."""
    conf = json.loads((ROOT / "chipbench" / "configs"
                       / f"{name}.json").read_text())
    conf["model"] = {**conf["model"], **SMOKE_MODEL[name]}
    conf["launches"] = {}
    if limits is not None:
        conf["limits"] = limits
    return conf


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """``tmp`` laid out as a checkout holding the smoke cells
    ``<config>.smoke``."""
    shutil.copytree(ROOT / "chipbench", tmp / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "chipbench" / "traffic" / "smoke.json").write_text(
        json.dumps(SMOKE_TRAFFIC))
    bench["configs"] = []
    bench["workloads"] = []
    for name in SMOKE_MODEL:
        f = f"chipbench/configs/{name}-smoke.json"
        (tmp / f).write_text(json.dumps(smoke_conf(name, limits)))
        bench["configs"].append({"name": f"{name}-smoke", "source": "-",
                                 "file": f, "reduced": [], "why": "tests"})
        bench["workloads"].append({"name": f"{name}.smoke",
                                   "config": f"{name}-smoke",
                                   "traffic": "smoke", "chips": 1,
                                   "why": "tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
