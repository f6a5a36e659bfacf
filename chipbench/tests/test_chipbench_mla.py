"""The latent-attention configuration through the harness on the CPU: a
smoke cell of moonlight-16b-a3b run by ``harness.execute``, judged by the
plain reference ``chipbench/reference/mla.py``, its traced line with the
metrics that a CPU run can read; the reference against the program at the
configuration's smoke sizes; and the fp8 control failing the limits.

Tolerance 2e-4 of the largest logit and of each cache leaf's largest entry,
as ``test_chipbench_reference.py`` sets it: both sides compute in f32 and
part only by the order of their sums (2e-7 here); a wrong rotation, norm,
gate or bias moves them by 1e-2 or more."""
from __future__ import annotations

import json
import time

import torch

from chipbench import harness, weights
from chipbench.loops.closed_prefill import port_config
from chipbench.reference import mla as ref
from chipbench.reference.common import FP8
from chipbench.tests.smoke_mla import CELL, make_root, smoke_conf

RTOL = 2e-4


def _run(root, trace):
    return harness.execute(CELL, 2 ** 31 + 23, 0.2, trace, root=root,
                           t_start=time.perf_counter(), device="cpu")


def test_smoke_cell_runs_and_is_correct(tmp_path):
    # the weights are drawn in the configuration's bf16 here too: the
    # limits of test_chipbench_harness.py, wide enough for bf16 on the CPU
    root = make_root(tmp_path, {"gap_mean": 10.0, "cache_err_first": 1.0})
    run, line = _run(root, False)
    out = json.loads(line)
    assert out["correct"] is True, out["checks"]
    # (prefill_p90_ms needs two steps in the window, which a loaded host
    # may not fit in 0.2 s)
    assert {"prefill_tok_s", "setup_s"} <= set(out["metrics"])
    run, line = _run(root, True)
    out = json.loads(line)
    assert out["correct"] is True
    got = out["metrics"]
    # the host-clock readings; the device-trace ones need a card
    assert {"mla_mfu_pct", "moe_bias_moved_pct", "moe_drop_pct"} <= set(got)
    assert 0 < got["moe_bias_moved_pct"]["value"] < 100
    assert not {"k3_mla_roofline", "mla_time_pct"} & set(got)


def test_reference_matches_the_program():
    from repro_torch.launch.steps import prefill
    from repro_torch.models import Transformer, model_struct
    conf = smoke_conf()
    cfg = port_config(conf).replace(attn_dtype="f32")
    gen = torch.Generator().manual_seed(11)
    tree = weights.draw(model_struct(cfg), conf["draw"], gen, torch.float32,
                        "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen,
                           dtype=torch.int32)
    logits, caches = prefill(Transformer(cfg, tree), cfg, {"tokens": tokens})
    want, want_caches = ref.forward(tree, conf, tokens)
    scale = want.abs().max()
    assert (logits - want).abs().max() <= RTOL * scale
    layer = 0
    for seg in caches:
        for r in range(next(iter(seg["0"].values())).shape[0]):
            for name, t in seg["0"].items():
                w = want_caches[layer][name]
                assert (t[r] - w).abs().max() <= RTOL * w.abs().max()
            layer += 1
    assert layer == cfg.n_layers
    # the fp8 control sits far outside the same tolerance
    low, _ = ref.forward(tree, conf, tokens, FP8)
    assert (low - want).abs().max() > 10 * RTOL * scale
