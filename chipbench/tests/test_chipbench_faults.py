"""The check fails what it must: the lower-precision control, and a run
whose timed path is broken underneath, with every other part of the run
as it is (only the look for a card is skipped: these run on the CPU at the
configurations' smoke sizes, and on the card at the cells' own sizes).

The smoke limits sit between the readings at that size over seeds 0–3:
the bf16 program's first-layer cache error 0.0027–0.0046 of the
reference's norm and its mean logit gap under 3e-5; the fp8 control's
cache error 0.033–0.049.  The mean KL divergence of the last step's
logits from the reference's: the program's 1.8e-7–3.5e-7 over seeds 0–4
and 2**31 + 3, the control's 1.47e-5 or more.  The cells' limits are the
configuration files'."""
from __future__ import annotations

import json
import time

import pytest
import torch

from chipbench import harness
from chipbench.tests.smoke_root import ROOT, make_root

SMOKE_LIMITS = {"gap_mean": 0.05, "cache_err_first": 0.012, "kl_mean": 3e-6}
SMOKES = ["deepseek-moe-16b.smoke", "rwkv6-3b.smoke"]


def _run(root, workload, seed, *, dev="cpu", seconds=0.3, **kw):
    cell = harness.find_cell(root, workload)
    loop = harness.load_module("loops", cell.traffic["kind"],
                               root / "chipbench")
    return loop.run(cell, seed, seconds, False, torch.device(dev),
                    t_start=time.perf_counter(), root=root, **kw)


def _prefill():
    from repro_torch.launch.steps import prefill
    return prefill


def answer_altered(params, cfg, batch):
    """Every request given the next one's answer, where the logits are
    produced: the rows of the logits rolled by one."""
    logits, caches = _prefill()(params, cfg, batch)
    return logits.roll(1, dims=0), caches


def logits_scaled(params, cfg, batch):
    """A scale on the head, as a wrong temperature or final norm would
    give: the logits times 1.5, every greedy token unchanged."""
    logits, caches = _prefill()(params, cfg, batch)
    return logits * 1.5, caches


def state_unchanged(params, cfg, batch):
    """Every cache returned as it was before the step: zeros."""
    logits, caches = _prefill()(params, cfg, batch)
    return logits, [{j: {n: torch.zeros_like(t) for n, t in c.items()}
                     for j, c in seg.items()} for seg in caches]


@pytest.mark.parametrize("workload", SMOKES)
@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 3])
def test_control_fails_where_the_program_passes(tmp_path, workload, seed):
    root = make_root(tmp_path, SMOKE_LIMITS)
    r = _run(root, workload, seed, control=True)
    assert r.correct, r.checks
    assert any(r.control[k] > lim for k, lim in SMOKE_LIMITS.items()), \
        r.control


@pytest.mark.parametrize("workload", SMOKES)
@pytest.mark.parametrize("fault", [answer_altered, state_unchanged,
                                   logits_scaled])
def test_a_broken_timed_path_is_not_correct(tmp_path, workload, fault):
    root = make_root(tmp_path, SMOKE_LIMITS)
    assert _run(root, workload, 4).correct
    r = _run(root, workload, 4, prefill=fault)
    assert not r.correct, r.checks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_at_the_cells_size(card, workload):
    """On the card, three seeds: the program passes every limit, the
    control fails one."""
    for seed in (101, 102, 2 ** 31 + 103):
        r = _run(ROOT, workload, seed, dev=card, seconds=2, control=True)
        assert r.correct, r.checks
        limits = r.cell.conf["limits"]
        assert any(r.control[k] > lim for k, lim in limits.items()), \
            r.control


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [
    w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_a_scaled_head_fails_at_the_cells_size(card, workload):
    """On the card: the logits times 1.5, every greedy token unchanged,
    fail the cell's limits."""
    r = _run(ROOT, workload, 2 ** 31 + 107, dev=card, seconds=2,
             prefill=logits_scaled)
    assert not r.correct, r.checks
