"""The port's tracing (``repro_torch.tracing``) on the CPU: off, a span is
one shared no-op and a count does nothing, so a prefill dispatches the same
operations as without them; on, the smoke prefills' spans nest per call
as the layers do, land in a profiler's trace as ``user_annotation``
ranges, and leave logits and caches bit-equal; the MoE counters equal a
direct count of the dispatch's slots and drops."""
import re
import sys
import threading
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.launch.steps import prefill, prefill_config
from repro_torch.models import Transformer, forward, init_params, model_struct
from repro_torch.models import moe as tmoe
from repro_torch.models.base import Params
from repro_torch.models.transformer import _segments

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
MOE, RWKV = "deepseek-moe-16b", "rwkv6-3b"
# a layer's spans under ``prefill``, by arch; MoE's under ``moe``
TOP = {MOE: {"embed", "attention", "mlp", "moe", "cache_stack", "head"},
       RWKV: {"embed", "time_mix", "channel_mix", "cache_stack", "head"}}
MOE_PARTS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine",
             "moe.shared"}
# what counters on add to a prefill: a MoE layer's count of its drops
COUNT_OPS = ("aten.eq.Scalar", "aten.sum.default", "aten.add_.Tensor")


class Ops(TorchDispatchMode):
    """Every operator dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = prefill_config(arch, smoke=True)
        gen = torch.Generator().manual_seed(7)
        tree = init_params(model_struct(cfg), gen, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                             dtype=torch.int32)
        _MODELS[arch] = cfg, Transformer(cfg, tree), {"tokens": toks}
    return _MODELS[arch]


def _n_moe_layers(cfg):
    return sum(1 for s in _segments(cfg) if s["moe"]
               for _ in range(s["repeat"]))


def test_off_span_is_one_shared_noop_and_count_does_nothing():
    assert tracing.span("prefill") is tracing.span("moe") is tracing._NULL
    assert not tracing.counting()
    t = torch.ones((), dtype=torch.int64)
    with Ops() as m:
        with tracing.span("moe"):
            tracing.count("moe.slots", 3)
            tracing.count("moe.dropped", t)
    assert m.ops == [] and int(t) == 1


@pytest.mark.parametrize("arch", [MOE, RWKV])
def test_spans_add_no_operation_and_counters_only_the_drop_count(arch):
    """Spans on dispatch the operators of tracing off, no more, and no read
    back to the host (``_local_scalar_dense``); counters on add only each
    MoE layer's compare, sum and add into the accumulator."""
    cfg, model, batch = _model(arch)
    with Ops() as off:
        prefill(model, cfg, batch)
    with tracing.recording(), Ops() as on:
        prefill(model, cfg, batch)
    with tracing.recording(counters=True), Ops() as counted:
        prefill(model, cfg, batch)
    assert on.ops == off.ops
    assert not any("_local_scalar_dense" in op for op in off.ops + on.ops
                   + counted.ops)
    n = _n_moe_layers(cfg)
    want = Counter({op: n for op in COUNT_OPS})
    if n:
        want["aten.zeros.default"] = 1          # the accumulator, once
    assert Counter(counted.ops) - Counter(off.ops) == want
    assert not Counter(off.ops) - Counter(counted.ops)


def test_off_profiler_records_no_program_span():
    cfg, model, batch = _model(MOE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(model, cfg, batch)
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names or "aten::matmul" in names
    assert not names & set(tracing.SPANS)


def _check_tree(spans, arch):
    roots = [i for i, s in enumerate(spans) if s.name == "prefill"]
    assert all(spans[i].parent is None and spans[i].call == i for i in roots)
    for i, s in enumerate(spans):
        assert s.name in tracing.SPANS and s.t0_ns <= s.t1_ns
        if s.name == "prefill":
            continue
        p = spans[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
        assert s.call == (s.parent if p.name == "prefill" else p.call)
        assert s.call in roots and s.thread == p.thread
        if s.name in MOE_PARTS:
            assert p.name == "moe"
        else:
            assert p.name == "prefill" and s.name in TOP[arch]
    return roots


@pytest.mark.parametrize("arch", [MOE, RWKV])
def test_spans_nest_by_call_and_layer(arch):
    cfg, model, batch = _model(arch)
    with tracing.recording() as rec:
        prefill(model, cfg, batch)
        prefill(model, cfg, batch)
    assert tracing.span("prefill") is tracing._NULL
    roots = _check_tree(rec.spans, arch)
    assert len(roots) == 2
    for root in roots:
        mine = Counter(s.name for s in rec.spans if s.call == root)
        names = set(mine) - {"prefill"}
        assert names == TOP[arch] | (MOE_PARTS if arch == MOE else set())
        assert mine["cache_stack"] == len(_segments(cfg))
        per_layer = mine["attention"] + mine["time_mix"]
        assert per_layer == cfg.n_layers
        assert mine["moe"] + mine["mlp"] == (cfg.n_layers if arch == MOE
                                             else 0)
        assert mine["moe"] == _n_moe_layers(cfg) == mine["moe.dispatch"]
    with tracing.recording() as rec:
        with torch.inference_mode():
            forward(model, cfg, batch, return_cache=False)
    names = {s.name for s in rec.spans}
    assert "cache_stack" not in names and "head" in names


@pytest.mark.parametrize("arch", [MOE, RWKV])
def test_spans_are_profiler_annotations(arch):
    cfg, model, batch = _model(arch)
    with tracing.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        prefill(model, cfg, batch)
    want = Counter(s.name for s in rec.spans)
    got = Counter(e.name for e in prof.events() if e.name in tracing.SPANS)
    assert got == want


def test_moe_counters_equal_a_direct_count():
    """``moe.slots`` is G*T*k and ``moe.dropped`` the slots whose
    destination is the spare row E*C, which equals a direct count from the
    router's choices on the same inputs: in each group, each expert keeps
    C of the slots routed to it; the capacity is cut so that slots are
    dropped."""
    cfg = prefill_config(MOE, smoke=True).replace(capacity_factor=0.5)
    gen = torch.Generator().manual_seed(3)
    params = Params(init_params(tmoe.moe_struct(cfg), gen, device="cpu"))
    x = torch.randn(3, 20, cfg.d_model, generator=gen)
    with tracing.recording(spans=False, counters=True) as rec:
        _, slots, _, _, C = tmoe.dispatch(params, x, cfg)
    assert tracing.span("moe") is tracing._NULL
    E, k = cfg.n_experts, cfg.experts_per_token
    _, _, eidx = tmoe.route(params, x, cfg)
    dropped = sum(max(0, int((e == j).sum()) - C)
                  for e in eidx for j in range(E))
    assert dropped == int((slots.dest == E * C).sum()) > 0
    assert rec.counters == {"moe.slots": 3 * 20 * k, "moe.dropped": dropped}


@pytest.mark.parametrize("arch", [MOE, RWKV])
def test_tracing_leaves_logits_and_caches_bit_equal(arch):
    cfg, model, batch = _model(arch)
    want = prefill(model, cfg, batch)
    for kw in ({}, {"counters": True}):
        with tracing.recording(**kw):
            got = prefill(model, cfg, batch)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            for j in a:
                for name in a[j]:
                    assert torch.equal(a[j][name], b[j][name]), (j, name)


def test_every_span_the_program_opens_is_named_in_spans():
    opened = set()
    for p in SRC.rglob("*.py"):
        opened |= set(re.findall(r'tracing\.span\("([^"]+)"\)',
                                 p.read_text()))
    assert opened == set(tracing.SPANS)
    counted = set()
    for p in SRC.rglob("*.py"):
        counted |= set(re.findall(r'tracing\.count\("([^"]+)"',
                                  p.read_text()))
    assert counted == set(tracing.COUNTERS)


def test_recording_is_not_reentrant_and_always_turns_off():
    with pytest.raises(ValueError):
        with tracing.recording(counters=True):
            assert tracing.counting()
            with pytest.raises(RuntimeError):
                with tracing.recording():
                    pass
            raise ValueError
    assert tracing.span("moe") is tracing._NULL and not tracing.counting()


def test_threads_keep_their_own_stacks_and_counts():
    """More threads than cores, a short switch interval: every span's
    parent and call are its own thread's, and no count is lost."""
    n_threads, n_iter = 16, 200
    t = torch.ones((), dtype=torch.int64)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording(counters=True) as rec:
            def work():
                for _ in range(n_iter):
                    with tracing.span("prefill"):
                        with tracing.span("moe"):
                            with tracing.span("moe.dispatch"):
                                tracing.count("moe.slots", 1)
                                tracing.count("moe.dropped", t)
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters == {"moe.slots": n_threads * n_iter,
                            "moe.dropped": n_threads * n_iter}
    spans = rec.spans
    assert len(spans) == 3 * n_threads * n_iter
    for i, s in enumerate(spans):
        assert s.t1_ns is not None
        if s.name == "prefill":
            assert s.parent is None and s.call == i
            continue
        p = spans[s.parent]
        assert p.thread == s.thread and s.call == p.call
        assert p.name == {"moe": "prefill", "moe.dispatch": "moe"}[s.name]
