"""Latent attention (``models/mla.py``), the sigmoid router
(``models/moe.py::route``) and K3's plain twin at q/k and v head dims that
differ, on the CPU at smoke size: Moonlight-16B-A3B's prefill (logits and
its latent caches) and its prefill-then-decode through the latent cache,
each against the benchmark's plain f32 reference
(``chipbench/reference/mla.py``), on weights drawn as the benchmark draws
them (its norm scales and correction bias moved off their defaults).  No
JAX: the JAX package has no latent attention.

Tolerances.  Program and reference both compute in f32 and part only by
the order of their sums: 2e-7 of the largest logit after three layers,
and 1e-7 in the caches.  Rounding to bf16 (2^-8 of a value) parts them by
5e-3 and 6e-3, as ``test_bf16_fails_the_logit_tolerance`` shows, so
:data:`LOGIT_TOL` 1e-4 of the largest logit and :data:`CACHE_TOL` 1e-5
(relative Frobenius error of a cache leaf) tell the two apart."""
import dataclasses
import math

import pytest
import torch

from chipbench import check, weights
from chipbench.reference import mla as ref
from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.steps import prefill, prefill_config
from repro_torch.models import (Transformer, cache_struct, decode_step,
                                init_params, model_struct)
from repro_torch.models import moe as tmoe
from repro_torch.models.base import Params, tree_map
from repro_torch.models.mla import mla

ARCH = "moonlight-16b-a3b"
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
DRAW = {"scale": [0.5, 1.5], "e_bias": [-0.05, 0.05]}


def _setup(seed: int, **knobs):
    cfg = get_config(ARCH, smoke=True).replace(**knobs)
    tree = weights.draw(model_struct(cfg), DRAW,
                        torch.Generator().manual_seed(seed), torch.float32,
                        "cpu")
    return cfg, tree, Transformer(cfg, tree)


def _tokens(cfg, B: int, S: int, seed: int):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _reference(tree, cfg, tokens):
    return ref.forward(tree, {"model": dataclasses.asdict(cfg)}, tokens)


def _rel(got, want) -> float:
    """The widest difference over the largest |want|."""
    return float((got.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("attn_impl", ["reference", "flash", "chunked"])
def test_prefill_logits_and_latent_caches_match_the_reference(attn_impl):
    cfg, tree, model = _setup(1, attn_impl=attn_impl)
    tokens = _tokens(cfg, 2, 40, seed=2)
    logits, caches = prefill(model, cfg, {"tokens": tokens})
    want, want_caches = _reference(tree, cfg, tokens)
    assert logits.shape == want.shape == (2, 40, cfg.vocab_size)
    assert _rel(logits, want) < LOGIT_TOL
    for n in range(2):
        got = check._layer_caches(caches, n)
        assert len(got) == cfg.n_layers
        assert all(set(c) == {"c_kv", "k_pe"} for c in got)
        assert max(check.cache_errs(got, want_caches, n)) < CACHE_TOL


def test_bf16_fails_the_logit_tolerance():
    """The same prefill on the same weights rounded to bf16, scores in
    bf16 (the benchmark's precision): far outside :data:`LOGIT_TOL`."""
    cfg, tree, _ = _setup(1, attn_impl="flash")
    tokens = _tokens(cfg, 2, 40, seed=2)
    low = Transformer(cfg, tree_map(lambda t: t.to(torch.bfloat16), tree))
    logits, _ = prefill(low, cfg.replace(attn_dtype="bf16"),
                        {"tokens": tokens})
    want, _ = _reference(tree, cfg, tokens)
    assert _rel(logits, want) > 10 * LOGIT_TOL


def test_prefill_then_decode_through_the_latent_cache_matches_the_reference():
    """Prefill 20 positions, then decode 6 through the latent cache, each
    step's logits against the reference's full forward pass at that
    position.  The capacity is raised so that no slot drops: decode routes
    the batch as one group, the reference each sequence."""
    cfg, tree, model = _setup(3, attn_impl="flash", capacity_factor=16.0)
    B, P, N = 2, 20, 6
    tokens = _tokens(cfg, B, P + N, seed=4)
    want, _ = _reference(tree, cfg, tokens)
    _, pre = prefill(model, cfg, {"tokens": tokens[:, :P]})
    caches = init_params(cache_struct(cfg, B, P + N), None, device="cpu")
    for seg, got in zip(caches, pre, strict=True):
        for j, leaves in seg.items():
            for name, t in leaves.items():
                t[:, :, :P] = got[j][name]
    with torch.inference_mode():
        for pos in range(P, P + N):
            logits, caches = decode_step(model, cfg, caches,
                                         tokens[:, pos:pos + 1], pos)
            assert _rel(logits[:, 0], want[:, pos]) < LOGIT_TOL, pos


@pytest.mark.parametrize("hd,hdv,H,K,Sq,off,bq,bk", [
    (192, 128, 4, 4, 70, 0, 64, 64),     # Moonlight's head dims
    (24, 16, 4, 2, 33, 0, 16, 8),        # GQA, ragged tiles
    (24, 16, 4, 4, 20, 13, 16, 16),      # query rows at an offset
])
def test_k3_plain_twin_at_split_head_dims(hd, hdv, H, K, Sq, off, bq, bk):
    """The plain twin's online softmax over the kernel's tiles against a
    dense causal softmax, v and o at their own head dim; f32 throughout,
    so only the order of the sums parts them (1e-5)."""
    g = torch.Generator().manual_seed(hd + hdv + off)
    B, Sk = 2, Sq + off
    q = torch.randn(B, Sq, H, hd, generator=g)
    k = torch.randn(B, Sk, K, hd, generator=g)
    v = torch.randn(B, Sk, K, hdv, generator=g)
    got = fa.flash_attention_plain(q, k, v, causal=True, window=0, bq=bq,
                                   bk=bk, q_offset=off)
    kh = k.repeat_interleave(H // K, dim=2)
    vh = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhe,bkhe->bhqk", q, kh) / math.sqrt(hd)
    qi = off + torch.arange(Sq)[:, None]
    s = s.masked_fill(qi < torch.arange(Sk)[None, :], float("-inf"))
    want = torch.einsum("bhqk,bkhe->bqhe", torch.softmax(s, -1), vh)
    assert got.shape == (B, Sq, H, hdv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k3_builds_split_head_dims_in_bf16_only():
    assert fa._instance(torch.bfloat16, 192, 128) == (True, 64, 64)
    assert fa._instance(torch.float32, 192, 128) is None
    assert fa._instance(torch.bfloat16, 128, 192) is None
    assert fa._instance(torch.bfloat16, 128) == fa._instance(
        torch.bfloat16, 128, 128) == (True, 64, 64)
    assert fa.tiles(8192, 8192, 192, dtype=torch.bfloat16, hdv=128) \
        == (64, 64)
    # q, a 2-stage k ring at 192 and a 2-stage v ring at 128: 104 KB
    assert fa._smem_bytes(True, 192, 64, 128) == (64 * 192 + 2 * 64 * 320) * 2
    assert fa._smem_bytes(True, 128, 64, 128) == (64 + 4 * 64) * 128 * 2


def _router(seed: int):
    cfg = prefill_config(ARCH, smoke=True)
    g = torch.Generator().manual_seed(seed)
    params = Params(init_params(tmoe.moe_struct(cfg), g, device="cpu"))
    x = torch.randn(2, 30, cfg.d_model, generator=g)
    return cfg, params, x


def test_sigmoid_router_bias_chooses_and_never_weights():
    cfg, params, x = _router(5)
    k, E = cfg.experts_per_token, cfg.n_experts
    scores0, gates0, eidx0 = tmoe.route(params, x, cfg)
    bias = torch.zeros(E)
    bias[E - 1] = 1.0                    # past any score gap: always chosen
    params.e_bias.copy_(bias)
    scores, gates, eidx = tmoe.route(params, x, cfg)
    want_scores = torch.sigmoid(x.float() @ params.router.float())
    assert torch.equal(scores, scores0) and torch.equal(scores, want_scores)
    assert (eidx == E - 1).any(-1).all() and not torch.equal(eidx, eidx0)
    top = want_scores.gather(-1, eidx)
    torch.testing.assert_close(gates, top / top.sum(-1, keepdim=True)
                               * cfg.routed_scale, rtol=1e-6, atol=0)
    for g in (gates, gates0):
        torch.testing.assert_close(g.sum(-1),
                                   torch.full(g.shape[:-1], 2.446),
                                   rtol=1e-6, atol=0)
    assert eidx.shape == (2, 30, k)


def test_sigmoid_router_breaks_ties_by_the_lower_index():
    cfg, params, x = _router(6)
    params.router.zero_()                # every score 0.5
    _, gates, eidx = tmoe.route(params, x, cfg)
    assert eidx.tolist() == [[[0, 1, 2]] * 30] * 2
    bias = torch.zeros(cfg.n_experts)
    bias[5] = bias[6] = 0.1
    params.e_bias.copy_(bias)
    _, gates, eidx = tmoe.route(params, x, cfg)
    assert eidx.tolist() == [[[5, 6, 0]] * 30] * 2
    torch.testing.assert_close(gates, torch.full((2, 30, 3), 2.446 / 3))


def test_router_and_mla_refuse_what_is_not_ported():
    cfg, tree, model = _setup(7)
    for groups in ({"n_group": 4}, {"topk_group": 2}):
        with pytest.raises(ValueError, match="one expert group"):
            ref.forward(tree, {"model": dataclasses.asdict(cfg), **groups},
                        _tokens(cfg, 1, 4, 7))
    with pytest.raises(ValueError, match="router_score"):
        get_config(ARCH, smoke=True).replace(router_score="x").validate()
    with pytest.raises(ValueError, match="kv_lora_rank"):
        get_config(ARCH, smoke=True).replace(kv_lora_rank=0).validate()
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="mesh"):
        mla(getattr(model.segments[0][0], "0").mla, x, cfg=cfg,
            positions=torch.arange(4), lay=object())
    # the softmax router has no correction bias
    assert "e_bias" not in tmoe.moe_struct(get_config("deepseek-moe-16b"))


def test_latent_cache_holds_576_numbers_a_token_a_layer():
    """At the published widths, from ``cache_struct`` on the meta device:
    c_kv (512) and k_pe (64), where multi-head attention over the expanded
    heads would keep 16 x (192 + 128) = 5,120."""
    cfg = get_config(ARCH)
    S = 8192
    caches = init_params(cache_struct(cfg, 1, S), None,
                         dtype=torch.bfloat16, device="meta")
    leaves = [t for seg in caches for pos in seg.values()
              for t in pos.values()]
    assert {n for seg in caches for pos in seg.values() for n in pos} \
        == {"c_kv", "k_pe"}
    assert sum(t.numel() for t in leaves) == cfg.n_layers * S * 576
    assert cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
                          + cfg.v_head_dim) == 5120


def test_chip_smoke_latent_case_and_layerwise_hold():
    """What ``chip_smoke.py`` hands K3's (192, 128) build and how it holds
    the moonlight prefill, at smoke size on the CPU: v is a view of the
    expansion whose strides the tensor-core kernel takes, the inputs are
    about N(0, 1), and the layer-by-layer hold walks latent-attention
    layers (f32: the two attention paths part by sums' order only)."""
    import chip_smoke
    from repro_torch.models import layers
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import transformer

    full = get_config(ARCH)
    q, k, v = chip_smoke.latent_qkv(full, 64, torch.Generator().manual_seed(0),
                                    "cpu", Params, mla_mod._expand)
    assert (q.shape[3], k.shape[3], v.shape[3]) == (192, 192, 128)
    assert not v.is_contiguous() and v.stride(3) == 1
    assert all(s % 8 == 0 for s in v.stride()[:3])
    for t in (q, k, v):
        assert 0.9 < float(t.float().std()) < 1.1
    cfg, _, model = _setup(5, attn_impl="flash")
    h = chip_smoke.layerwise_hold(
        model, cfg, cfg.replace(attn_impl="reference"),
        {"tokens": _tokens(cfg, 1, 32, 5)}, L=layers, tm=transformer,
        moe_mod=tmoe)
    assert len(h["attn_rel"]) == cfg.n_layers
    assert max(h["attn_rel"]) < 1e-5
    assert set(h["flips"]) == set(range(cfg.first_dense_layers,
                                        cfg.n_layers))


MLA_SPANS = {"mla", "mla.q", "mla.kv", "mla.attend", "mla.out"}


@pytest.mark.parametrize("arch", [ARCH, "deepseek-moe-16b", "rwkv6-3b"])
def test_mla_spans_open_only_in_latent_attention(arch):
    cfg = prefill_config(arch, smoke=True, attn_impl="flash")
    tree = init_params(model_struct(cfg), torch.Generator().manual_seed(8),
                       device="cpu")
    with tracing.recording() as rec:
        prefill(Transformer(cfg, tree), cfg,
                {"tokens": _tokens(cfg, 2, 16, seed=9)})
    names = [s.name for s in rec.spans]
    if arch != ARCH:
        assert not set(names) & MLA_SPANS
        return
    assert set(names) >= MLA_SPANS and "attention" not in names
    assert names.count("mla") == cfg.n_layers
    for s in rec.spans:
        if s.name in MLA_SPANS - {"mla"}:
            assert rec.spans[s.parent].name == "mla"
        elif s.name == "mla":
            assert rec.spans[s.parent].name == "prefill"


def test_bias_moved_counts_the_slots_the_bias_changed():
    cfg, params, x = _router(10)
    k = cfg.experts_per_token
    with tracing.recording(spans=False, counters=True) as rec:
        tmoe.route(params, x, cfg)
    assert rec.counters == {"moe.bias_moved": 0}         # a zero bias
    params.e_bias.copy_(torch.linspace(-0.05, 0.05, cfg.n_experts))
    with tracing.recording(spans=True, counters=False) as rec:
        tmoe.route(params, x, cfg)
    assert rec.counters == {}                            # counting off
    with tracing.recording(spans=False, counters=True) as rec:
        _, _, eidx = tmoe.route(params, x, cfg)
    scores = torch.sigmoid(x.float() @ params.router.float())
    plain = torch.sort(scores, dim=-1, descending=True,
                       stable=True)[1][..., :k]
    moved = sum(k - len(set(a.tolist()) & set(b.tolist()))
                for a, b in zip(eidx.reshape(-1, k), plain.reshape(-1, k)))
    assert rec.counters == {"moe.bias_moved": moved} and moved > 0
