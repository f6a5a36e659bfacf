"""The port's mixture-of-experts layer and its two models (mixtral-8x7b,
deepseek-moe-16b) against the JAX package at smoke size: routing, drops
and dispatch order identical; the layer's output, its load-balance loss,
the models' forward logits and decode steps within 2e-4 in f32; the serve
loop's tokens equal; configs and parameter counts equal; a layer's
operators do not grow with its routing groups.

The weights are drawn by the JAX package and handed over as numpy arrays
(``params_from_jax``); inputs come from numpy with a fixed seed.  The
tolerance 2e-4 is that of the JAX package's own flash-vs-reference model
test (``tests/test_kernels.py``).  The machine with the card has no JAX:
there this module skips as a whole."""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import serve as jserve
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models.base import Params
from repro_torch.models.convert import params_from_jax, tensors_from_jax
from tests.test_torch_tracing import Ops

TOL = 2e-4
ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **kw):
    return (jconfigs.get_config(arch, smoke=True).replace(**kw),
            tconfigs.get_config(arch, smoke=True).replace(**kw))


def _moe_layer(arch, seed, **kw):
    """One MoE layer's params (JAX's draw) in both packages, and an input."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jmodels.init_params(jmoe.moe_struct(jcfg), jax.random.PRNGKey(seed))
    tp = Params(tensors_from_jax(_np_tree(jp), device="cpu"))
    return jcfg, tcfg, jp, tp


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d)).astype(np.float32)


def _jax_dispatch(jp, x, cfg):
    """The JAX layer's routing and dispatch, as ``repro.models.moe.moe``
    computes them: (eidx, dest, src_token, slot_gate) per group."""
    B, S, d = x.shape
    xg = x if S > 1 else x.reshape(1, B, d)
    C = jmoe._capacity(xg.shape[1], cfg)
    logits = (xg @ jp["router"]).astype(jnp.float32)
    gates, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                cfg.experts_per_token)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    _, dest, src, sgate = jax.vmap(lambda xt, g, e: jmoe._dispatch_group(
        xt, g, e, C, cfg.n_experts, cfg.experts_per_token))(xg, gates, eidx)
    return C, *(np.asarray(a) for a in (eidx, dest, src, sgate))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["default", "drops"])
@pytest.mark.parametrize("shape", [(2, 16), (6, 1), (16, 8)],
                         ids=["grouped", "decode", "many-groups"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routes_drops_and_combines_as_jax(arch, shape, capacity_factor):
    jcfg, tcfg, jp, tp = _moe_layer(arch, 0, capacity_factor=capacity_factor)
    B, S = shape
    x = _x(B, S, jcfg.d_model, seed=1)
    C, eidx, dest, src, sgate = _jax_dispatch(jp, jnp.asarray(x), jcfg)

    xt = torch.from_numpy(x)
    _, slots, gates_all, t_eidx, t_C = tmoe.dispatch(tp, xt, tcfg)
    assert t_C == C
    np.testing.assert_array_equal(t_eidx.numpy(), eidx)
    # one pass over every group: the JAX package's vmapped group function,
    # slot for slot
    E, k = tcfg.n_experts, tcfg.experts_per_token
    G = dest.shape[0]
    np.testing.assert_array_equal(slots.dest.numpy(), dest)
    np.testing.assert_array_equal(slots.src_token.numpy(), src)
    np.testing.assert_array_equal(slots.dest.numpy() < E * C,
                                  dest < E * C)             # kept mask
    np.testing.assert_allclose(slots.slot_gate.numpy(), sgate, rtol=TOL,
                               atol=TOL)
    # each token's slots in the order a stable sort by token gives them
    np.testing.assert_array_equal(slots.by_token.numpy(),
                                  _by_token(src, k).reshape(G, -1, k))
    dropped = int((dest == E * C).sum())
    if capacity_factor < 1:
        assert dropped > 0, "the small capacity factor must force drops"

    want, want_aux = jmoe.moe(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe(tp, xt, tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=TOL,
                               atol=TOL)
    # groups are sequences, or the whole batch in decode
    assert gates_all.shape == ((B, S, E) if S > 1 else (1, B, E))


def _by_token(src, k):
    """Each group's slot positions by token: a stable argsort of its
    source tokens, [G, T*k]."""
    return np.stack([np.argsort(s, kind="stable") for s in src]) \
        .reshape(len(src), -1)


@pytest.mark.parametrize("arch", ARCHS)
def test_combine_adds_in_the_reference_order(arch):
    # every group's combine at once, each token's slots summed in sorted
    # order: bit for bit the JAX package's scatter-add a group, drops
    # included
    jcfg, tcfg, jp, _ = _moe_layer(arch, 0, capacity_factor=0.5)
    G, T, k = 2, 16, jcfg.experts_per_token
    x = _x(G, T, jcfg.d_model, seed=4)
    C, _, dest, src, sgate = _jax_dispatch(jp, jnp.asarray(x), jcfg)
    assert (dest == jcfg.n_experts * C).any()
    ex = np.random.default_rng(5).standard_normal(
        (G, jcfg.n_experts * C, jcfg.d_model)).astype(np.float32)
    slots = tmoe.Slots(*(torch.from_numpy(a.copy()).long()
                         for a in (dest, src)),
                       torch.from_numpy(sgate.copy()),
                       torch.from_numpy(_by_token(src, k)).view(G, T, k))
    got = tmoe._combine(torch.from_numpy(ex), slots)
    assert got.shape == (G, T, jcfg.d_model)
    for g in range(G):
        want = jmoe._combine_group(jnp.asarray(ex[g]), dest[g], src[g],
                                   sgate[g], T)
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_groups_add_no_operation(arch):
    """One ``moe`` call dispatches the same operators at 2 groups as at 8
    of the same length: no work is done a group, so a device launches no
    more a group."""
    _, tcfg, _, tp = _moe_layer(arch, 0, capacity_factor=0.5)
    counts = []
    for G in (2, 8):
        x = torch.from_numpy(_x(G, 16, tcfg.d_model, seed=G))
        with Ops() as m:
            tmoe.moe(tp, x, tcfg)
        counts.append(Counter(m.ops))
    assert counts[0] == counts[1]
    assert counts[0]["aten.sort.stable"] == 2       # the router's, the slots'


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    eidx = rng.integers(0, 8, size=(40, 2)).astype(np.int32)
    want = jmoe.load_balance_loss(jnp.asarray(gates), jnp.asarray(eidx), 8)
    got = tmoe.load_balance_loss(torch.from_numpy(gates),
                                 torch.from_numpy(eidx).long(), 8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_top_k_breaks_ties_as_jax():
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.0],
                  [0.1, 0.1, 0.1, 0.1, 0.6]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 3)
    got_v, got_i = tmoe._top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _model(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jparams = jmodels.init_params(jmodels.model_struct(jcfg),
                                  jax.random.PRNGKey(seed))
    return jcfg, jparams, tcfg, params_from_jax(_np_tree(jparams), tcfg,
                                                device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, attn_impl):
    jcfg, jparams, tcfg, model = _model(arch, attn_impl=attn_impl)
    toks = _tokens(jcfg, 2, 24)
    want, want_aux, _ = jmodels.forward(jparams, jcfg,
                                        {"tokens": jnp.asarray(toks)})
    got, aux, _ = tmodels.forward(model, tcfg,
                                  {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the aux loss sums over the MoE layers only: deepseek's first is dense
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=TOL,
                               atol=TOL)
    assert aux.item() > 0


def test_param_trees_carry_the_moe_layout():
    _, jparams, tcfg, model = _model("deepseek-moe-16b")
    segs = jparams["segments"]
    assert len(segs) == len(model.segments) == 2
    assert set(segs[0]["0"]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert set(segs[1]["0"]["ffn"]) == {"router", "w_gate", "w_up",
                                        "w_down", "shared"}
    moe_ffn = model.segments[1][0]._modules["0"].ffn
    assert tuple(moe_ffn.w_gate.shape) == (8, 64, 32)
    np.testing.assert_array_equal(moe_ffn.router.numpy(),
                                  np.asarray(segs[1]["0"]["ffn"]["router"][0]))
    np.testing.assert_array_equal(
        moe_ffn.shared.w_down.numpy(),
        np.asarray(segs[1]["0"]["ffn"]["shared"]["w_down"][0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_and_forward(arch):
    # a capacity factor at which no token drops, in a group of a sequence
    # (forward) or of the batch (decode), so that both compute one function
    E_over_k = {"mixtral-8x7b": 2.0, "deepseek-moe-16b": 8 / 3}[arch]
    jcfg, jparams, tcfg, model = _model(arch, 2,
                                        capacity_factor=E_over_k * 1.01)
    B, max_len, n = 2, 12, 10
    toks = _tokens(jcfg, B, n, seed=2)
    jcaches = [jmodels.init_params(cs, jax.random.PRNGKey(1))
               for cs in jmodels.cache_struct(jcfg, B, max_len)]
    tcaches = tmodels.init_params(tmodels.cache_struct(tcfg, B, max_len),
                                  None, device="cpu")
    full, _, _ = tmodels.forward(model, tcfg,
                                 {"tokens": torch.from_numpy(toks)})
    dec = jax.jit(lambda p, c, t, i: jmodels.decode_step(p, jcfg, c, t, i))
    for i in range(n):
        want, jcaches = dec(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                            jnp.asarray(i, jnp.int32))
        got, tcaches = tmodels.decode_step(
            model, tcfg, tcaches, torch.from_numpy(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")


def test_prefill_caches_match_jax():
    jcfg, jparams, tcfg, model = _model("mixtral-8x7b", 1,
                                        attn_impl="flash")
    toks = _tokens(jcfg, 2, 20, seed=1)
    want, _, want_caches = jmodels.forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks)}, return_cache=True)
    logits, caches = tsteps.prefill(model, tcfg,
                                    {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(caches[0]["0"][name].numpy(),
                                   np.asarray(want_caches[0]["0"][name]),
                                   rtol=TOL, atol=TOL)


def test_serve_emits_jax_tokens():
    kw = dict(smoke=True, batch=2, prompt_len=6, gen_len=6, max_len=32,
              seed=3)
    want = jserve.serve("mixtral-8x7b", **kw)
    cfg = jconfigs.get_config("mixtral-8x7b", smoke=True)
    jparams = jmodels.init_params(jmodels.model_struct(cfg),
                                  jax.random.PRNGKey(3))
    model = params_from_jax(_np_tree(jparams),
                            tconfigs.get_config("mixtral-8x7b", smoke=True),
                            device="cpu")
    got = tserve.serve("mixtral-8x7b", params=model, device="cpu", **kw)
    assert got["steps"] == want["steps"]
    np.testing.assert_array_equal(got["generated"], want["generated"])


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_equal_jax(arch, smoke):
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    tcfg = tconfigs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tmodels.param_count(tmodels.model_struct(tcfg)) \
        == jmodels.param_count(jmodels.model_struct(jcfg))
    full = {"mixtral-8x7b": 46_702_792_704,
            "deepseek-moe-16b": 16_375_728_128}
    if not smoke:
        assert tmodels.param_count(tmodels.model_struct(tcfg)) == full[arch]


def test_moe_layers_build_as_jax():
    # the dense config with MoE switched on, which raised before MoE was
    # ported: its structure is the JAX package's, leaf for leaf
    kw = dict(family="moe", n_experts=4, experts_per_token=2)
    jcfg = jconfigs.get_config("llama3.2-1b", smoke=True).replace(**kw)
    tcfg = tconfigs.get_config("llama3.2-1b", smoke=True).replace(**kw)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jmodels.model_struct(jcfg),
        is_leaf=lambda p: isinstance(p, jmodels.P))
    tstruct = tmodels.model_struct(tcfg)
    for path, leaf in jleaves:
        node = tstruct
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        assert (node.shape, node.axes, node.init, node.scale) \
            == (leaf.shape, leaf.axes, leaf.init, leaf.scale), path
    assert set(tstruct["segments"][0]["0"]["ffn"]) == {
        "router", "w_gate", "w_up", "w_down"}
