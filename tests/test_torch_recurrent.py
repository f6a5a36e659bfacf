"""The port's recurrent slice against the JAX package on the CPU: the RG-LRU
and RWKV-6 scans (K4, K5) against the Pallas kernels in interpret mode and
their dense oracles; the RG-LRU and RWKV-6 layers; recurrentgemma-2b and
rwkv6-3b at smoke size (configs, parameter counts, forward, prefill caches,
decode step by step, serve tokens).

Inputs and weights come from numpy with a fixed seed, or are drawn by the
JAX package and handed over as numpy arrays.  Tolerances: 1e-5 for K4 and
1e-4 for K5 are those of the JAX package's own kernel tests
(``tests/test_kernels.py``); 2e-4 for layers and models is that of its
flash-vs-reference model test.  bf16 layers are held at 2e-2, the JAX
package's bf16 kernel tolerance: one bf16 rounding step near 1 is 7.8e-3.
The machine with the card has no JAX: there this module skips as a whole."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs
from repro import models as jmodels
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import recurrent as jrec
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import recurrent as trec
from repro_torch.models.base import Params
from repro_torch.models.convert import params_from_jax, tensors_from_jax
from tests.config_parity import assert_config_equal_jax

ARCHS = ("recurrentgemma-2b", "rwkv6-3b")
FULL_PARAM_COUNT = {"recurrentgemma-2b": 2_894_481_920,
                    "rwkv6-3b": 3_167_685_120}
TOL = 2e-4
BF16_TOL = 2e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# K4 and K5 at the op level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,W,bs,bw", [
    (2, 96, 64, 32, 32),       # the JAX kernel test's shape
    (1, 40, 24, 8, 8),
    (2, 100, 72, 32, 32),      # S and W not multiples of the block
])
def test_rglru_scan_matches_jax(B, S, W, bs, bw):
    rng = np.random.default_rng(S + W)
    a = rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    want_kernel = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), bs=bs,
                                  bw=bw, interpret=True)
    want_ref = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = tops.rglru_scan.launches
    outs = {"ops": tops.rglru_scan(ta, tb, seg=bs),
            "plain": trg.rglru_scan_plain(ta, tb, seg=bs),
            "ref": tref.rglru_scan_ref(ta, tb)}
    assert tops.rglru_scan.launches == before        # CPU: plain path only
    for name, out in outs.items():
        assert out.shape == (B, S, W) and out.dtype == torch.float32
        for want in (want_kernel, want_ref):
            _close(out, want, 1e-5, name)


def _rwkv_inputs(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.8, 0.999, (B, S, H, hd)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("B,S,H,hd,bs", [
    (2, 48, 2, 16, 16),        # the JAX kernel test's shape
    (1, 24, 2, 8, 16),         # S not a multiple of bs (the tail test)
    (1, 40, 3, 32, 16),
])
def test_rwkv6_scan_matches_jax(B, S, H, hd, bs):
    ins = _rwkv_inputs(S + hd, B, S, H, hd)
    jins = [jnp.asarray(x) for x in ins]
    want_kernel = jops.rwkv6_scan(*jins, bs=bs, interpret=True)
    want_ref = jref.rwkv6_scan_ref(*jins)
    tins = [torch.from_numpy(x) for x in ins]
    before = tops.rwkv6_scan.launches
    outs = {"ops": tops.rwkv6_scan(*tins, seg=bs),
            "plain": trw.rwkv6_scan_plain(*tins, seg=bs),
            "ref": tref.rwkv6_scan_ref(*tins)}
    assert tops.rwkv6_scan.launches == before
    for name, (out, s_last) in outs.items():
        assert out.shape == (B, S, H, hd)
        assert s_last.shape == (B, H, hd, hd)
        for want, s_want in (want_kernel, want_ref):
            _close(out, want, 1e-4, name)
            _close(s_last, s_want, 1e-4, name + " s_last")


# The twins walk the kernels' split-over-time schedule: aggregate each
# segment, carry in segment order, walk again.  Segment lengths: one step,
# 7 and 16 (S = 50 leaves a short last segment), 10 and 25 (S a multiple),
# S itself and more (one segment).
SEGS = (1, 7, 10, 16, 25, 50, 64)


@pytest.mark.parametrize("seg", SEGS)
def test_rglru_twin_follows_its_schedule(seg):
    B, S, W = 2, 50, 24
    rng = np.random.default_rng(seg)
    a = rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    want_kernel = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), bs=16,
                                  bw=8, interpret=True)
    want_ref = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = trg.rglru_scan_plain(ta, tb, seg=seg)
    assert torch.equal(tops.rglru_scan(ta, tb, seg=seg), got)
    for want in (want_kernel, want_ref):
        _close(got, want, 1e-5, f"seg {seg}")


def _rwkv_decays(kind, rng, shape):
    if kind == "uniform":
        return rng.uniform(0.8, 0.999, shape).astype(np.float32)
    if kind == "near_zero":
        return rng.uniform(0.0, 1e-3, shape).astype(np.float32)
    # the model's decay form, w = exp(-exp(z)), over its whole clip range
    z = rng.uniform(-8.0, 4.0, shape)
    return np.exp(-np.exp(z)).astype(np.float32)


@pytest.mark.parametrize("decay", ["uniform", "near_zero", "exp_exp"])
@pytest.mark.parametrize("seg", SEGS)
def test_rwkv6_twin_follows_its_schedule(seg, decay):
    """Also under decays the chunked form's clip cannot take: w near 0
    (a segment's product of decays underflows) and w = exp(-exp(z)) for z
    up to its clip at 4."""
    B, S, H, hd = 1, 50, 2, 16
    r, k, v, _, u = _rwkv_inputs(seg, B, S, H, hd)
    w = _rwkv_decays(decay, np.random.default_rng(seg + 1), (B, S, H, hd))
    jins = [jnp.asarray(x) for x in (r, k, v, w, u)]
    tins = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    got, s_got = trw.rwkv6_scan_plain(*tins, seg=seg)
    ops_out, ops_s = tops.rwkv6_scan(*tins, seg=seg)
    assert torch.equal(ops_out, got) and torch.equal(ops_s, s_got)
    for want, s_want in (jops.rwkv6_scan(*jins, bs=16, interpret=True),
                         jref.rwkv6_scan_ref(*jins)):
        _close(got, want, 1e-4, f"seg {seg}")
        _close(s_got, s_want, 1e-4, f"seg {seg} s_last")


@pytest.mark.parametrize("S", [1, 9, 40])
def test_scan_twins_with_one_segment_are_the_sequential_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (2, S, 12))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, S, 12)).astype(np.float32))
    h, want = torch.zeros((2, 12)), torch.empty((2, S, 12))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    for seg in (S, S + 5):
        assert torch.equal(trg.rglru_scan_plain(a, b, seg=seg), want)
    tins = [torch.from_numpy(x) for x in _rwkv_inputs(S, 2, S, 3, 8)]
    out, s_last = tref.rwkv6_scan_ref(*tins)
    for seg in (S, S + 5):
        got, s_got = trw.rwkv6_scan_plain(*tins, seg=seg)
        assert torch.equal(got, out) and torch.equal(s_got, s_last)


def test_scan_twins_take_no_empty_segment():
    a = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError, match="seg"):
        trg.rglru_scan_plain(a, a, seg=0)
    r = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="seg"):
        trw.rwkv6_scan_plain(r, r, r, r, torch.zeros((1, 8)), seg=0)


def test_scan_scratch_shapes():
    """The kernels' scratch at the prefill shapes: a ticket and a flag per
    chain, a carry per block boundary."""
    # K4: 4 x 80 chains of 32 channels, 2048 / (8 x 16) = 16 blocks
    assert trg.scratch_shape(4, 2048, 2560, 16) == (1 + 320, 320 * 15 * 32)
    assert trg.scratch_shape(1, 100, 33, 16) == (1 + 2, 0)
    # K5: 160 (b, h) chains of 32 segments of 64; 81 MB of carried states
    assert trw.scratch_shape(4, 2048, 40, 64, 64) == (161, 160 * 31 * 4096)
    assert trw.scratch_shape(1, 0, 2, 16, 4) == (3, 0)
    assert trw.smem_bytes(64, 64) == 4 * (64 * (4 * 68 + 1) + 65)
    assert trw.smem_bytes(64, trw.max_seg(64)) <= 232_448
    assert trw.smem_bytes(64, trw.max_seg(64) + 1) > 232_448


def test_scan_byte_and_flop_counts():
    a = torch.zeros((4, 2048, 2560))
    assert trg.scan_bytes(a) == 12 * 4 * 2048 * 2560
    assert trg.scan_flops(a) == 2 * 4 * 2048 * 2560
    r = torch.zeros((4, 2048, 40, 64))
    n = 4 * 2048 * 40 * 64
    assert trw.scan_bytes(r) == 4 * (5 * n + 40 * 64 + 4 * 40 * 64 * 64)
    assert trw.scan_flops(r) == 5 * n * 64


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_params(struct_fn, cfg, seed):
    """JAX-initialized layer params with every leaf perturbed, so that the
    zero- and one-initialized leaves (bonus, decay, mu, conv_b) take part."""
    tree = _np_tree(jmodels.init_params(struct_fn(cfg),
                                        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)
    return tree, tensors_from_jax(tree, device="cpu")


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)) \
        .astype(np.float32)


def _both(x, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(dtype)


def _state_close(got, want, tol, msg):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for name in want:
        _close(got[name], want[name], tol, f"{msg} {name}")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_rglru_layer_matches_jax(use_kernel, dtype, tol):
    cfg = jconfigs.get_config("recurrentgemma-2b", smoke=True)
    jp, tp = _layer_params(jrec.rglru_struct, cfg, 5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), jp)
    tp = Params({n: t.to(dtype) for n, t in tp.items()})
    jx, tx = _both(_x(5, 2, 24, cfg.d_model), dtype)
    want, wstate = jrec.rglru(jp, jx, cfg=cfg, use_kernel=use_kernel)
    got, gstate = trec.rglru(tp, tx, cfg=cfg, use_kernel=use_kernel)
    assert got.dtype == dtype and gstate["h"].dtype == torch.float32
    _close(got, want, tol, "prefill out")
    _state_close(gstate, wstate, tol, "prefill")
    # one decode step from the returned state
    jx1, tx1 = _both(_x(6, 2, 1, cfg.d_model), dtype)
    want, wstate = jrec.rglru(jp, jx1, cfg=cfg, state=wstate)
    got, gstate = trec.rglru(tp, tx1, cfg=cfg, state=gstate)
    _close(got, want, tol, "decode out")
    _state_close(gstate, wstate, tol, "decode")


def test_rglru_gelu_is_the_tanh_approximation():
    """A probe layer that passes x through: a ~ 0 (no memory), conv = the
    current tap, out = 10 I, so out ~ 10 gelu(2x) * sigmoid(.) * 4x and
    erf gelu (torch's default) would miss JAX's tanh gelu by ~1e-2."""
    cfg = jconfigs.get_config("recurrentgemma-2b", smoke=True)
    d = cfg.d_model
    eye = np.eye(d, dtype=np.float32)
    tree = {"in_x": 2 * eye, "in_y": 4 * eye,
            "conv_w": np.stack([np.zeros(d), np.zeros(d), np.zeros(d),
                                np.ones(d)]).astype(np.float32),
            "conv_b": np.zeros(d, np.float32),
            "gate_a": np.zeros((d, d), np.float32),
            "gate_i": np.zeros((d, d), np.float32),
            "log_lambda": np.full(d, 20.0, np.float32), "out": 10 * eye}
    jx, tx = _both(_x(13, 1, 8, d), torch.float32)
    want, _ = jrec.rglru({n: jnp.asarray(a) for n, a in tree.items()}, jx,
                         cfg=cfg)
    got, _ = trec.rglru(Params(tensors_from_jax(tree, device="cpu")), tx,
                        cfg=cfg)
    assert np.abs(np.asarray(want)).max() > 10
    _close(got, want, TOL)


@pytest.mark.parametrize("mode,S", [
    ("scan", 24), ("chunked", 24), ("kernel", 24),
    ("chunked", 20),            # S % chunk: falls back to the scan
])
def test_rwkv6_time_mix_matches_jax(mode, S):
    cfg = jconfigs.get_config("rwkv6-3b", smoke=True).replace(
        rwkv_impl="chunked" if mode == "chunked" else "scan", rwkv_chunk=8)
    tcfg = tconfigs.get_config("rwkv6-3b", smoke=True).replace(
        rwkv_impl=cfg.rwkv_impl, rwkv_chunk=8)
    jp, tp = _layer_params(jrec.rwkv6_struct, cfg, 7)
    jp, tp = jp["tm"], Params(tp["tm"])
    jx, tx = _both(_x(7, 2, S, cfg.d_model), torch.float32)
    kernel = mode == "kernel"
    want, wstate = jrec.rwkv6_time_mix(jp, jx, cfg=cfg, use_kernel=kernel)
    got, gstate = trec.rwkv6_time_mix(tp, tx, cfg=tcfg, use_kernel=kernel)
    _close(got, want, TOL, "prefill out")
    _state_close(gstate, wstate, TOL, "prefill")
    jx1, tx1 = _both(_x(8, 2, 1, cfg.d_model), torch.float32)
    want, wstate = jrec.rwkv6_time_mix(jp, jx1, cfg=cfg, state=wstate)
    got, gstate = trec.rwkv6_time_mix(tp, tx1, cfg=tcfg, state=gstate)
    _close(got, want, TOL, "decode out")
    _state_close(gstate, wstate, TOL, "decode")


def test_rwkv6_decay_clip_matches_jax():
    """decay_base from -12 to 8 drives log-decay past both ends of its
    [-8, 4] clip."""
    cfg = jconfigs.get_config("rwkv6-3b", smoke=True)
    jp, tp = _layer_params(jrec.rwkv6_struct, cfg, 14)
    base = np.linspace(-12.0, 8.0, cfg.d_model).astype(np.float32)
    jp = {**jp["tm"], "decay_base": base}
    tp = Params({**tp["tm"], "decay_base": torch.from_numpy(base)})
    jx, tx = _both(_x(14, 2, 24, cfg.d_model), torch.float32)
    want, wstate = jrec.rwkv6_time_mix(jp, jx, cfg=cfg)
    got, gstate = trec.rwkv6_time_mix(tp, tx, cfg=cfg)
    _close(got, want, TOL)
    _state_close(gstate, wstate, TOL, "prefill")


def test_rwkv6_chunked_returns_none_on_a_ragged_chunk():
    r = torch.zeros((1, 20, 2, 8))
    assert trec.rwkv6_wkv_chunked(r, r, r, r, torch.zeros((2, 8)),
                                  chunk=8) is None


def test_rwkv6_channel_mix_matches_jax():
    cfg = jconfigs.get_config("rwkv6-3b", smoke=True)
    jp, tp = _layer_params(jrec.rwkv6_struct, cfg, 11)
    jp, tp = jp["cm"], Params(tp["cm"])
    jx, tx = _both(_x(11, 2, 16, cfg.d_model), torch.float32)
    want, wstate = jrec.rwkv6_channel_mix(jp, jx)
    got, gstate = trec.rwkv6_channel_mix(tp, tx)
    _close(got, want, TOL)
    _state_close(gstate, wstate, TOL, "prefill")
    jx1, tx1 = _both(_x(12, 2, 1, cfg.d_model), torch.float32)
    want, _ = jrec.rwkv6_channel_mix(jp, jx1, state=wstate)
    got, _ = trec.rwkv6_channel_mix(tp, tx1, state=gstate)
    _close(got, want, TOL, "decode")


# ---------------------------------------------------------------------------
# models at smoke size
# ---------------------------------------------------------------------------

def _smoke(arch, seed=0):
    cfg = jconfigs.get_config(arch, smoke=True)
    jparams = jmodels.init_params(jmodels.model_struct(cfg),
                                  jax.random.PRNGKey(seed))
    tcfg = tconfigs.get_config(arch, smoke=True)
    return cfg, jparams, tcfg, params_from_jax(_np_tree(jparams), tcfg,
                                               device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_config_and_param_count_equal_jax(arch, smoke):
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    tcfg = tconfigs.get_config(arch, smoke=smoke)
    assert_config_equal_jax(tcfg, jcfg)
    for prop in ("hd", "padded_vocab", "kinds", "layers_in_plan"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop)
    n = tmodels.param_count(tmodels.model_struct(tcfg))
    assert n == jmodels.param_count(jmodels.model_struct(jcfg))
    if not smoke:
        assert n == FULL_PARAM_COUNT[arch]


@pytest.mark.parametrize("arch,knobs", [
    ("recurrentgemma-2b", {}),
    ("recurrentgemma-2b", {"attn_impl": "flash"}),
    ("rwkv6-3b", {}),
    ("rwkv6-3b", {"rwkv_impl": "chunked", "rwkv_chunk": 8}),
])
def test_forward_matches_jax(arch, knobs):
    cfg, jparams, tcfg, model = _smoke(arch)
    toks = _tokens(cfg, 2, 32)
    want, _, _ = jmodels.forward(jparams, cfg.replace(**knobs),
                                 {"tokens": jnp.asarray(toks)})
    got, _, _ = tmodels.forward(model, tcfg.replace(**knobs),
                                {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, cfg.vocab_size)
    _close(got, want, TOL)


def test_rwkv6_chunked_follows_jax_past_its_clip():
    """At 64-token chunks a chunk's summed log-decay passes the -30 clip
    (decay ~e^-1 a step at init): the JAX package's chunked form then
    departs from its own scan, and the port reproduces it as it is."""
    cfg, jparams, tcfg, model = _smoke("rwkv6-3b")
    toks = _tokens(cfg, 2, 64)
    knobs = {"rwkv_impl": "chunked", "rwkv_chunk": 64}
    want, _, _ = jmodels.forward(jparams, cfg.replace(**knobs),
                                 {"tokens": jnp.asarray(toks)})
    got, _, _ = tmodels.forward(model, tcfg.replace(**knobs),
                                {"tokens": torch.from_numpy(toks)})
    scan, _, _ = tmodels.forward(model, tcfg,
                                 {"tokens": torch.from_numpy(toks)})
    _close(got, want, TOL)
    assert (got - scan).abs().max().item() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_jax(arch):
    cfg, jparams, tcfg, model = _smoke(arch, 1)
    toks = _tokens(cfg, 2, 24, seed=1)
    want_logits, _, want_caches = jmodels.forward(
        jparams, cfg, {"tokens": jnp.asarray(toks)}, return_cache=True)
    logits, caches = tsteps.prefill(model, tcfg,
                                    {"tokens": torch.from_numpy(toks)})
    _close(logits, want_logits, TOL)
    assert len(caches) == len(want_caches)
    for seg, (got, want) in enumerate(zip(caches, want_caches)):
        assert sorted(got) == sorted(want)
        for j in want:
            _state_close(got[j], want[j], TOL, f"segment {seg} pos {j}")
    names = {n for seg in caches for pos in seg.values() for n in pos}
    want_names = ({"conv", "h", "k", "v"} if arch == "recurrentgemma-2b"
                  else {"tm_shift", "wkv", "cm_shift"})
    assert names == want_names


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_step_by_step(arch):
    cfg, jparams, tcfg, model = _smoke(arch, 2)
    B, max_len, n = 2, 16, 12     # n > the smoke window 8: the ring wraps
    toks = _tokens(cfg, B, n, seed=2)
    jcaches = [jmodels.init_params(cs, jax.random.PRNGKey(1))
               for cs in jmodels.cache_struct(cfg, B, max_len)]
    tcaches = tmodels.init_params(tmodels.cache_struct(tcfg, B, max_len),
                                  None, device="cpu")
    dec = jax.jit(lambda p, c, t, i: jmodels.decode_step(p, cfg, c, t, i))
    for i in range(n):
        want, jcaches = dec(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                            jnp.asarray(i, jnp.int32))
        got, tcaches = tmodels.decode_step(
            model, tcfg, tcaches, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(got, want, TOL, f"step {i}")
    for seg, (got, want) in enumerate(zip(tcaches, jcaches)):
        for j in want:
            _state_close(got[j], want[j], TOL, f"segment {seg} pos {j}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_from_converted_jax_caches(arch):
    """JAX decodes 3 steps; its caches (with the f32 h / wkv leaves) are
    handed over by tensors_from_jax, and the port decodes on from them."""
    cfg, jparams, tcfg, model = _smoke(arch, 4)
    B, max_len, n = 2, 16, 6
    toks = _tokens(cfg, B, n, seed=4)
    jcaches = [jmodels.init_params(cs, jax.random.PRNGKey(1))
               for cs in jmodels.cache_struct(cfg, B, max_len)]
    dec = jax.jit(lambda p, c, t, i: jmodels.decode_step(p, cfg, c, t, i))
    for i in range(3):
        _, jcaches = dec(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                         jnp.asarray(i, jnp.int32))
    tcaches = tensors_from_jax(_np_tree(jcaches), device="cpu")
    fresh = tmodels.init_params(tmodels.cache_struct(tcfg, B, max_len), None,
                                device="cpu")
    for got, want in zip(tcaches, fresh):
        for j in want:
            for name in want[j]:
                assert got[j][name].shape == want[j][name].shape
                assert got[j][name].dtype == want[j][name].dtype, name
    for i in range(3, n):
        want, jcaches = dec(jparams, jcaches, jnp.asarray(toks[:, i:i + 1]),
                            jnp.asarray(i, jnp.int32))
        got, tcaches = tmodels.decode_step(
            model, tcfg, tcaches, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(got, want, TOL, f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_emits_jax_tokens(arch):
    kw = dict(smoke=True, batch=2, prompt_len=8, gen_len=8, max_len=64,
              seed=3)
    want = jserve.serve(arch, **kw)
    cfg = jconfigs.get_config(arch, smoke=True)
    jparams = jmodels.init_params(jmodels.model_struct(cfg),
                                  jax.random.PRNGKey(3))
    model = params_from_jax(_np_tree(jparams),
                            tconfigs.get_config(arch, smoke=True),
                            device="cpu")
    got = tserve.serve(arch, params=model, device="cpu", **kw)
    assert got["steps"] == want["steps"]
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_recurrent_layers_take_the_kernel_only_when_asked(monkeypatch):
    """On the CPU the model's own forward (the default use_kernel) takes
    the plain scan; a layer call with use_kernel=True goes through ops."""
    cfg, _, tcfg, model = _smoke("recurrentgemma-2b")
    calls = []
    orig = tops.rglru_scan
    monkeypatch.setattr(tops, "rglru_scan",
                        lambda a, b, **kw: calls.append(1) or orig(a, b))
    tmodels.forward(model, tcfg,
                    {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    assert calls == []
    trec.rglru(getattr(model.segments[0][0], "0").rglru,
               torch.zeros((1, 8, cfg.d_model)), cfg=tcfg, use_kernel=True)
    assert calls == [1]


# ---------------------------------------------------------------------------
# The route of a prefill's scan (recurrent.scan_route)
# ---------------------------------------------------------------------------

def _want_route(use_kernel, device, grad_mode, requires_grad, rwkv_impl):
    """The route table: True is the kernel; otherwise an explicit chunked
    form; otherwise False is the plain form, and None the kernel only on
    a CUDA device with no gradient needed."""
    if use_kernel is True:
        return "kernel"
    if rwkv_impl == "chunked":
        return "chunked"
    if use_kernel is False:
        return "plain"
    needs_grad = grad_mode and requires_grad
    return "kernel" if device == "cuda" and not needs_grad else "plain"


@pytest.mark.parametrize("rwkv_impl", ["scan", "chunked"])
@pytest.mark.parametrize("use_kernel", [None, True, False])
@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("grad_mode", [True, False])
@pytest.mark.parametrize("device", ["cpu", "cuda", "meta"])
def test_scan_route(device, grad_mode, requires_grad, use_kernel, rwkv_impl):
    """The device is a torch.device, so the CUDA rows need no card."""
    with torch.set_grad_enabled(grad_mode):
        got = trec.scan_route(use_kernel, torch.device(device),
                              requires_grad, rwkv_impl)
    assert got == _want_route(use_kernel, device, grad_mode, requires_grad,
                              rwkv_impl)


@pytest.mark.parametrize("layer", ["rglru", "rwkv6_time_mix"])
def test_default_route_on_the_cpu_is_jax_plain_form(layer, monkeypatch):
    """The layers with the default use_kernel on CPU tensors against the
    JAX package's use_kernel=False, prefill and one decode step: the plain
    form, no call of the kernel wrappers."""
    calls = []
    for name in ("rglru_scan", "rwkv6_scan"):
        monkeypatch.setattr(tops, name,
                            lambda *a, name=name, **kw: calls.append(name))
    if layer == "rglru":
        cfg = jconfigs.get_config("recurrentgemma-2b", smoke=True)
        tcfg = tconfigs.get_config("recurrentgemma-2b", smoke=True)
        jp, tp = _layer_params(jrec.rglru_struct, cfg, 21)
        tp = Params(tp)
        jfn, tfn = jrec.rglru, trec.rglru
    else:
        cfg = jconfigs.get_config("rwkv6-3b", smoke=True)
        tcfg = tconfigs.get_config("rwkv6-3b", smoke=True)
        jp, tp = _layer_params(jrec.rwkv6_struct, cfg, 21)
        jp, tp = jp["tm"], Params(tp["tm"])
        jfn, tfn = jrec.rwkv6_time_mix, trec.rwkv6_time_mix
    jx, tx = _both(_x(21, 2, 24, cfg.d_model), torch.float32)
    want, wstate = jfn(jp, jx, cfg=cfg, use_kernel=False)
    got, gstate = tfn(tp, tx, cfg=tcfg)
    _close(got, want, TOL, "prefill out")
    _state_close(gstate, wstate, TOL, "prefill")
    jx1, tx1 = _both(_x(22, 2, 1, cfg.d_model), torch.float32)
    want, wstate = jfn(jp, jx1, cfg=cfg, state=wstate)
    got, gstate = tfn(tp, tx1, cfg=tcfg, state=gstate)
    _close(got, want, TOL, "decode out")
    _state_close(gstate, wstate, TOL, "decode")
    assert calls == []
