"""The port's optimizer, schedule, int8 compression and straggler monitor
(``repro_torch.optim``, ``repro_torch.runtime``) against the JAX package's
(``repro.optim``, ``repro.runtime``), on the same inputs drawn with numpy.

Tolerances: f32 results within 1e-6 relative (XLA and torch round ``pow``,
``sqrt`` and the global norm's sums in their own orders; observed <= 2
ulp); bf16 leaves within one bf16 ulp (an f32 result one ulp apart may
round to the neighbouring bf16); compression bit for bit (its only
rounding, a division and a round half to even, is correctly rounded in
both).  The machine with the card has no JAX: there this module skips as
a whole."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import optim as joptim
from repro import runtime as jruntime
from repro.optim.adamw import global_norm as jglobal_norm
from repro_torch import optim as toptim
from repro_torch import runtime as truntime
from repro_torch.models.base import tree_leaves
from repro_torch.models.convert import tensors_from_jax

RTOL = 1e-6
BF16_RTOL = 2 ** -7


def _tree(rng, scale=1.0):
    """A param-like tree: f32 matrix and vector leaves and a bf16 leaf."""
    def f32(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": f32(16, 8),
            "b": {"k": f32(8).astype(jnp.bfloat16), "z": f32(4, 3)},
            "seg": [f32(2, 5, 3)]}


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32), np.float32)


def _close(got, want, bf16=False):
    np.testing.assert_allclose(_np(got), _np(want),
                               rtol=BF16_RTOL if bf16 else RTOL,
                               atol=1e-7 if not bf16 else 0)


def _assert_trees(got, want):
    jl = jax.tree_util.tree_leaves(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j, bf16=(j.dtype == jnp.bfloat16))
        if j.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_update_matches_jax(steps, clip):
    """A bf16 leaf, and a leaf with no gradient: ``None`` in the port, as a
    parameter that the loss never reads leaves it, zeros in JAX."""
    rng = np.random.default_rng(steps)
    params = _tree(rng, 0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tensors_from_jax(params, device="cpu")
    cfg = toptim.AdamWConfig(lr=1e-2, weight_decay=0.1)
    jcfg = joptim.AdamWConfig(lr=1e-2, weight_decay=0.1)
    jst, tst = joptim.adamw_init(jp), toptim.adamw_init(tp)
    gscale = 3.0 if clip == "active" else 0.01
    for i in range(steps):
        g = _tree(rng, gscale)
        g["b"]["z"] = np.zeros_like(g["b"]["z"])
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        tg = tensors_from_jax(g, device="cpu")
        tg["b"]["z"] = None
        lr = 1e-2 * (i + 1) / steps
        jp, jst, jn = joptim.adamw_update(jp, jg, jst, jcfg, lr=lr)
        out_p, tst, tn = toptim.adamw_update(tp, tg, tst, cfg,
                                             lr=torch.tensor(lr))
        assert out_p is tp                       # updated in place
        _close(tn, jn)
        assert (float(jn) > 1.0) == (clip == "active")
    _assert_trees(tp, jp)
    _assert_trees(tst["m"], jst["m"])
    _assert_trees(tst["v"], jst["v"])
    assert int(tst["step"]) == int(jst["step"]) == steps
    assert tst["step"].dtype == torch.int32


def test_global_norm_matches_jax():
    rng = np.random.default_rng(7)
    g = _tree(rng, 2.0)
    _close(toptim.global_norm(tensors_from_jax(g, device="cpu")),
           jglobal_norm(jax.tree_util.tree_map(jnp.asarray, g)))


@pytest.mark.parametrize("warmup,total", [(200, 10_000), (10, 50), (1, 2)])
def test_cosine_schedule_matches_jax(warmup, total):
    mid = (warmup + total) // 2
    for step in (0, warmup - 1, warmup, mid, total, total + 7):
        kw = dict(peak_lr=3e-3, warmup=warmup, total=total)
        got = toptim.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                     **kw)
        want = joptim.cosine_schedule(jnp.int32(step), **kw)
        assert got.dtype == torch.float32
        _close(got, want)
        _close(toptim.cosine_schedule(step, **kw), want)


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.atleast_1d(np.asarray(want))
    got = np.atleast_1d(got.numpy())
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_quantize_int8_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    # exact halves after scaling (scale 1.0): round half to even
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5],
                      np.float32)
    for x in (halves, (rng.standard_normal(4099) * 5).astype(np.float32),
              np.zeros(5, np.float32)):
        q, s = truntime.quantize_int8(torch.from_numpy(x))
        jq, js = jruntime.quantize_int8(jnp.asarray(x))
        _bits_equal(q, jq)
        _bits_equal(s, js)
        _bits_equal(truntime.dequantize_int8(q, s),
                    jruntime.dequantize_int8(jq, js))
    assert q.dtype == torch.int8


def test_ef_compress_grads_bit_equal_to_jax():
    """Three steps of error feedback over a tree with a bf16 leaf, from a
    ``None`` error state."""
    rng = np.random.default_rng(11)
    jerr = terr = None
    for _ in range(3):
        g = _tree(rng, 0.1)
        jc, jerr = jruntime.ef_compress_grads(
            jax.tree_util.tree_map(jnp.asarray, g), jerr)
        tc, terr = truntime.ef_compress_grads(
            tensors_from_jax(g, device="cpu"), terr)
        for t, j in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            if j.dtype == jnp.bfloat16:
                _bits_equal(t.view(torch.int16), np.asarray(j).view(np.int16))
            else:
                _bits_equal(t, j)
        for t, j in zip(tree_leaves(terr), jax.tree_util.tree_leaves(jerr)):
            _bits_equal(t, j)


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32) * 5)
    q, s = truntime.quantize_int8(x)
    err = (truntime.dequantize_int8(q, s) - x).abs()
    assert err.max().item() <= s.item() * 0.5 + 1e-6


def test_error_feedback_telescopes():
    """The sum of EF-compressed gradients converges to the true sum."""
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(256)
                         .astype(np.float32) * 0.1)
    err, applied = None, torch.zeros_like(g)
    for _ in range(50):
        comp, err = truntime.ef_compress_grads(g, err)
        applied = applied + comp
    np.testing.assert_allclose((applied / 50).numpy(), g.numpy(), atol=1e-3)


def test_compressed_allreduce_names_its_item():
    """``compressed_allreduce`` once raised naming ROADMAP item 11; it is
    ported: over a 2-rank gloo world it sums two tensors within the int8
    error (``tests/test_torch_distributed.py`` holds it to the JAX
    package's)."""
    from repro_torch.launch.mesh import spawn_world
    from tests.torch_dist_workers import compress_two
    xs = np.random.default_rng(0).standard_normal((2, 1001)).astype(
        np.float32)
    got = spawn_world(compress_two, 2, xs, device="cpu")
    want = xs.sum(0)
    for g in got:
        assert g.shape == want.shape
        assert np.abs(g - want).max() / np.abs(want).max() < 0.05
    np.testing.assert_array_equal(got[0], got[1])


def test_straggler_detection():
    mon = truntime.StragglerMonitor(window=10, threshold=1.5)
    for _ in range(10):
        for h in range(8):
            mon.record(h, 1.0 if h != 5 else 2.5)
    assert mon.stragglers() == [5]
    jmon = jruntime.StragglerMonitor(window=10, threshold=1.5)
    for _ in range(10):
        for h in range(8):
            jmon.record(h, 1.0 if h != 5 else 2.5)
    assert mon.relative_speed() == jmon.relative_speed()


def test_rebalance_preserves_total_and_starves_none():
    speeds = {0: 1.0, 1: 1.0, 2: 0.4, 3: 1.2}
    alloc = truntime.rebalance_batches(64, speeds, quantum=2)
    assert sum(alloc.values()) == 64
    assert all(v >= 2 for v in alloc.values())
    assert alloc[2] < alloc[0] <= alloc[3]
    assert alloc == jruntime.rebalance_batches(64, speeds, quantum=2)
