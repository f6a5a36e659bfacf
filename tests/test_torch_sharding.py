"""The port's sharding rule engine against ``repro.sharding``, spec for
spec, with no ranks: the production meshes (16, 16) and (2, 16, 16) and a
host mesh (4, 2) as ``jax.sharding.AbstractMesh`` on the reference side
and :class:`repro_torch.sharding.AbstractMesh` on the port's, for all ten
archs, FSDP on and off and one override each; the mesh-to-config glue of
``launch/steps.py``; the cases of ``tests/test_optim_sharding.py`` (no
duplicate axes, divisibility, vocab padding); and ``_chunked_sdpa`` on one
process against the reference's (causal, windowed, GQA), within 1e-5 in
f32 (the two sum the chunk's products in other orders; observed ~1e-7).
The machine with the card has no JAX: there this module skips as a
whole."""
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from jax.sharding import AbstractMesh as JAbstractMesh

from repro import configs as jconfigs
from repro import models as jmodels
from repro import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import sharding as tsharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models.base import P, PartitionSpec, tree_leaves

ARCHS = jconfigs.ARCH_NAMES
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
# one override an arch, each a rule a cell sweep might change
OVERRIDES = {"llama3.2-1b": {"vocab": None},
             "gemma3-4b": {"vocab": "data"},
             "recurrentgemma-2b": {"mlp": None},
             "rwkv6-3b": {"heads_x": None},
             "mixtral-8x7b": {"experts": "data"},
             "deepseek-moe-16b": {"embed": "model"},
             "minitron-4b": {"layers": "data"},
             "internlm2-20b": {"embed": ("pod", "data")},
             "hubert-xlarge": {"frontend": "model"},
             "internvl2-2b": {"mlp": "data"}}


def _meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), tsharding.AbstractMesh(sizes, names)


def _cfgs(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


def _norm(spec) -> tuple:
    """A spec as a plain tuple of None, names and tuples of names; a tuple
    of one name is that name (JAX's ``PartitionSpec`` stores it so)."""
    def one(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(one(e) for e in spec)


def _jspecs(tree):
    return [_norm(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _tspecs(tree):
    return [_norm(s) for s in tree_leaves(tree)]


def test_the_meshes_are_the_references():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    for name in MESHES:
        jm, tm = _meshes(name)
        assert tsharding.data_axes(tm) == jsharding.data_axes(jm)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_reference(arch, mesh, fsdp):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = _meshes(mesh)
    assert tsharding.logical_rules(tcfg, tm, fsdp=fsdp) \
        == jsharding.logical_rules(jcfg, jm, fsdp=fsdp)
    got = _tspecs(tsharding.param_pspecs(tmodels.model_struct(tcfg), tcfg,
                                         tm, fsdp=fsdp))
    want = _jspecs(jsharding.param_pspecs(jmodels.model_struct(jcfg), jcfg,
                                          jm, fsdp=fsdp))
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_an_override_moves_as_in_the_reference(arch, mesh):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = _meshes(mesh)
    ov = OVERRIDES[arch]
    got = _tspecs(tsharding.param_pspecs(tmodels.model_struct(tcfg), tcfg,
                                         tm, overrides=ov))
    want = _jspecs(jsharding.param_pspecs(jmodels.model_struct(jcfg), jcfg,
                                          jm, overrides=ov))
    assert got == want
    base = _tspecs(tsharding.param_pspecs(tmodels.model_struct(tcfg), tcfg,
                                          tm))
    assert got != base, (arch, ov)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_and_glue_equal_the_reference(arch, mesh):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = _meshes(mesh)
    for batch in (1, 8, 32, 64):
        got = tsharding.batch_pspec(tcfg, tm, batch)
        want = jsharding.batch_pspec(jcfg, jm, batch)
        assert {k: _norm(v) for k, v in got.items()} \
            == {k: _norm(v) for k, v in want.items()}
        assert tsteps._mesh_batch_axes(tm, batch) \
            == jsteps._mesh_batch_axes(jm, batch)
        if jcfg.is_decoder:
            got = tsharding.cache_pspecs(
                tmodels.cache_struct(tcfg, batch, 64), tcfg, tm, batch)
            want = jsharding.cache_pspecs(
                jmodels.cache_struct(jcfg, batch, 64), jcfg, jm, batch)
            assert _tspecs(got) == _jspecs(want)
    assert tsteps._auto_score_shard(tcfg, tm) \
        == jsteps._auto_score_shard(jcfg, jm)
    assert tsteps._auto_kv_shard(tcfg, tm) == jsteps._auto_kv_shard(jcfg, jm)


def _named(tree, path=()):
    """(path, leaf) of a tree of dicts and lists, in tree order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [x for i, t in enumerate(tree) for x in _named(t, path + (i,))]
    return [(path, tree)]


# the dimension of each recurrent leaf (stacked: after 'layers') that the
# tensor-parallel forms in models/recurrent.py take split over 'model'
RECURRENT_MODEL_DIMS = {
    "rglru": {"in_x": 2, "in_y": 2, "conv_w": 2, "conv_b": 1, "gate_a": 1,
              "gate_i": 1, "log_lambda": 1, "out": 1},
    "tm": {"lora_a": 2, "lora_b": 2, "wr": 2, "wk": 2, "wv": 2, "wg": 2,
           "wo": 1, "decay_a": 2, "decay_b": 1},
    "cm": {"wk": 2, "wv": 1, "wr": 2},
}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_recurrent_leaves_are_split_as_their_mesh_forms_take_them(arch,
                                                                  mesh):
    """The RG-LRU and RWKV-6 leaves' specs, leaf by leaf, equal
    ``repro.sharding``'s, and put 'model' on the dimension the layers'
    tensor-parallel forms read as split; the decode cache on a mesh
    (``cache_struct(tp_layout=True)``, the RWKV-6 wkv state value-major)
    splits every recurrent state's channels over 'model'."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = _meshes(mesh)
    got = _named(tsharding.param_pspecs(tmodels.model_struct(tcfg), tcfg, tm))
    want = _jspecs(jsharding.param_pspecs(jmodels.model_struct(jcfg), jcfg,
                                          jm))
    seen = 0
    for (path, spec), ref in zip(got, want, strict=True):
        block = next((b for b in RECURRENT_MODEL_DIMS if b in path), None)
        if block is None:
            continue
        assert _norm(spec) == ref, (path, spec, ref)
        dim = RECURRENT_MODEL_DIMS[block].get(path[-1])
        if dim is not None:
            assert spec[dim] == "model", (path, spec)
            seen += 1
    # rwkv6-3b: one stacked segment; recurrentgemma-2b: two RG-LRU
    # positions in each of its two segments
    assert seen == {"rwkv6-3b": 12, "recurrentgemma-2b": 4 * 8}[arch]
    cache = _named(tsharding.cache_pspecs(
        tmodels.cache_struct(tcfg, 32, 64, tp_layout=True), tcfg, tm, 32))
    for path, spec in cache:
        if path[-1] in ("conv", "h", "tm_shift", "wkv", "cm_shift"):
            assert spec[-1] == "model", (path, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_config_on_a_mesh_is_prefill_cells(arch):
    """The knobs ``prefill_cell`` derives from its mesh (the reference's
    cell builder, read from its source's rule: the same fields)."""
    jcfg, _ = _cfgs(arch)
    jm, tm = _meshes("4x2")
    want = jcfg.replace(score_shard=jsteps._auto_score_shard(jcfg, jm),
                        batch_axes=jsteps._mesh_batch_axes(jm, 8),
                        act_shard="seq", attn_dtype="bf16",
                        kv_shard=jsteps._auto_kv_shard(jcfg, jm))
    got = tsteps.prefill_config(arch, mesh=tm, batch=8)
    assert {k: getattr(got, k) for k in ("score_shard", "batch_axes",
                                         "act_shard", "attn_dtype",
                                         "kv_shard")} \
        == {k: getattr(want, k) for k in ("score_shard", "batch_axes",
                                          "act_shard", "attn_dtype",
                                          "kv_shard")}


def test_partition_specs_rule_on_one_leaf():
    """A mesh axis at most once per spec; later repeats replicate; unknown
    axes replicate (``repro.models.partition_specs``)."""
    struct = {"a": P((8, 8, 8), ("embed", "mlp", "heads")),
              "b": P((4,), ("nothing",)),
              "c": P((8, 8), ("batch", "embed"))}
    rules = {"embed": "data", "mlp": "model", "heads": "model",
             "batch": ["pod", "data"]}
    got = tmodels.base.partition_specs(struct, rules)
    want = jmodels.partition_specs(
        {"a": jmodels.base.P((8, 8, 8), ("embed", "mlp", "heads")),
         "b": jmodels.base.P((4,), ("nothing",)),
         "c": jmodels.base.P((8, 8), ("batch", "embed"))}, rules)
    assert _tspecs(got) == _jspecs(want)
    assert got["a"] == PartitionSpec("data", "model", None)
    assert got["c"] == PartitionSpec(("pod", "data"), None)


def test_placements_map_specs_onto_a_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert tsharding.placements(mesh, PartitionSpec("data", "model")) \
        == [Shard(0), Shard(1)]
    assert tsharding.placements(mesh, PartitionSpec(None, "model", None)) \
        == [Replicate(), Shard(1)]
    assert tsharding.placements(mesh, PartitionSpec(None, None)) \
        == [Replicate(), Replicate()]
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsharding.placements(pod, PartitionSpec(("pod", "data"), None)) \
        == [Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        tsharding.placements(pod, PartitionSpec(("data", "pod"), None))


# the cases of tests/test_optim_sharding.py on the port's engine ---------

@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_partition_specs_no_duplicate_axes(mesh):
    _, tm = _meshes(mesh)
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        for spec in tree_leaves(tsharding.param_pspecs(
                tmodels.model_struct(cfg), cfg, tm)):
            flat = [a for s in spec if s is not None
                    for a in (s if isinstance(s, tuple) else (s,))]
            assert len(flat) == len(set(flat)), (arch, spec)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_partition_specs_divisibility(mesh):
    _, tm = _meshes(mesh)
    sizes = tm.shape
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        struct = tmodels.model_struct(cfg)
        for leaf, spec in zip(tree_leaves(struct), tree_leaves(
                tsharding.param_pspecs(struct, cfg, tm)), strict=True):
            for dim, s in zip(leaf.shape, spec):
                n = int(np.prod([sizes[a] for a in (
                    () if s is None else s if isinstance(s, tuple)
                    else (s,))]))
                assert dim % n == 0, (arch, leaf.shape, spec)


def test_vocab_padding_only_when_needed():
    hub = tconfigs.get_config("hubert-xlarge")
    assert hub.padded_vocab == 512 and hub.vocab_size == 504
    llama = tconfigs.get_config("llama3.2-1b")
    assert llama.padded_vocab == llama.vocab_size


# _chunked_sdpa on one process ----------------------------------------------

@pytest.mark.parametrize("case", [
    # (B, S, H, K, hd, window, causal, chunk)
    (2, 64, 4, 4, 8, 0, True, 16),
    (2, 64, 8, 2, 8, 24, True, 16),
    (1, 48, 4, 1, 16, 0, False, 16),
    (1, 40, 4, 2, 8, 12, True, 16),      # 40 % 16: one chunk
])
@pytest.mark.parametrize("attn_dtype", ["f32", "bf16"])
def test_chunked_sdpa_matches_the_reference(case, attn_dtype):
    B, S, H, K, hd, window, causal, chunk = case
    rng = np.random.default_rng(S + H + window)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, K, K))
    jcfg = jconfigs.get_config("llama3.2-1b", smoke=True).replace(
        attn_dtype=attn_dtype)
    tcfg = tconfigs.get_config("llama3.2-1b", smoke=True).replace(
        attn_dtype=attn_dtype)
    want = np.asarray(jlayers._chunked_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=jcfg,
        window=window, causal=causal, chunk=chunk), np.float32)
    got = tlayers._chunked_sdpa(
        *(torch.from_numpy(t) for t in (q, k, v)), cfg=tcfg, window=window,
        causal=causal, chunk=chunk).float().numpy()
    tol = 1e-5 if attn_dtype == "f32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_chunked_sdpa_matches_the_dense_path_and_trains():
    """The chunked schedule is the dense masked attention, and its
    gradient flows (each chunk recomputed in the backward pass)."""
    tcfg = tconfigs.get_config("gemma3-4b", smoke=True)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 32, n, 16, generator=g, requires_grad=True)
               for n in (4, 2, 2))
    pos = torch.arange(32)
    mask = tlayers.attn_mask(pos, pos, causal=True, window=8)
    dense = tlayers._sdpa(q, k, v, mask, scale=16 ** -0.5, cfg=tcfg)
    chunked = tlayers._chunked_sdpa(q, k, v, cfg=tcfg, window=8,
                                    causal=True, chunk=8)
    torch.testing.assert_close(chunked, dense, atol=1e-6, rtol=1e-5)
    gd = torch.autograd.grad(dense.sum(), (q, k, v))
    gc = torch.autograd.grad(chunked.sum(), (q, k, v))
    for a, b in zip(gc, gd):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_sharded_zeros_like_specs_match_the_reference(arch):
    got = tmodels.base.sharded_zeros_like_specs(
        tmodels.model_struct(tconfigs.get_config(arch, smoke=True)),
        device="cpu")
    want = jmodels.base.sharded_zeros_like_specs(
        jmodels.model_struct(jconfigs.get_config(arch, smoke=True)))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
        assert not a.any()
