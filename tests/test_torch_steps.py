"""The port's cells (``repro_torch.launch.steps``) and ``adamw_init_struct``
against the JAX package's, and decode on a mesh against one rank.

- ``adamw_init_struct`` and ``input_specs`` field for field against the
  reference's, for all ten archs (and all four shapes).
- ``train_cell``'s step (fsdp with 1 and 2 microbatches, zero1) on smoke
  llama3.2-1b, 8 x 64 tokens, f32 scores: the port on one rank and on
  (2, 2) and (1, 4) gloo worlds against the reference's ``train_cell`` fn, jitted on a
  (4, 2) mesh of host devices in a subprocess (as
  ``tests/test_perf_modes.py`` builds it).  Both compute in bf16 from f32
  masters, so they agree to bf16's rounding, not to f32's: the loss
  within 1e-4 relative and the gradient norm within 2e-3 (products
  rounded to bf16 in other orders; measured here: 2e-6 to 8e-6 and 9e-5
  to 3.3e-4).  AdamW's first step moves a parameter by
  ``lr * (g / |g| + wd * p)``, whatever the size of g, so a gradient
  element near zero whose sign differs between the two moves its
  parameter 2·lr apart: every parameter within 2·lr·1.01 of the
  reference's, and the mean difference under lr / 100 (measured: 5.7e-7
  to 6.5e-7, lr / 100 = 3e-6).
- rwkv6-3b's LoRA interpolation weights at full width on (1, 4) against
  one rank, f32 and bf16: the rounding of each rank's bf16 partial sum
  (:func:`test_lora_combine_on_a_mesh_rounds_each_partial_sum`).
- The prefill at (1, 4), where the smoke model's 2 kv heads do not
  divide the model axis (a rank projects its head_dim slice of them and
  all-gathers it), against the one-rank port (1e-5) and the reference's
  ``forward`` (2e-4).
- Decode on a mesh in a gloo world of 4 CPU ranks: 8 steps of
  ``decode_cell``'s step from zeroed caches against the one-rank
  ``decode_step`` on the same parameters, f32, within 1e-5 of the
  largest logit, for caches split on kv heads ((2, 2), llama3.2-1b and
  the MoE deepseek-moe-16b), on head_dim ((1, 4), llama3.2-1b and
  gemma3-4b with its local ring buffer) and on the sequence (batch 1 at
  (2, 2): the positions over 'data', the softmax combined over it).

The machine with the card has no JAX: there this module skips as a
whole."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import steps as jsteps
from repro.models import model_struct as jmodel_struct
from repro.models.base import P as JP
from repro.models.base import abstract_params
from repro.optim import adamw_init_struct as jadamw_init_struct
from repro_torch import configs as tconfigs
from repro_torch.configs import Shape
from repro_torch.data import synthetic_batch
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import (Transformer, cache_struct, decode_step,
                                init_params, model_struct)
from repro_torch.models.base import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw_init_struct
from tests import torch_dist_workers as workers

ROOT = Path(__file__).resolve().parents[1]
TINY = Shape("tiny_train", 64, 8, "train")
LR = 3e-4                       # AdamWConfig's default, both packages
DECODE_CASES = [
    ("heads", "llama3.2-1b", (2, 2), 4, 16),
    ("heads_moe", "deepseek-moe-16b", (2, 2), 4, 16),
    ("hd", "llama3.2-1b", (1, 4), 4, 16),
    ("hd_local", "gemma3-4b", (1, 4), 4, 16),
    ("seq", "llama3.2-1b", (2, 2), 1, 16),
    ("seq_local", "gemma3-4b", (2, 2), 1, 16),
]
STEPS = 8


def _fields(p):
    return (tuple(p.shape), tuple(p.axes), p.init,
            None if p.dtype is None else str(p.dtype))


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_adamw_init_struct_matches_reference(arch):
    jcfg = jconfigs.get_config(arch)
    want = jadamw_init_struct(jmodel_struct(jcfg))
    got = adamw_init_struct(model_struct(tconfigs.get_config(arch)))
    jl = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, JP))
    assert [_fields(p) for p in tree_leaves(got)] == [_fields(p) for p in jl]


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_input_specs_match_reference(arch):
    for name, shape in jconfigs.SHAPES.items():
        want = jsteps.input_specs(jconfigs.get_config(arch), shape)
        got = tsteps.input_specs(tconfigs.get_config(arch),
                                 tconfigs.SHAPES[name])
        assert sorted(got) == sorted(want), (arch, name)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, (arch, name, k)
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
            assert got[k].device.type == "meta"


_REFERENCE = """
    import numpy as np
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    import repro.configs as C
    from repro.launch import steps
    from repro.models import model_struct
    from repro.models.base import abstract_params
    from repro.optim import adamw_init
    orig = C.get_config
    steps.get_config = lambda name, smoke=False: orig(name, smoke=True)
    C.SHAPES["tiny_train"] = C.Shape("tiny_train", 64, 8, "train")
    data = np.load(PATH_IN)
    cfg = orig("llama3.2-1b", smoke=True)
    tdef = jax.tree_util.tree_structure(abstract_params(model_struct(cfg)))
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(data[f"p{i}"]) for i in range(tdef.num_leaves)])
    batch = {k[2:]: jnp.asarray(data[k]) for k in data.files
             if k.startswith("b_")}
    out = {}
    for mode, kw in MODES.items():
        cell = steps.build_cell("llama3.2-1b", "tiny_train", mesh,
                                attn_dtype="f32", **kw)
        with mesh:
            if mode == "zero1":
                p = jax.tree_util.tree_map(
                    lambda x: x.astype(jnp.bfloat16), params)
                o = dict(adamw_init(params), master=params)
            else:
                p, o = params, adamw_init(params)
            new_p, new_o, m = jax.jit(cell.fn)(p, o, batch)
        w = new_o["master"] if mode == "zero1" else new_p
        out[mode + "_loss"] = np.float64(m["loss"])
        out[mode + "_gnorm"] = np.float64(m["grad_norm"])
        for i, x in enumerate(jax.tree_util.tree_leaves(w)):
            out[f"{mode}_p{i}"] = np.asarray(x, np.float32)
    np.savez(PATH_OUT, **out)
    print(json.dumps({"ok": True}))
"""


def _start_reference(tmp: Path, leaves, batch):
    """The reference's train cells in a subprocess on 8 host devices,
    started at once; ``_finish`` waits for them."""
    np.savez(tmp / "in.npz", **{f"p{i}": a for i, a in enumerate(leaves)},
             **{f"b_{k}": v for k, v in batch.items()})
    body = textwrap.dedent(_REFERENCE).replace(
        "PATH_IN", repr(str(tmp / "in.npz"))).replace(
        "PATH_OUT", repr(str(tmp / "out.npz"))).replace(
        "MODES", repr(workers.TRAIN_MODES))
    prog = ('import os\nos.environ["XLA_FLAGS"] = '
            '"--xla_force_host_platform_device_count=8"\n'
            "import json\nimport jax\nimport jax.numpy as jnp\n" + body)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, tmp: Path) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    data = np.load(tmp / "out.npz")
    return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cells")
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    tree = init_params(model_struct(cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    leaves = [t.numpy() for t in tree_leaves(tree)]
    batch = synthetic_batch(cfg, TINY.global_batch, TINY.seq_len)
    proc = _start_reference(tmp, leaves, batch)
    rng = np.random.default_rng(0)
    tokens = {c[0]: rng.integers(0, 96, (c[3], STEPS)).astype(np.int32)
              for c in DECODE_CASES}
    world = spawn_world(workers.cells_world, 4, DECODE_CASES, tokens, 0,
                        (leaves, batch, TINY), device="cpu")[0]
    one = workers.train_cell_runs(None, leaves, batch, TINY)
    return _finish(proc, tmp), world, one, tokens, (leaves, batch)


@pytest.mark.parametrize("where", ["one_rank", "mesh_2x2", "mesh_1x4"])
@pytest.mark.parametrize("mode", list(workers.TRAIN_MODES))
def test_train_cell_step_matches_reference(cells, mode, where):
    ref, world, one, _, _ = cells
    runs = {"one_rank": one, "mesh_2x2": world["train"],
            "mesh_1x4": world["train_1x4"]}
    loss, gnorm, params = runs[where][mode]
    np.testing.assert_allclose(loss, ref[f"{mode}_loss"], rtol=1e-4)
    np.testing.assert_allclose(gnorm, ref[f"{mode}_gnorm"], rtol=2e-3)
    diffs = [np.abs(p - ref[f"{mode}_p{i}"]) for i, p in enumerate(params)]
    assert max(d.max() for d in diffs) <= 2 * LR * 1.01
    assert np.mean(np.concatenate([d.ravel() for d in diffs])) < LR / 100


@pytest.mark.parametrize("case", [c[0] for c in DECODE_CASES])
def test_decode_on_a_mesh_matches_one_rank(cells, case):
    _, world, _, tokens, _ = cells
    name, arch, mesh_shape, B, L = next(c for c in DECODE_CASES
                                        if c[0] == case)
    cfg = tconfigs.get_config(arch, smoke=True)
    model = Transformer(cfg, init_params(
        model_struct(cfg), torch.Generator().manual_seed(0), device="cpu"))
    caches = tree_map(lambda p: torch.zeros(p.shape), cache_struct(cfg, B, L))
    want = []
    with torch.inference_mode():
        for pos in range(STEPS):
            logits, caches = decode_step(
                model, cfg, caches,
                torch.from_numpy(tokens[name][:, pos:pos + 1]), pos)
            want.append(logits.numpy())
    want = np.stack(want)
    got = world[name]["logits"][..., :cfg.vocab_size]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    split = {"heads": "Shard(dim=3)", "hd": "Shard(dim=4)"}
    k = world[name]["k"]
    if name.startswith("seq"):
        assert k.startswith("(Shard(dim=2)"), k      # positions over data
    else:
        assert k.startswith("(Shard(dim=1)"), k      # batch over data
    assert split["hd" if name.startswith("hd") else "heads"] in k, k


def test_lora_combine_on_a_mesh_rounds_each_partial_sum(cells):
    """Why rwkv6-3b's bf16 ``train_cell`` step at (1, 4) stands further
    from one rank's than the other archs' steps do: the Finch LoRA's
    interpolation weights (``recurrent._lora_mu``, full width, LoRA width
    160, 40 a rank).  In f32 the mesh's equal one rank's within 1e-6 of
    the largest.  In bf16 each rank's partial product is rounded before
    the all-reduce sums the four (as the JAX package's partitioned dot
    rounds its partial results), so the mesh's weights carry twice one
    rank's rounding error against the sum of the same bf16 operands'
    products (measured here: a mean of 3.7e-4 against 1.8e-4; held at
    1.5 times), and every element stays within the bound of those
    roundings, (tp + 1) u of the partials' absolute sum plus u |mu| (u =
    2^-8; measured: half of it), which a dropped or misplaced partial
    sum passes."""
    _, world, _, _, _ = cells
    got = world["lora_combine_1x4"]
    one32 = got["one_f32"]
    np.testing.assert_allclose(got["mesh_f32"], one32, rtol=0,
                               atol=1e-6 * np.abs(one32).max())
    exact = got["exact_bf16"]
    mesh_err = np.abs(got["mesh_bf16"] - exact)
    one_err = np.abs(got["one_bf16"] - exact)
    assert mesh_err.mean() >= 1.5 * one_err.mean()
    u = 2.0 ** -8
    bound = (got["tp"] + 1) * u * got["partials_abs"] \
        + u * np.abs(exact)
    assert (mesh_err <= bound).all()


def test_prefill_where_kv_heads_do_not_divide_the_model_axis(cells):
    """At (1, 4) smoke llama3.2-1b's 2 kv heads do not divide the model
    axis and its head_dim 8 does: each rank projects its head_dim slice
    of both kv heads and all-gathers it before RoPE.  The prefill's
    logits and last caches against the one-rank port (1e-5) and the
    reference's ``forward`` (2e-4), as the (2, 2) prefill is held."""
    _, world, _, _, (leaves, batch) = cells
    got = world["prefill_1x4"]
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    assert cfg.n_kv_heads % 4 and cfg.n_heads % 4 == 0 and cfg.hd % 4 == 0
    assert "Shard(dim=2)" not in got["wk"], got["wk"]   # not on kv heads
    tree = tree_unflatten(model_struct(cfg),
                          [torch.from_numpy(a) for a in leaves])
    toks = batch["tokens"]
    want, caches = tsteps.prefill(Transformer(cfg, tree),
                                  cfg.replace(attn_dtype="f32"),
                                  {"tokens": torch.from_numpy(toks)})
    logits = got["logits"][..., :cfg.vocab_size]
    np.testing.assert_allclose(logits, want.numpy(), rtol=0, atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name], caches[-1]["0"][name].numpy(),
                                   rtol=0, atol=1e-5)
    jcfg = jconfigs.get_config("llama3.2-1b", smoke=True)
    tdef = jax.tree_util.tree_structure(
        abstract_params(jmodel_struct(jcfg)))
    jp = jax.tree_util.tree_unflatten(tdef, [jnp.asarray(a) for a in leaves])
    jl = np.asarray(jmodels.forward(jp, jcfg,
                                    {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(logits, jl, rtol=0, atol=2e-4)
