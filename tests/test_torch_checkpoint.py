"""The port's checkpoints (``repro_torch.checkpoint``): the cases of the
JAX package's checkpoint tests (``tests/test_runtime.py``), and the
on-disk layout shared with ``repro.checkpoint``: a checkpoint either
package writes, the other restores leaf for leaf (exactly: f32 and int32
leaves are stored as they are).  The machine with the card has no JAX:
there this module skips as a whole."""
import functools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import models as jmodels
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.models.base import tree_leaves
from repro_torch.models.convert import params_from_jax, tensors_from_jax
from repro_torch.optim import adamw_init


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(16, 8, generator=g),
            "b": {"w": torch.arange(12, dtype=torch.int32).reshape(3, 4),
                  "s": torch.tensor(3.5)},
            "h": torch.randn(5, generator=g).to(torch.bfloat16),
            "l": [torch.randn(2, 3, generator=g)]}


def _equal_trees(got, want):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    tree = make_tree()
    d = save_checkpoint(str(tmp_path), 7, tree)
    assert sorted(os.listdir(d)) == ["COMMIT", "manifest.json",
                                     "proc00.npz"]
    assert latest_step(str(tmp_path)) == 7
    _equal_trees(restore_checkpoint(str(tmp_path), 7, tree), tree)


def test_checkpoint_partial_never_loads(tmp_path):
    tree = make_tree()
    d = save_checkpoint(str(tmp_path), 3, tree)
    os.remove(os.path.join(d, "COMMIT"))     # simulate crash mid-write
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        restore_checkpoint(str(tmp_path), 3, tree)


def test_checkpoint_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = make_tree()
    futures = []
    for s in (10, 20, 30, 40):
        futures.append(mgr.save(s, tree))
        saved = tree["a"].clone()
        with torch.no_grad():
            tree["a"].add_(1.0)          # after the snapshot: not saved
    mgr.close()
    assert [f.result() for f in futures] == [10, 20, 30, 40]
    assert latest_step(str(tmp_path)) == 40
    kept = sorted(os.listdir(str(tmp_path)))
    assert kept == ["step_000000030", "step_000000040"]
    out = restore_checkpoint(str(tmp_path), 40, tree)
    assert torch.equal(out["a"], saved)


def _train_state(seed=0):
    """The llama3.2-1b smoke params and fresh AdamW state of both packages:
    the stacked segment leaves, in a {"params", "opt"} tree as the train
    loops checkpoint it."""
    cfg = jconfigs.get_config("llama3.2-1b", smoke=True)
    jp = jax.jit(functools.partial(jmodels.init_params,
                                   jmodels.model_struct(cfg)))(
        jax.random.PRNGKey(seed))
    jst = jadamw_init(jp)
    jst["m"] = jax.tree_util.tree_map(lambda p: p * 0.5, jp)
    jst["step"] = jnp.int32(12)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            tconfigs.get_config("llama3.2-1b", smoke=True),
                            device="cpu")
    tst = adamw_init(model.tree)
    tst["m"] = tensors_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jst["m"]), "cpu")
    tst["step"] = torch.tensor(12, dtype=torch.int32)
    return {"params": jp, "opt": jst}, {"params": model.tree, "opt": tst}


def _equal_arrays(got, want):
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _train_state()
    jckpt.save_checkpoint(str(tmp_path), 12, jtree)
    assert latest_step(str(tmp_path)) == 12
    like = {"params": {k: v for k, v in ttree["params"].items()},
            "opt": adamw_init(ttree["params"])}
    out = restore_checkpoint(str(tmp_path), 12, like)
    _equal_arrays([t.numpy() for t in tree_leaves(out)],
                  jax.tree_util.tree_leaves(jtree))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jtree, ttree = _train_state()
    save_checkpoint(str(tmp_path), 12, ttree)
    assert jckpt.latest_step(str(tmp_path)) == 12
    like = {"params": jtree["params"], "opt": jadamw_init(jtree["params"])}
    out = jckpt.restore_checkpoint(str(tmp_path), 12, like)
    _equal_arrays(jax.tree_util.tree_leaves(out),
                  jax.tree_util.tree_leaves(jtree))


def test_bf16_leaves(tmp_path):
    """bf16 leaves are stored as the JAX package stores them, their bits in
    2-byte voids: the port reads its own and the reference's back bit for
    bit; the reference cannot cast them back (its restore raises)."""
    x = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    jtree = {"h": jnp.asarray(x, jnp.bfloat16), "f": jnp.asarray(x)}
    ttree = tensors_from_jax(jax.tree_util.tree_map(np.asarray, jtree),
                             device="cpu")
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jtree)
    save_checkpoint(str(tmp_path / "port"), 1, ttree)
    for d in ("ref", "port"):
        out = restore_checkpoint(str(tmp_path / d), 1, ttree)
        _equal_trees(out, ttree)
        with np.load(tmp_path / d / "step_000000001" / "proc00.npz") as z:
            assert sorted(z[k].dtype.str for k in z.files) == ["<f4", "|V2"]
    with pytest.raises(ValueError):
        jckpt.restore_checkpoint(str(tmp_path / "port"), 1, jtree)
