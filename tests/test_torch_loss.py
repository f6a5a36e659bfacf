"""The port's training loss against the JAX package's, on the CPU:
``loss_fn``'s loss and every gradient for all ten smoke configs, from the
JAX package's parameters carried over with ``params_from_jax``, on each
package's ``synthetic_batch``; and activation checkpointing.

Tolerances: the loss, ce and aux within 1e-5 relative, each gradient
leaf within 1e-5 of its largest entry (f32 sums in other orders; observed
<= 1e-6); checkpointing bit for bit.  The machine with the card has no
JAX: there this module skips as a whole."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs
from repro import models as jmodels
from repro_torch import models as tmodels
from repro_torch.data import synthetic_batch
from repro_torch.models.base import tree_leaves

from tests.test_torch_train import (B, S, _batches, _smoke,  # noqa: E402
                                    port_model)
from tests.test_torch_train import one_thread  # noqa: E402,F401 (autouse)

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5


def _port_loss_and_grads(model, tcfg, tb):
    grads = model.trainable()
    for g in tree_leaves(grads):
        g.zero_()
    loss, aux = tmodels.loss_fn(model, tcfg, tb)
    loss.backward()
    return loss.detach(), aux, [g.clone() for g in tree_leaves(grads)]


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_loss_and_grads_match_jax(arch):
    cfg, jp, tcfg, model = _smoke(arch)
    jb, tb = _batches(cfg, tcfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodels.loss_fn(p, cfg, jb), has_aux=True))(jp)
    loss, aux, grads = _port_loss_and_grads(model, tcfg, tb)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves)
    for got, want in zip(grads, jleaves):
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
    if arch == "hubert-xlarge":
        # the audio frontend never reads the token table: zeros in both,
        # and AdamW still decays it
        tok = tree_leaves(model.grads["embed"]["tok"])[0]
        assert not tok.any()
        assert not np.asarray(jg["embed"]["tok"]).any()


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b",
                                  "deepseek-moe-16b", "rwkv6-3b"])
def test_remat_equals_none(arch, remat):
    """Checkpointing recomputes the same numbers: the loss and every
    gradient are those without it, bit for bit."""
    tcfg, model = port_model(arch)
    tb = {k: torch.from_numpy(v)
          for k, v in synthetic_batch(tcfg, B, S).items()}
    want = _port_loss_and_grads(model, tcfg, tb)
    got = _port_loss_and_grads(model, tcfg.replace(remat=remat), tb)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


