"""The port's architecture registry against the JAX package's, and the five
configs it gained last (gemma3-4b, minitron-4b, internlm2-20b and the
frontend models hubert-xlarge and internvl2-2b) at smoke size: configs and
parameter counts of all ten (structures only, nothing allocated at full
size), the shape cells, forward logits through both attention paths, the
serve loop's tokens, and ``serve``'s refusal of the models that are not
token decoders.

The weights are drawn by the JAX package and handed over as numpy arrays
(``params_from_jax``); the batches come from each package's
``synthetic_batch`` as ``tests/test_arch_smoke.py`` builds them.  Tolerance
2e-4 is that of the JAX package's own flash-vs-reference model test
(``tests/test_kernels.py``).  The machine with the card has no JAX: there
this module skips as a whole."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs
from repro import models as jmodels
from repro.data import synthetic_batch as jax_batch
from repro.launch import serve as jserve
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.data import synthetic_batch
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_jax
from tests.config_parity import assert_config_equal_jax

TOL = 2e-4
B, S = 2, 16
NEW = ("gemma3-4b", "minitron-4b", "internlm2-20b", "hubert-xlarge",
       "internvl2-2b")
TOKEN_DECODERS = ("gemma3-4b", "minitron-4b", "internlm2-20b")
FRONTENDS = ("hubert-xlarge", "internvl2-2b")


def _smoke(arch, seed=0):
    cfg = jconfigs.get_config(arch, smoke=True)
    jparams = jmodels.init_params(jmodels.model_struct(cfg),
                                  jax.random.PRNGKey(seed))
    tcfg = tconfigs.get_config(arch, smoke=True)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            tcfg, device="cpu")
    return cfg, jparams, tcfg, model


def _batches(cfg, tcfg, step=0):
    """The same batch for both packages: each from its own
    ``synthetic_batch``, with ``S`` text positions after the patches."""
    seq = S + (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    want = jax_batch(cfg, B, seq, step=step)
    got = synthetic_batch(tcfg, B, seq, step=step)
    return ({k: jnp.asarray(v) for k, v in want.items()},
            {k: torch.from_numpy(v) for k, v in got.items()})


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_config_and_param_count_equal_jax(arch, smoke):
    jcfg = jconfigs.get_config(arch, smoke=smoke)
    tcfg = tconfigs.get_config(arch, smoke=smoke)
    assert_config_equal_jax(tcfg, jcfg)
    for prop in ("hd", "padded_vocab", "kinds", "layers_in_plan",
                 "is_decoder"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop)
    assert tmodels.param_count(tmodels.model_struct(tcfg)) \
        == jmodels.param_count(jmodels.model_struct(jcfg))


def test_registry_and_cells_equal_jax():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {n: dataclasses.asdict(s) for n, s in tconfigs.SHAPES.items()} \
        == {n: dataclasses.asdict(s) for n, s in jconfigs.SHAPES.items()}
    for arch in jconfigs.ARCH_NAMES:
        for shape in jconfigs.SHAPES:
            assert tconfigs.cell_status(arch, shape) \
                == jconfigs.cell_status(arch, shape), (arch, shape)
    assert tconfigs.run_cells() == jconfigs.run_cells()
    assert tconfigs.skipped_cells() == jconfigs.skipped_cells()
    assert len(tconfigs.run_cells()) + len(tconfigs.skipped_cells()) == 40
    with pytest.raises(KeyError, match="unknown architecture"):
        tconfigs.get_config("gpt-2")
    # the port's own architectures resolve beside the registry, outside it
    assert tconfigs.PORT_ARCH_NAMES == ("moonlight-16b-a3b",)
    assert not set(tconfigs.PORT_ARCH_NAMES) & set(jconfigs.ARCH_NAMES)
    for arch in tconfigs.PORT_ARCH_NAMES:
        assert tconfigs.get_config(arch).name == arch


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", NEW)
def test_forward_matches_jax(arch, attn_impl):
    cfg, jparams, tcfg, model = _smoke(arch)
    jbatch, tbatch = _batches(cfg, tcfg)
    want, _, _ = jmodels.forward(jparams, cfg.replace(attn_impl=attn_impl),
                                 jbatch)
    before = tops.flash_attention.launches
    got, _, _ = tmodels.forward(model, tcfg.replace(attn_impl=attn_impl),
                                tbatch)
    assert tops.flash_attention.launches == before   # CPU: plain path only
    seq = S + (cfg.n_patches if cfg.frontend == "vision_stub" else 0)
    assert got.shape == (B, seq, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_prefill_takes_the_frontends_batches(arch):
    """``prefill`` passes ``frames`` / ``patches`` through; an encoder
    returns no caches, internvl2-2b one k/v pair a layer over the patches
    and the tokens."""
    cfg, jparams, tcfg, model = _smoke(arch, seed=1)
    jbatch, tbatch = _batches(cfg, tcfg, step=1)
    pcfg = tcfg.replace(attn_impl="flash")
    logits, caches = tsteps.prefill(model, pcfg, tbatch)
    want, _, _ = jmodels.forward(jparams, cfg.replace(attn_impl="flash"),
                                 jbatch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if arch == "hubert-xlarge":
        assert caches is None
    else:
        assert caches[0]["0"]["k"].shape == (
            cfg.n_layers, B, cfg.n_patches + S, cfg.n_kv_heads, cfg.hd)


def test_audio_frames_set_the_activation_dtype():
    """hubert-xlarge on bf16 weights fed f32 frames runs its layers in f32
    in both packages (the frames' dtype wins the embedding product)."""
    cfg, jparams, tcfg, _ = _smoke("hubert-xlarge", seed=2)
    jbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jbf), tcfg,
                            device="cpu")
    assert model.embed.frontend_proj.dtype == torch.bfloat16
    jbatch, tbatch = _batches(cfg, tcfg, step=2)
    assert tbatch["frames"].dtype == torch.float32
    want, _, _ = jmodels.forward(jbf, cfg, jbatch)
    got, _, _ = tmodels.forward(model, tcfg, tbatch)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_params_from_jax_carries_frontend_proj(arch):
    cfg, jparams, tcfg, model = _smoke(arch, seed=3)
    want = np.asarray(jparams["embed"]["frontend_proj"])
    assert want.shape == (cfg.frontend_dim, cfg.d_model)
    np.testing.assert_array_equal(model.embed.frontend_proj.numpy(), want)
    assert sum(p.numel() for p in model.parameters()) \
        == jmodels.param_count(jmodels.model_struct(cfg))


@pytest.mark.parametrize("arch", TOKEN_DECODERS)
def test_serve_emits_jax_tokens(arch):
    kw = dict(smoke=True, batch=2, prompt_len=6, gen_len=6, max_len=32,
              seed=3)
    want = jserve.serve(arch, **kw)
    cfg = jconfigs.get_config(arch, smoke=True)
    jparams = jmodels.init_params(jmodels.model_struct(cfg),
                                  jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                            tconfigs.get_config(arch, smoke=True),
                            device="cpu")
    got = tserve.serve(arch, params=model, device="cpu", **kw)
    assert got["steps"] == want["steps"]
    np.testing.assert_array_equal(got["generated"], want["generated"])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_serve_refuses_what_is_not_a_token_decoder(arch, monkeypatch):
    kw = dict(smoke=True, batch=1, prompt_len=2, gen_len=1)
    with pytest.raises(AssertionError, match="not a token decoder"):
        jserve.serve(arch, **kw)

    def drawn(*args, **kwargs):
        raise RuntimeError("serve drew weights before refusing")

    monkeypatch.setattr(tserve, "init_params", drawn)
    with pytest.raises(AssertionError, match="not a token decoder"):
        tserve.serve(arch, device="cpu", **kw)
    # refused before the device is resolved, as on a machine with no card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(AssertionError, match="not a token decoder"):
        tserve.serve(arch, **kw)
