"""The port's llama3.2-1b against the JAX package at smoke size: configs,
parameter counts, forward (reference and flash attention), prefill caches,
decode step by step, and the serve loop's tokens.

The weights are drawn by the JAX package and handed over as numpy arrays
(``params_from_jax``); token inputs come from numpy with a fixed seed.
Tolerance 2e-4 is that of the JAX package's own flash-vs-reference model
test (``tests/test_kernels.py``).  The machine with the card has no JAX:
there this module skips as a whole."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import serve as jserve
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.device import resolve
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models.convert import params_from_jax, tensors_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _smoke(seed=0):
    cfg = jconfigs.get_config("llama3.2-1b", smoke=True)
    jparams = jmodels.init_params(jmodels.model_struct(cfg),
                                  jax.random.PRNGKey(seed))
    tcfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    return cfg, jparams, tcfg, params_from_jax(_np_tree(jparams), tcfg,
                                               device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [n for n in sys.modules\n"
        "       if n.split('.')[0] in ('jax', 'jaxlib', 'repro', 'networkx')]\n"
        "print(len(names), bad, *names)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 85, res.stdout
    # the service's modules, the benchmarks, the quickstart and the MoE
    # layer and configs are among those imported
    for name in ("service.core", "service.coalescer", "service.procpool",
                 "engine.compile_cache", "benchmarks.bench_service",
                 "launch.serve", "benchmarks.bench_control_flow",
                 "benchmarks.bench_sm", "benchmarks.bench_timing",
                 "benchmarks.bench_kernels", "benchmarks.run",
                 "examples.quickstart", "models.moe",
                 "configs.deepseek_moe_16b", "configs.mixtral_8x7b"):
        assert f"repro_torch.{name}" in res.stdout.split(), name


@pytest.mark.parametrize("smoke", [True, False])
def test_config_and_param_count_equal_jax(smoke):
    jcfg = jconfigs.get_config("llama3.2-1b", smoke=smoke)
    tcfg = tconfigs.get_config("llama3.2-1b", smoke=smoke)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for prop in ("hd", "padded_vocab", "kinds", "layers_in_plan"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop)
    assert tmodels.param_count(tmodels.model_struct(tcfg)) \
        == jmodels.param_count(jmodels.model_struct(jcfg))
    if not smoke:
        assert tmodels.param_count(tmodels.model_struct(tcfg)) \
            == 1_235_814_400


def test_unported_parts_say_where_they_stand(capsys):
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 9"):
        tconfigs.get_config("gemma3-4b")
    # MoE layers, which once raised naming item 8, are ported: their check
    # is tests/test_torch_moe.py::test_moe_layers_build_as_jax
    # the serve mode that once raised naming item 5 runs now
    tserve.main(["--mode", "sim", "--device", "cpu", "--batch", "2"])
    assert "2 ok / 0 failed" in capsys.readouterr().out


def test_init_params_std_rule():
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    p = tmodels.init_params(tmodels.model_struct(cfg), gen, device="cpu")
    wq = p["segments"][0]["0"]["attn"]["wq"]
    assert wq.shape == (2, 64, 8, 8) and wq.dtype == torch.float32
    assert abs(wq.std().item() - 0.02) < 2e-3
    assert torch.equal(p["final_norm"]["scale"], torch.ones(64))
    bf = tmodels.init_params(tmodels.model_struct(cfg),
                             torch.Generator().manual_seed(0),
                             dtype=torch.bfloat16, device="cpu")
    assert bf["embed"]["tok"].dtype == torch.bfloat16


def test_init_params_draws_each_leaf_as_before():
    # the leaves are scaled in place (one f32 copy of a leaf at a time):
    # the values are those of randn(...) * std, cast, bit for bit
    struct = {"w": tmodels.P((6, 5, 4), ("a", "b", "c")),
              "r": tmodels.P((5, 3), ("a", "b"), scale=0.5)}
    for dtype in (torch.float32, torch.bfloat16):
        got = tmodels.init_params(struct, torch.Generator().manual_seed(1),
                                  dtype=dtype, device="cpu")
        gen = torch.Generator().manual_seed(1)
        for name, std in (("r", 0.5), ("w", min(0.02, 6 ** -0.5))):
            want = (torch.randn(struct[name].shape, generator=gen) * std) \
                .to(dtype)
            assert torch.equal(got[name], want), (name, dtype)


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_matches_jax(attn_impl):
    cfg, jparams, tcfg, model = _smoke()
    toks = _tokens(cfg, 2, 32)
    want, _, _ = jmodels.forward(jparams, cfg.replace(attn_impl=attn_impl),
                                 {"tokens": jnp.asarray(toks)})
    before = tops.flash_attention.launches
    got, _, _ = tmodels.forward(model, tcfg.replace(attn_impl=attn_impl),
                                {"tokens": torch.from_numpy(toks)})
    assert tops.flash_attention.launches == before   # CPU: plain path only
    assert got.shape == (2, 32, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_prefill_caches_match_jax():
    cfg, jparams, tcfg, model = _smoke(1)
    toks = _tokens(cfg, 2, 24, seed=1)
    cfg_f = cfg.replace(attn_impl="flash")
    want_logits, _, want_caches = jmodels.forward(
        jparams, cfg_f, {"tokens": jnp.asarray(toks)}, return_cache=True)
    logits, caches = tsteps.prefill(model, tcfg.replace(attn_impl="flash"),
                                    {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    assert len(caches) == len(want_caches) == 1
    for name in ("k", "v"):
        got = caches[0]["0"][name]
        assert got.shape == (2, 2, 24, 2, 8)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want_caches[0]["0"][name]),
                                   rtol=TOL, atol=TOL)


def test_prefill_config_is_prefill_cells():
    cfg = tsteps.prefill_config("llama3.2-1b", attn_impl="flash")
    assert cfg.attn_dtype == "bf16" and cfg.attn_impl == "flash"
    assert cfg.d_model == 2048 and cfg.n_layers == 16


def test_decode_step_matches_jax_step_by_step():
    cfg, jparams, tcfg, model = _smoke(2)
    B, max_len, n = 2, 8, 10          # n > max_len: the ring buffer wraps
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
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tcaches[0]["0"][name].numpy(),
                                   np.asarray(jcaches[0]["0"][name]),
                                   rtol=TOL, atol=TOL)


def test_serve_emits_jax_tokens():
    kw = dict(smoke=True, batch=2, prompt_len=8, gen_len=8, max_len=64,
              seed=3)
    want = jserve.serve("llama3.2-1b", **kw)
    cfg = jconfigs.get_config("llama3.2-1b", smoke=True)
    jparams = jmodels.init_params(jmodels.model_struct(cfg),
                                  jax.random.PRNGKey(3))
    model = params_from_jax(_np_tree(jparams),
                            tconfigs.get_config("llama3.2-1b", smoke=True),
                            device="cpu")
    got = tserve.serve("llama3.2-1b", params=model, device="cpu", **kw)
    assert got["generated"].dtype == np.int32
    assert got["steps"] == want["steps"]
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_tensors_from_jax_keeps_bf16():
    a = jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32), jnp.bfloat16)
    t = tensors_from_jax({"a": np.asarray(a)}, device="cpu")["a"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    with pytest.raises(RuntimeError, match="GPU"):
        resolve(None)
    with pytest.raises(RuntimeError, match="GPU"):
        tserve.serve("llama3.2-1b", batch=1, prompt_len=2, gen_len=1)
    with pytest.raises(RuntimeError, match="GPU"):
        tmodels.init_params(tmodels.model_struct(cfg),
                            torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="GPU"):
        params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        tserve.main(["--batch", "1"])

