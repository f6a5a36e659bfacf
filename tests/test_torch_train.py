"""The port's training loop against the JAX package's, on the CPU: five
``make_step`` steps against the reference's ``make_step`` without a mesh
(its ``train()`` fails under ``make_host_mesh`` on this JAX: ROADMAP.md,
queue 3), ``train()``'s failure, resume and checkpoints, its refusals,
the kernels' refusal of autograd, and the ``train_lm`` example
(``test_torch_loss.py`` holds ``loss_fn`` and its gradients).

Tolerances: the trajectories' losses, grad norms and lrs within 1e-5
relative, parameters, moments and error state within 1e-6 absolute
(observed <= 2e-7); the resume bit for bit, tighter than the reference's
own test (``tests/test_runtime.py``: 1e-4 on the loss, 2e-3 / 2e-4 on the
parameters).  The machine with the card has no JAX: there this module
skips as a whole."""
import functools
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
from repro.data import synthetic_batch as jax_batch
from repro.launch import train as jtrain
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.checkpoint import latest_step
from repro_torch.data import synthetic_batch
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models.base import tree_leaves
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The smoke models are small: one torch thread a test worker, so that
    the runner's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_model(arch, seed=0):
    """The smoke config and a model on the port's own random weights."""
    tcfg = tconfigs.get_config(arch, smoke=True)
    params = tmodels.init_params(tmodels.model_struct(tcfg),
                                 torch.Generator().manual_seed(seed),
                                 device="cpu")
    return tcfg, tmodels.Transformer(tcfg, params)


def _smoke(arch, seed=0):
    cfg = jconfigs.get_config(arch, smoke=True)
    jp = jax.jit(functools.partial(jmodels.init_params,
                                   jmodels.model_struct(cfg)))(
        jax.random.PRNGKey(seed))
    tcfg = tconfigs.get_config(arch, smoke=True)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                            device="cpu")
    return cfg, jp, tcfg, model


def _batches(cfg, tcfg, batch=B, seq=S, step=0):
    seq += cfg.n_patches if cfg.frontend == "vision_stub" else 0
    return ({k: jnp.asarray(v)
             for k, v in jax_batch(cfg, batch, seq, step=step).items()},
            {k: torch.from_numpy(v)
             for k, v in synthetic_batch(tcfg, batch, seq, step=step).items()})


@pytest.mark.parametrize("compress", [False, True])
def test_make_step_trajectory_matches_jax(compress):
    """Five steps of llama3.2-1b's smoke config, batch 2 x 32, from the same
    parameters, against ``repro.launch.train.make_step`` outside a mesh."""
    cfg, jp, tcfg, model = _smoke("llama3.2-1b")
    jst, tst = jadamw_init(jp), adamw_init(model.tree)
    jerr = (jax.tree_util.tree_map(lambda p: jnp.zeros_like(p, jnp.float32),
                                   jp) if compress else None)
    terr = None
    jstep = jtrain.make_step(cfg, JAdamWConfig(lr=3e-3), total_steps=5,
                             compress=compress)
    tstep = ttrain.make_step(tcfg, AdamWConfig(lr=3e-3), total_steps=5,
                             compress=compress)
    for i in range(5):
        jb, tb = _batches(cfg, tcfg, 2, 32, step=i)
        jp, jst, jerr, jm = jstep(jp, jst, jerr, jb)
        model, tst, terr, tm = tstep(model, tst, terr, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=RTOL)
    for got, want in ((model.tree, jp), (tst["m"], jst["m"]),
                      (tst["v"], jst["v"])):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                        strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 5
    if compress:
        for a, b in zip(tree_leaves(terr), jax.tree_util.tree_leaves(jerr),
                        strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def test_train_restart_resume(tmp_path, capsys):
    """Kill at step 18, resume from the last checkpoint (16), reach the
    uninterrupted run's state: on the CPU bit for bit."""
    kw = dict(smoke=True, steps=24, batch=4, seq=32, ckpt_every=8, lr=1e-3,
              log_every=8, device="cpu")
    full = ttrain.train("llama3.2-1b", ckpt_dir=None, **kw)
    assert "[train] step     8 loss" in capsys.readouterr().out
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure"):
        ttrain.train("llama3.2-1b", ckpt_dir=ck, fail_at_step=18, **kw)
    assert latest_step(ck) == 16
    resumed = ttrain.train("llama3.2-1b", ckpt_dir=ck, resume=True, **kw)
    assert "resumed from step 16" in capsys.readouterr().out
    assert len(resumed["losses"]) == 8 and latest_step(ck) == 24
    assert resumed["losses"][-1] == full["losses"][-1]
    for a, b in zip(tree_leaves(full["params"]),
                    tree_leaves(resumed["params"]), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(full["opt_state"]),
                    tree_leaves(resumed["opt_state"]), strict=True):
        assert torch.equal(a, b)


def test_train_with_compression_runs():
    res = ttrain.train("llama3.2-1b", smoke=True, steps=6, batch=2, seq=32,
                       compress=True, log_every=1000, device="cpu")
    assert len(res["losses"]) == 6 and np.isfinite(res["losses"]).all()


def test_train_refusals():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train("llama3.2-1b", steps=1)
    # a model axis of 2 needs a world it divides; this process is a world
    # of one, and the refusal starts no process group
    # (tests/test_torch_distributed.py trains with model_axis=2 on 2 ranks)
    import torch.distributed as dist
    with pytest.raises(AssertionError, match=r"\(1, 2\)"):
        ttrain.train("llama3.2-1b", steps=1, model_axis=2, device="cpu")
    assert not dist.is_initialized()


def test_kernels_refuse_autograd():
    """No kernel has a backward pass (nor has any in the JAX package), so
    their wrappers refuse inputs that require grad while grad mode is on,
    and training through ``attn_impl="flash"`` raises; without grad they
    run as before."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    a, b = (torch.rand(1, 8, 4, generator=g) for _ in range(2))
    r, kk, vv, w = (torch.rand(1, 8, 2, 4, generator=g) for _ in range(4))
    u = torch.rand(2, 4, generator=g)
    calls = {"flash_attention": (ops.flash_attention, (q, k, v)),
             "rglru_scan": (ops.rglru_scan, (a, b)),
             "rwkv6_scan": (ops.rwkv6_scan, (r, kk, vv, w, u))}
    for name, (fn, args) in calls.items():
        fn(*args)
        for i in range(len(args)):
            grad_args = [t.clone().requires_grad_(j == i)
                         for j, t in enumerate(args)]
            with pytest.raises(RuntimeError, match=f"ops.{name} has no "
                                                   "backward"):
                fn(*grad_args)
            with torch.no_grad():
                fn(*grad_args)
    tcfg, model = port_model("llama3.2-1b")
    model.trainable()
    tb = {k: torch.from_numpy(v)
          for k, v in synthetic_batch(tcfg, B, S).items()}
    with pytest.raises(RuntimeError, match="no backward"):
        tmodels.loss_fn(model, tcfg.replace(attn_impl="flash"), tb)


def test_serving_builds_no_graph():
    """``trainable`` is the one way in: a fresh model's parameters are
    frozen, so a forward builds no graph."""
    tcfg, model = port_model("llama3.2-1b")
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.zeros(1, 4, dtype=torch.int32)
    logits, _, _ = tmodels.forward(model, tcfg, {"tokens": tokens})
    assert logits.grad_fn is None
    model.trainable()
    assert all(p.requires_grad for p in model.parameters())


def test_train_lm_example_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_lm", "--device",
         "cpu", "--steps", "30", "--batch", "2", "--seq", "64"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[example] model: 16.1M params (6L d=384)" in res.stdout
    assert "[train] step    30 loss" in res.stdout
    assert "over 30 steps" in res.stdout
