"""The port's distribution on the CPU: gloo worlds spawned by
``repro_torch.launch.mesh.spawn_world``, a few checks a world to keep the
spawns few, against the port on one rank and the JAX package.

- (2, 2), 4 ranks: eight sharded training steps of smoke llama3.2-1b
  against the port's one-rank ``make_step`` and the reference's
  ``make_step`` outside a mesh (the reference's own sharded train fails on
  this JAX: ``tests/test_distributed.py::test_mesh_and_sharded_train_step``),
  so the sharded step is held at step level; the gradients after one
  step (``Transformer.trainable()``'s views of the local shards), held by
  equality; a leaf sharded on both axes has four distinct shards; the
  sharded prefill of smoke llama3.2-1b and deepseek-moe-16b (expert
  parallel) against the one-rank port and the reference's ``forward``;
  ``mlp_tp`` and ``o_proj_tp`` against ``mlp`` and the einsum;
  ``compressed_allreduce`` against the reference's on a 4-device host
  mesh; a checkpoint saved at (2, 2); gemma3's chunked attention under a
  forced ``score_shard="qseq"`` falling back to the dense path; smoke
  rwkv6-3b, whose 4 heads divide the model axis (below).
- 2 ranks: that checkpoint restored onto ``survivors_mesh``, and read by
  ``repro.checkpoint.restore_checkpoint``; ``train(model_axis=2)`` with
  int8 compression against the one-rank ``train()``.
- (1, 8), 8 ranks: smoke gemma3-4b at a model axis its 4 heads do not
  divide (qseq), dense, chunked and through K3's twin on each rank's own
  query rows, against the one-rank port and the reference; smoke
  recurrentgemma-2b (4 heads over 8: qseq; its LRU width 8 channels a
  rank) and rwkv6-3b (4 heads of 16 channels over 8: half a head a
  rank); K4's and K5's twins on a rank's share, and the RG-LRU and
  RWKV-6 layers with ``use_kernel=True`` on the mesh.
- The recurrent archs, at (1, 8) and rwkv6-3b also at (2, 2): the prefill
  against the one-rank port (logits and last caches, the RWKV-6 state
  value-major) and the reference's ``forward``; two ``make_step`` steps
  against the one-rank port's and the reference's; four steps of
  ``decode_cell`` from zeroed caches against the one-rank
  ``decode_step``.

Tolerances, all f32: the sharded step's losses, grad norms and lrs within
1e-5 relative and its parameters within 1e-6 absolute of the one-rank
port's and the reference's, as ``tests/test_torch_train.py`` holds the
one-rank step (TP and FSDP sum in other orders); prefill logits
within 1e-5 of the one-rank port and 2e-4 of the reference (as
``tests/test_torch_models.py``); ``mlp_tp`` / ``o_proj_tp`` 1e-4 (as
``tests/test_perf_modes.py``); ``compressed_allreduce`` 1e-6 of the
reference's and relative error < 0.05 (``tests/test_distributed.py``);
the recurrent archs' prefill caches and decode logits within 1e-5 of the
one-rank port's; K4's and K5's twins on a rank's share bit-equal to the
whole width's channels (no sum is reordered: each channel's recurrence,
and each value channel's, is its own), and the layers with
``use_kernel=True`` on the mesh within 1e-5 of one rank (the row-parallel
products and the LoRA and ln_x combines sum their partial sums over
'model' in another order).
The ranks' functions are in ``tests/torch_dist_workers.py``.  The
machine with the card has no JAX: there this module skips as a whole."""
import functools
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
from repro.checkpoint import restore_checkpoint as jrestore
from repro.data import synthetic_batch as jax_batch
from repro.launch import train as jtrain
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.models.base import tree_leaves
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from tests import torch_dist_workers as workers
from tests.torch_dist_workers import B, LR, STEPS

ROOT = Path(__file__).resolve().parents[1]
S = 16
RTOL, ATOL = 1e-5, 1e-6


def _np_params(arch, seed=0):
    cfg = jconfigs.get_config(arch, smoke=True)
    jp = jax.jit(functools.partial(jmodels.init_params,
                                   jmodels.model_struct(cfg)))(
        jax.random.PRNGKey(seed))
    return cfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _batches(arch, steps=STEPS, batch=B, seq=S):
    cfg = jconfigs.get_config(arch, smoke=True)
    return [{k: np.asarray(v) for k, v in
             jax_batch(cfg, batch, seq, step=i).items()}
            for i in range(steps)]


# ---------------------------------------------------------------------------
# the (2, 2) world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck22"))
    arches = ("llama3.2-1b", "deepseek-moe-16b", "gemma3-4b", "rwkv6-3b")
    ref = {a: _np_params(a) for a in arches}
    batches = {a: _batches(a) for a in arches}
    trees = {a: ref[a][2] for a in arches}
    res = tmesh.spawn_world(workers.world4, 4, trees, batches, ck, device="cpu")
    return res[0], ref, batches, ck


def test_a_ranks_result_outlives_the_rank():
    """A rank of ``spawn_world`` sends its result pickled by value: read
    only after the rank's process has exited, a tensor in it arrives.
    Put as it is, torch would share the tensor by a file descriptor that
    the rank serves until it exits, and a caller that read it later failed
    (``FileNotFoundError`` in ``rebuild_storage_fd``)."""
    import pickle

    import torch.distributed as dist
    import torch.multiprocessing as mp
    store = dist.TCPStore("localhost", 0, 1, is_master=True,
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=tmesh._rank_main, args=(
        0, workers.arange_result, 1, store.port, "cpu", q, ()))
    proc.start()
    proc.join(timeout=120)
    assert proc.exitcode == 0
    rank, payload = q.get(timeout=30)
    got = pickle.loads(payload)
    assert rank == 0 and got["rank"] == 0
    assert torch.equal(got["t"], torch.arange(1000, dtype=torch.float32))


def test_sharded_train_step_matches_one_rank_and_the_reference(world4):
    out, ref, batches, _ = world4
    cfg, jp, tree = ref["llama3.2-1b"]
    tcfg = tconfigs.get_config("llama3.2-1b", smoke=True)
    model = params_from_jax(tree, tcfg, device="cpu")
    model.trainable()
    tst, jst = adamw_init(model.tree), jadamw_init(jp)
    tstep = ttrain.make_step(tcfg, AdamWConfig(lr=LR), total_steps=STEPS)
    jstep = jtrain.make_step(cfg, JAdamWConfig(lr=LR), total_steps=STEPS)
    for i, b in enumerate(batches["llama3.2-1b"]):
        model, tst, _, tm = tstep(model, tst, None,
                                  {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        jp, jst, _, jm = jstep(jp, jst, None,
                               {k: jnp.asarray(v) for k, v in b.items()})
        got = out["rows"][i]
        np.testing.assert_allclose(
            got, [tm[k].item() for k in ("loss", "grad_norm", "lr")],
            rtol=RTOL)
        np.testing.assert_allclose(
            got, [float(jm[k]) for k in ("loss", "grad_norm", "lr")],
            rtol=RTOL)
        if i == 0:
            # the sharded gradients (views of the local shards that
            # trainable() gave the modules) equal the one-rank ones
            for a, w in zip(out["grads"], tree_leaves(model.grads),
                            strict=True):
                np.testing.assert_allclose(a, w.numpy(), rtol=0, atol=ATOL)
    for a, w, j in zip(out["params"], tree_leaves(model.tree),
                       jax.tree_util.tree_leaves(jp), strict=True):
        np.testing.assert_allclose(a, w.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(a, np.asarray(j), rtol=0, atol=ATOL)
    losses = [r[0] for r in out["rows"]]
    assert losses[-1] < losses[0]
    assert out["wq_placements"] == "(Shard(dim=1), Shard(dim=2))"
    assert out["wq_distinct_shards"] == 4


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_sharded_prefill_matches_one_rank_and_the_reference(world4, arch):
    out, ref, batches, _ = world4
    cfg, jp, tree = ref[arch]
    tcfg = tconfigs.get_config(arch, smoke=True)
    toks = batches[arch][0]["tokens"]
    from repro_torch.launch.steps import prefill
    want, caches = prefill(params_from_jax(tree, tcfg, device="cpu"), tcfg,
                           {"tokens": torch.from_numpy(toks)})
    got = out[f"{arch} logits"][..., :cfg.vocab_size]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
    jl = np.asarray(jmodels.forward(jp, cfg, {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(got, jl, rtol=0, atol=2e-4)
    np.testing.assert_allclose(out[f"{arch} k"], caches[-1]["0"]["k"].numpy(),
                               rtol=0, atol=1e-5)
    # the kv pin: caches split on the batch over 'data' and kv heads over
    # 'model' ([L, B, S, K, hd])
    assert out[f"{arch} k placements"] == "(Shard(dim=1), Shard(dim=3))"


def test_chunked_guard_falls_back_under_forced_qseq(world4):
    """As ``tests/test_perf_modes.py::
    test_chunked_guard_falls_back_for_indivisible_heads``: under a mesh
    with ``score_shard="qseq"`` the chunked path takes the dense one."""
    out, ref, batches, _ = world4
    assert np.array_equal(out["qseq dense"], out["qseq chunked"])
    cfg, _, tree = ref["gemma3-4b"]
    tcfg = tconfigs.get_config("gemma3-4b", smoke=True)
    from repro_torch.launch.steps import prefill
    want, _ = prefill(params_from_jax(tree, tcfg, device="cpu"), tcfg,
                      {"tokens": torch.from_numpy(
                          batches["gemma3-4b"][0]["tokens"])})
    np.testing.assert_allclose(out["qseq dense"][..., :cfg.vocab_size],
                               want.numpy(), rtol=0, atol=1e-5)


def test_shard_map_blocks_match_the_dense_products(world4):
    out = world4[0]
    assert out["mlp_tp_err"] < 1e-4
    assert out["o_proj_tp_err"] < 1e-4


def test_compressed_allreduce_matches_the_reference(world4, tmp_path):
    out = world4[0]
    path = tmp_path / "ref.npy"
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, numpy as np
        from repro.runtime import compressed_allreduce
        x = np.random.default_rng(0).standard_normal(4099).astype(np.float32)
        mesh = jax.make_mesh((4,), ("data",))
        np.save({str(path)!r}, np.asarray(compressed_allreduce(
            jax.numpy.asarray(x), mesh, axis="data")))
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = np.load(path)
    got = out["compressed"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    x = np.random.default_rng(0).standard_normal(4099).astype(np.float32)
    assert np.abs(got - 4 * x).max() / np.abs(4 * x).max() < 0.05


def test_sharded_checkpoint_reads_in_the_reference(world4):
    """The (2, 2) checkpoint's per-shard tags reassemble in the JAX
    package's ``restore_checkpoint``."""
    _, ref, _, ck = world4
    _, jp, tree = ref["llama3.2-1b"]
    got = jrestore(ck, 1, jp)
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(tree),
                    strict=True):
        assert np.array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# the survivors: 2 ranks
# ---------------------------------------------------------------------------

def test_restore_onto_survivors_and_train_on_a_model_axis(world4, tmp_path):
    _, ref, _, ck = world4
    tree = ref["llama3.2-1b"][2]
    out = tmesh.spawn_world(workers.world2, 2, ck, tree, str(tmp_path / "t"),
                            device="cpu")[0]
    assert out["mesh"] == [1, 2] and all(out["placed"])
    for a, b in zip(out["leaves"], tree_leaves(tree), strict=True):
        assert np.array_equal(a, b)
    one = ttrain.train("llama3.2-1b", smoke=True, steps=6, batch=4, seq=32,
                       compress=True, lr=1e-2, log_every=1000, device="cpu")
    np.testing.assert_allclose(out["losses"], one["losses"], rtol=RTOL)
    for a, b in zip(out["train_params"], tree_leaves(one["params"]),
                    strict=True):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-5)
    from repro_torch.checkpoint import latest_step
    assert latest_step(str(tmp_path / "t")) == 6
    with pytest.raises(ValueError, match="model-parallel group"):
        from repro_torch.runtime import survivors_mesh
        survivors_mesh([0], ("data", "model"), 2, device="cpu")


# ---------------------------------------------------------------------------
# gemma3 at (1, 8): its 4 heads do not divide the model axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world8():
    arches = ("gemma3-4b", "recurrentgemma-2b", "rwkv6-3b")
    ref = {a: _np_params(a) for a in arches}
    cfg, jp, tree = ref["gemma3-4b"]
    toks = np.asarray(jax_batch(cfg, 2, 24)["tokens"])
    batches = {a: _batches(a) for a in arches[1:]}
    out = tmesh.spawn_world(workers.world8, 8, {a: ref[a][2] for a in arches},
                            toks, batches, device="cpu")[0]
    return out, cfg, jp, tree, toks, ref, batches


def test_qseq_prefill_where_heads_do_not_divide(world8):
    out, cfg, jp, tree, toks = world8[:5]
    assert (out["score_shard"], out["kv_shard"]) == ("qseq", "hd")
    # head_dim carries the model axis where the heads cannot
    assert out["wq"] == "(Shard(dim=1), Shard(dim=3))"
    assert out["k"] == "(Shard(dim=1), Shard(dim=4))"
    assert np.array_equal(out["dense"], out["chunked"])
    tcfg = tconfigs.get_config("gemma3-4b", smoke=True)
    from repro_torch.launch.steps import prefill
    want, _ = prefill(params_from_jax(tree, tcfg, device="cpu"), tcfg,
                      {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(out["dense"][..., :cfg.vocab_size],
                               want.numpy(), rtol=0, atol=1e-5)
    jl = np.asarray(jmodels.forward(jp, cfg, {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(out["dense"][..., :cfg.vocab_size], jl,
                               rtol=0, atol=2e-4)


def test_flash_on_each_ranks_query_rows(world8):
    """K3 (its twin on the CPU) on each rank's own query rows at their
    offset, under qseq: the fixture's dense qseq prefill and the
    reference's logits."""
    out, cfg, jp, tree, toks = world8[:5]
    np.testing.assert_allclose(out["flash"], out["dense"], rtol=0, atol=1e-5)
    jl = np.asarray(jmodels.forward(jp, cfg, {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(out["flash"][..., :cfg.vocab_size], jl,
                               rtol=0, atol=2e-4)


# (arch, mesh): recurrentgemma-2b's 4 heads and 64 LRU channels over 8;
# rwkv6-3b's 4 heads of 16 over 8 (half a head a rank) and over 2
RECURRENT = [("recurrentgemma-2b", "1x8"), ("rwkv6-3b", "1x8"),
             ("rwkv6-3b", "2x2")]


def _recurrent(request, arch, mesh):
    """(the rank 0 record of ``arch`` on ``mesh``, (cfg, JAX params, numpy
    leaves), the batches)."""
    if mesh == "2x2":
        out, ref, batches, _ = request.getfixturevalue("world4")
    else:
        out, *_, ref, batches = request.getfixturevalue("world8")
    return out[arch], ref[arch], batches[arch]


def _value_major(wkv):
    """A one-rank RWKV-6 state [.., H, hd, hd] value-major, [.., hd, d]."""
    *lead, H, hd, _ = wkv.shape
    return np.swapaxes(wkv, -3, -2).reshape(*lead, hd, H * hd)


@pytest.mark.parametrize("arch,mesh", RECURRENT)
def test_recurrent_prefill_on_a_mesh(request, arch, mesh):
    run, (cfg, jp, tree), batches = _recurrent(request, arch, mesh)
    tcfg = tconfigs.get_config(arch, smoke=True)
    toks = batches[0]["tokens"]
    from repro_torch.launch.steps import prefill
    want, caches = prefill(params_from_jax(tree, tcfg, device="cpu"), tcfg,
                           {"tokens": torch.from_numpy(toks)})
    got = run["prefill"][..., :cfg.vocab_size]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
    jl = np.asarray(jmodels.forward(jp, cfg, {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(got, jl, rtol=0, atol=2e-4)
    if mesh == "1x8":
        assert run["score_shard"] == "qseq"
    for name, t in caches[-1]["0"].items():
        w = t.numpy()
        if name == "wkv":
            w = _value_major(w)
        np.testing.assert_allclose(run["caches"][name], w, rtol=0,
                                   atol=1e-5, err_msg=name)
        # the states' channels (the last dimension) split over 'model'
        dim = run["caches"][name].ndim - 1
        assert run["cache placements"][name].endswith(
            f"Shard(dim={dim}))"), (name, run["cache placements"])


@pytest.mark.parametrize("arch,mesh", RECURRENT)
def test_recurrent_train_steps_on_a_mesh(request, arch, mesh):
    run, (cfg, jp, tree), batches = _recurrent(request, arch, mesh)
    tcfg = tconfigs.get_config(arch, smoke=True)
    model = params_from_jax(tree, tcfg, device="cpu")
    model.trainable()
    tst, jst = adamw_init(model.tree), jadamw_init(jp)
    tstep = ttrain.make_step(tcfg, AdamWConfig(lr=LR), total_steps=2)
    jstep = jtrain.make_step(cfg, JAdamWConfig(lr=LR), total_steps=2)
    for i, b in enumerate(batches[:2]):
        model, tst, _, tm = tstep(model, tst, None,
                                  {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        jp, jst, _, jm = jstep(jp, jst, None,
                               {k: jnp.asarray(v) for k, v in b.items()})
        np.testing.assert_allclose(
            run["rows"][i], [tm[k].item() for k in ("loss", "grad_norm",
                                                    "lr")], rtol=RTOL)
        np.testing.assert_allclose(
            run["rows"][i], [float(jm[k]) for k in ("loss", "grad_norm",
                                                    "lr")], rtol=RTOL)
    assert run["rows"][1][2] > 0          # the second step moves the weights
    for a, w, j in zip(run["params"], tree_leaves(model.tree),
                       jax.tree_util.tree_leaves(jp), strict=True):
        np.testing.assert_allclose(a, w.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(a, np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch,mesh", RECURRENT)
def test_recurrent_decode_on_a_mesh(request, arch, mesh):
    run, (cfg, jp, tree), batches = _recurrent(request, arch, mesh)
    tcfg = tconfigs.get_config(arch, smoke=True)
    from repro_torch import models as tmodels
    model = params_from_jax(tree, tcfg, device="cpu")
    toks = torch.from_numpy(batches[0]["tokens"])
    caches = tmodels.init_params(tmodels.cache_struct(
        tcfg, toks.shape[0], workers.DECODE_LEN), None, device="cpu")
    for pos in range(workers.DECODE_STEPS):
        with torch.inference_mode():
            want, caches = tmodels.decode_step(model, tcfg, caches,
                                               toks[:, pos:pos + 1], pos)
        np.testing.assert_allclose(run["decode"][pos][..., :cfg.vocab_size],
                                   want.numpy(), rtol=0, atol=1e-5)


def test_k4_k5_on_a_ranks_share(world8):
    """K4's and K5's twins on a rank's channels (K5: the heads they touch,
    v zero outside them) equal the whole width's, bit for bit; the RG-LRU
    and RWKV-6 layers with ``use_kernel=True`` on the mesh equal the
    one-rank layer within 1e-5."""
    ks = world8[0]["kernel shares"]
    assert ks["k4 share bit-equal"] and ks["k5 share bit-equal"]
    for arch in ("recurrentgemma-2b", "rwkv6-3b"):
        assert ks[arch]["out_err"] <= 1e-5 * max(1.0, ks[arch]["out_max"]), \
            ks[arch]
        assert ks[arch]["state_err"] <= 1e-5, ks[arch]
