"""The port's dry run (``repro_torch.launch.dryrun``, ``hlo_static``,
``hlo_analysis``) and roofline table against the JAX package's.

- ``model_flops`` equal to the reference's for all 10 archs x 4 shapes.
- Rank 0's FLOPs at (16, 16) for llama3.2-1b ``train_4k`` (remat
  "full") and ``prefill_32k``, minitron-4b ``train_4k`` (its heads do
  not divide the model axis: qseq), and the recurrent archs' ``train_4k``
  (recurrentgemma-2b's RG-LRU width and rwkv6-3b's 40 heads split over
  'model', 2.5 heads a rank) within 2% of the reference's per-device
  ``analyze_compiled`` FLOPs, each side in a subprocess (the port in a
  world of 256 fake ranks on the meta device, the reference compiled on
  256 host devices).  The port's count is the reference's less its
  one-hot cross-entropy contraction (the port gathers the gold logit):
  0.002% or less for the transformers.
- The recurrent archs' other cells run too (prefill_32k, decode_32k,
  long_500k): the dry run refuses no cell.
- A (2, 16, 16) cell runs with the pod axis: the batch over pod x data,
  so a rank's FLOPs are half those at (16, 16); recurrentgemma-2b's
  ``train_4k`` runs there.
- The RWKV-6 token loop on the meta device runs one step counted S times
  (``hlo_static.trip_count``): one layer's forward FLOPs and bytes, and
  its forward and backward FLOPs, equal the whole loop's at S 64.
- A collective over a group of one rank (the 'data' axis of a (1, 2)
  world) counts nothing; over two ranks it counts by the reference's
  byte rule.
- The gradients of a sharded model are made and zeroed on local shards
  (``Transformer.trainable()``, ``train_cell``'s step), so the tracker's
  peak is the same under any torch version.
- ``roofline.fmt_table`` over a small record set.
- Nothing is written to ``results/``, where the reference's sweep and its
  tests (``test_dryrun_results.py``, ``test_perf_artifacts.py``) look.

The machine with the card has no JAX: there this module skips as a
whole."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

from repro import configs as jconfigs
from repro.launch.hlo_analysis import model_flops as jmodel_flops
from repro_torch import configs as tconfigs
from repro_torch.benchmarks import perf_iter, roofline
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import model_flops

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("llama3.2-1b", "train_4k"), ("llama3.2-1b", "prefill_32k"),
         ("minitron-4b", "train_4k"), ("recurrentgemma-2b", "train_4k"),
         ("rwkv6-3b", "train_4k")]
# the recurrent archs' other cells, run by the port alone
RECURRENT_CELLS = [(a, s) for a in ("recurrentgemma-2b", "rwkv6-3b")
                   for s in ("prefill_32k", "decode_32k", "long_500k")]
MULTI_CELLS = [("llama3.2-1b", "train_4k"), ("recurrentgemma-2b", "train_4k")]
RESULTS = [ROOT / "results" / "dryrun.json", ROOT / "results" / "perf.json"]

_PORT = """
    import json, sys
    from repro_torch.launch.dryrun import run_cell
    out = {}
    for arch, shape in CELLS:
        kw = {"remat": "full"} if shape.startswith("train") else {}
        r = run_cell(arch, shape, MULTI, verbose=False, **kw)
        out[f"{arch}:{shape}"] = r
    print(json.dumps(out))
"""

_REFERENCE = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import json
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.launch.hlo_analysis import analyze_compiled
    from repro.launch.steps import build_cell, lower_cell
    mesh = Mesh(np.array(jax.devices()).reshape(16, 16), ("data", "model"))
    out = {}
    for arch, shape in CELLS:
        kw = {"remat": "full"} if shape.startswith("train") else {}
        cell = build_cell(arch, shape, mesh, **kw)
        out[f"{arch}:{shape}"] = analyze_compiled(
            lower_cell(cell, mesh).compile()).flops
    print(json.dumps(out))
"""


_GROUPS = """
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.hlo_static import CostMode
    from repro_torch.sharding import comm
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    x = torch.ones(256)
    out = {}
    for axis in ("data", "model"):
        with CostMode() as m:
            comm.all_reduce(x, mesh.get_group(axis))
            comm.all_gather(x, 0, mesh.get_group(axis))
        out[axis] = [m.cost.coll_bytes_by_kind, m.cost.coll_count_by_kind]
    print(json.dumps(out))
"""


_GRADS = """
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import Shape, get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.steps import mesh_config, train_cell
    from repro_torch.models import Transformer, init_params, model_struct
    from repro_torch.models.base import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import param_pspecs
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    arch = get_config("mixtral-8x7b", smoke=True)
    cfg = mesh_config(arch, mesh, 4)
    struct = model_struct(cfg)
    model = Transformer(cfg, init_params(
        struct, torch.Generator().manual_seed(0), device="cpu", mesh=mesh,
        specs=param_pspecs(struct, cfg, mesh)))

    class Wrapped(TorchDispatchMode):
        ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and type(out) is not torch.Tensor:
                self.ops.append(str(func))
            return out

    mt = MemTracker()
    with mt, Wrapped():
        grads = model.trainable()
    leaves = tree_leaves(grads)
    out = {
        "trainable_ops": list(Wrapped.ops),
        "peak": max(v.get("Total", 0) for v in
                    mt.get_tracker_snapshot("peak").values()),
        "local": sum(g.to_local().numel() * g.element_size()
                     for g in leaves),
        "whole": sum(g.numel() * g.element_size() for g in leaves),
        "sharded": sum(g.to_local().numel() < g.numel() for g in leaves)}
    cell = train_cell(arch, Shape("t", 32, 4, "train"), mesh)
    params = init_params(model_struct(cell.cfg),
                         torch.Generator().manual_seed(0), device="cpu",
                         mesh=mesh, specs=cell.in_shardings[0])
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(arch, 4, 32).items()}
    opt = adamw_init(params)
    Wrapped.ops = []
    with Wrapped():
        cell.fn(params, opt, batch)
    out["step_ops"] = Wrapped.ops
    print(json.dumps(out))
"""


def _start(body: str, **subs):
    prog = textwrap.dedent(body)
    for k, v in subs.items():
        prog = prog.replace(k, repr(v))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", prog], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(ROOT))


def _json(proc) -> dict:
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    before = [p.exists() for p in RESULTS]
    procs = {"ref": _start(_REFERENCE, CELLS=CELLS),
             "single": _start(_PORT, CELLS=CELLS, MULTI=False),
             "recurrent": _start(_PORT, CELLS=RECURRENT_CELLS, MULTI=False),
             "multi": _start(_PORT, CELLS=MULTI_CELLS, MULTI=True)}
    out = {k: _json(p) for k, p in procs.items()}
    out["results_before"] = before
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_model_flops_match_reference(arch):
    for name, shape in jconfigs.SHAPES.items():
        for backward in (False, True):
            want = jmodel_flops(jconfigs.get_config(arch), shape,
                                backward=backward)
            got = model_flops(tconfigs.get_config(arch),
                              tconfigs.SHAPES[name], backward=backward)
            assert got == want, (arch, name, backward)


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in CELLS])
def test_rank_flops_match_reference(runs, cell):
    rec = runs["single"][cell]
    assert rec["status"] == "ok" and rec["mesh"] == "single"
    ratio = rec["roofline"]["flops"] / runs["ref"][cell]
    assert abs(ratio - 1) <= 0.02, ratio
    arch, shape = cell.split(":")
    assert rec["model_flops_total"] == model_flops(
        tconfigs.get_config(arch), tconfigs.SHAPES[shape],
        backward=shape == "train_4k")
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    ro = rec["roofline"]
    assert ro["dominant"] in ("compute", "memory", "collective")
    assert ro["coll_by_kind"]["all-gather"] > 0


@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in RECURRENT_CELLS])
def test_recurrent_cells_run_on_the_mesh(runs, cell):
    rec = runs["recurrent"][cell]
    assert rec["status"] == "ok", rec
    assert rec["roofline"]["flops"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0


@pytest.mark.parametrize("key", [f"{a}:{s}" for a, s in MULTI_CELLS])
def test_multipod_cell_runs_with_the_pod_axis(runs, key):
    multi, single = runs["multi"][key], runs["single"][key]
    assert multi["status"] == "ok" and multi["mesh"] == "multi"
    # the batch over pod x data: half the rows a rank, half the FLOPs
    assert multi["roofline"]["flops"] == pytest.approx(
        single["roofline"]["flops"] / 2, rel=1e-6)
    assert multi["model_flops_per_dev"] * 2 == single["model_flops_per_dev"]
    # the pod axis replicates the weights: their gradients are summed
    # over it, so a rank all-reduces more than at (16, 16)
    assert (multi["roofline"]["coll_count_by_kind"]["all-reduce"]
            > single["roofline"]["coll_count_by_kind"]["all-reduce"])


@pytest.mark.parametrize("backward", [False, True])
def test_meta_token_loop_counts_every_step(monkeypatch, backward):
    """One rwkv6-3b time-mix layer at S 64 on the meta device: with the
    token loop run once and counted 64 times, the forward's FLOPs and op
    bytes and the backward's FLOPs equal those of the whole loop (the
    backward's bytes do not: the loop's autograd also writes a
    whole-sequence zero gradient for each step's slice)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.launch.hlo_static import CostMode
    from repro_torch.launch.steps import abstract
    from repro_torch.models import model_struct, recurrent
    from repro_torch.models.base import Params
    cfg = tconfigs.get_config("rwkv6-3b")
    tm = abstract(model_struct(cfg)["segments"][0]["0"]["tm"])
    counts = {}
    for scaled in (True, False):
        if not scaled:        # the whole loop, as on a device with values
            monkeypatch.setattr(ref._MetaScan, "apply", ref._token_loop)
        p = Params({k: t[0].requires_grad_(backward) for k, t in tm.items()})
        x = torch.empty(2, 64, cfg.d_model, device="meta",
                        requires_grad=backward)
        with CostMode() as m:
            out, state = recurrent.rwkv6_time_mix(p, x, cfg=cfg)
            fwd = (m.cost.flops, m.cost.hbm_bytes)
            if backward:
                (out.sum() + state["wkv"].sum()).backward()
        assert out.shape == x.shape and state["wkv"].shape == (2, 40, 64, 64)
        counts[scaled] = fwd, m.cost.flops
    assert counts[True] == counts[False], counts


def test_collectives_over_a_group_of_one_count_nothing():
    """At (1, 2) the 'data' group is one rank: an all-reduce and an
    all-gather over it move nothing; over 'model' (two ranks) the
    all-reduce counts its 1 KiB twice and the all-gather its 2 KiB
    result."""
    out = _json(_start(_GROUPS))
    assert out["data"] == [{}, {}]
    assert out["model"] == [{"all-reduce": 2048, "all-gather": 2048},
                            {"all-reduce": 1, "all-gather": 1}]


def test_sharded_gradients_are_made_on_local_shards():
    """On a sharded model (smoke mixtral-8x7b at (1, 4), a fake world)
    ``Transformer.trainable()`` makes each gradient from zeros of the
    parameter's local shard, and ``train_cell``'s step zeroes it there:
    neither dispatches an op on a DTensor, and the dry run's memory
    tracker counts the gradients' local bytes and no more.  A DTensor's
    own ``zeros_like`` or ``zero_`` dispatches the global shape, which
    torch 2.11's tracker counted whole on the rank: mixtral-8x7b's
    ``train_4k`` peak (remat "dots") read 60.13 GB under torch 2.11 and
    40.33 GB under torch 2.13 at (16, 16), 30.06 and 21.86 GB at (2, 16,
    16)."""
    out = _json(_start(_GRADS))
    assert out["trainable_ops"] == [] and out["step_ops"] == []
    assert out["sharded"] > 0 and out["local"] < out["whole"]
    assert out["peak"] == out["local"]


def test_fmt_table():
    ok = {"arch": "a", "shape": "train_4k", "mesh": "single", "status": "ok",
          "microbatches": 2,
          "memory": {"peak_bytes": 90e9, "argument_bytes": 1e9},
          "roofline": {"compute_s": 1e-3, "memory_s": 2e-3,
                       "collective_s": 5e-4, "dominant": "memory",
                       "step_time_s": 2e-3},
          "model_flops_per_dev": 3e12, "useful_flop_frac": 0.5}
    fits = dict(ok, arch="b", memory={"peak_bytes": 10e9,
                                      "argument_bytes": 1e9})
    rows = [ok, fits,
            {"arch": "c", "shape": "long_500k", "mesh": "single",
             "status": "skipped", "reason": "pure full-attention arch"},
            {"arch": "d", "shape": "train_4k", "mesh": "single",
             "status": "refused", "reason": "not on a mesh (item 15)"},
            {"arch": "e", "shape": "train_4k", "mesh": "single",
             "status": "error", "error": "ValueError: x"},
            dict(ok, mesh="multi")]
    table = roofline.fmt_table(rows, "single").splitlines()
    assert len(table) == 2 + 5
    assert table[2].startswith("| a | train_4k | 2 | 1.0ms | 2.0ms | 0.5ms "
                               "| memory | 2.0ms | 3.0T | 0.50 | 90.0 "
                               "| NO (90G) |")
    assert table[3].endswith("| 10.0 | yes |")
    assert "skipped" in table[4] and "refused" in table[5]
    assert "ERROR" in table[6]
    assert "cells ok: 3" in roofline.summarize(rows)


def test_nothing_written_to_results(runs):
    assert not any(runs["results_before"])
    assert not any(p.exists() for p in RESULTS)
    for default in (dryrun.DEFAULT_OUT, perf_iter.DEFAULT_OUT):
        assert Path(default).parts[:2] == ("build", "repro_torch"), default
