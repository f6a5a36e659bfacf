"""The multi-pod dry run on the meta device (port of
``repro.launch.dryrun``).

For every (architecture x input shape) cell, build the step against the
production meshes

* single-pod  (16, 16)      ("data", "model")          — the roofline's
* multi-pod   (2, 16, 16)   ("pod", "data", "model")   — the pod axis

and run rank 0's program once (``steps.lower_cell``): on the meta device,
in a world of 256 or 512 fake ranks (``torch.distributed``'s ``fake``
backend: every collective returns at once and moves nothing), so that
each rank's shapes, collectives and memory are those of the production
mesh.  Each record holds the rank's memory (its arguments' shards; the
peak of live tensors from ``MemTracker``), its FLOPs, op bytes and
collectives (``launch/hlo_static.py``), the H100 roofline terms
(``launch/hlo_analysis.py``) and ``model_flops``.

A fake world is set up once a process, for one world size, so ``main``
runs each mesh's cells in a pool of ``--jobs`` fresh processes of its own
(the JAX package too needs a fresh process, for its host-device count).

Statuses: ``ok``; ``skipped`` (the registry's ``cell_status``: encoders
have no decode step, long_500k needs sub-quadratic mixing); ``error``
(anything raised).  Every cell the JAX package builds runs: at (16, 16),
33 ok and 7 skipped.

Memory fit: a training cell whose peak passes :data:`HBM_BUDGET` is run
again with twice the microbatches, up to 16, as the JAX package does.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multipod-only | --single-only]
      [--jobs 4]
  python -m repro_torch.launch.dryrun --arch llama3.2-1b,mixtral-8x7b \
      --shape train_4k --multipod-only
  python -m repro_torch.launch.dryrun --all --out build/repro_torch/dryrun.json

It writes ``build/repro_torch/dryrun.json`` by default; never
``results/``, where the JAX package's sweep and its tests look.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

# The card's memory (NVIDIA H100 80GB HBM3: 80e9 bytes on the datasheet)
# less 10%: the CUDA context and the collectives' workspaces take 1-3 GB,
# the caching allocator's reserved blocks go past what it has allocated,
# and the tracker's estimate of PR 22's training step came 1.2% under the
# card's own peak.
HBM_BYTES = 80e9
HBM_BUDGET = 0.9 * HBM_BYTES

DEFAULT_OUT = os.path.join("build", "repro_torch", "dryrun.json")


def mesh_name(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def fake_world(multi_pod: bool):
    """The production mesh as a ``DeviceMesh`` over a world of fake ranks,
    this process rank 0; the world is started on the first call."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    assert dist.get_world_size() == n, (
        f"a fake world of {dist.get_world_size()} ranks is running; "
        f"the {mesh_name(multi_pod)} mesh needs {n}: use a fresh process")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             verbose: bool = True, **cell_kw) -> dict:
    from repro_torch.configs import SHAPES, cell_status, get_config
    from repro_torch.launch.hlo_analysis import analyze_cell, model_flops
    from repro_torch.launch.steps import build_cell, lower_cell

    mesh_n = mesh_name(multi_pod)
    ok, why = cell_status(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_n,
                "status": "skipped", "reason": why}
    t0 = time.time()
    mesh = fake_world(multi_pod)
    mb = cell_kw.pop("microbatches", 1)
    is_train = SHAPES[shape_name].kind == "train"
    while True:
        kw = dict(cell_kw, microbatches=mb) if is_train else dict(cell_kw)
        lowered = lower_cell(build_cell(arch, shape_name, mesh, **kw), mesh)
        peak = lowered.memory["peak_bytes"]
        if not is_train or peak <= HBM_BUDGET or mb >= 16:
            break
        if verbose:
            print(f"[dryrun] {arch} x {shape_name}: peak "
                  f"{peak / 1e9:.1f} GB > budget, retry "
                  f"microbatches={mb * 2}", flush=True)
        mb *= 2
    roof = analyze_cell(lowered)
    shape = SHAPES[shape_name]
    mf = model_flops(get_config(arch), shape,
                     backward=shape.kind == "train")
    n_dev = 512 if multi_pod else 256
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_n,
        "status": "ok", "microbatches": mb if is_train else None,
        "run_s": round(time.time() - t0, 1),
        "memory": lowered.memory,
        "roofline": roof.to_dict(),
        "model_flops_total": mf,
        "model_flops_per_dev": mf / n_dev,
        "useful_flop_frac": (mf / n_dev) / max(roof.flops, 1.0),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_n}: "
              f"run {rec['run_s']:.1f}s, "
              f"peak {lowered.memory['peak_bytes'] / 1e9:.2f} GB, "
              f"args {lowered.memory['argument_bytes'] / 1e9:.2f} GB, "
              f"dominant {roof.dominant}, "
              f"terms c/m/x = {roof.compute_s * 1e3:.1f}/"
              f"{roof.memory_s * 1e3:.1f}/{roof.collective_s * 1e3:.1f} ms",
              flush=True)
    return rec


def _key(r):
    return (r["arch"], r["shape"], r["mesh"])


def _sweep(cells, multi_pod: bool, cell_kw: dict) -> list[dict]:
    """The records of ``cells`` on one mesh, run in this process."""
    from repro_torch.configs import SHAPES

    out = []
    for arch, shape in cells:
        kw = dict(cell_kw) if SHAPES[shape].kind == "train" else {}
        try:
            rec = run_cell(arch, shape, multi_pod, **kw)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape,
                   "mesh": mesh_name(multi_pod), "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
        out.append(rec)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="an arch, or several, comma-separated")
    ap.add_argument("--shape", help="a shape, or several, comma-separated")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--single-only", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes a mesh's cells are spread over")
    args = ap.parse_args(argv)

    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from repro_torch.configs import ARCH_NAMES, SHAPES

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(a, s) for a in args.arch.split(",")
                 for s in args.shape.split(",")]
    meshes = []
    if not args.multipod_only:
        meshes.append(False)
    if not args.single_only:
        meshes.append(True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {_key(r) for r in results
            if r.get("status") in ("ok", "skipped")}

    # a fake world is one a process, for one world size: each mesh's cells
    # run in a pool of their own, one cell a task, so that a process keeps
    # its world from cell to cell and the next free process takes the next
    # cell, the training cells (the longest) first
    kinds = list(SHAPES)
    new = []
    for mp in meshes:
        todo = sorted((c for c in cells if c + (mesh_name(mp),) not in done),
                      key=lambda c: kinds.index(c[1]))
        if not todo:
            continue
        with ProcessPoolExecutor(max_workers=max(1, min(args.jobs, len(todo))),
                                 mp_context=get_context("spawn")) as ex:
            futures = [ex.submit(_sweep, [c], mp, {"remat": args.remat})
                       for c in todo]
            new += [r for f in futures for r in f.result()]
    keys = {_key(r) for r in new}
    order = {c: i for i, c in enumerate(cells)}
    results = [r for r in results if _key(r) not in keys] + sorted(
        new, key=lambda r: (r["mesh"], order[(r["arch"], r["shape"])]))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    failures = sum(r["status"] == "error" for r in new)
    print(f"[dryrun] wrote {args.out}; {len(new)} records, "
          f"{failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
