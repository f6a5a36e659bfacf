"""The train loop (port of ``repro.launch.train``), with the runtime
around the steps: the deterministic data pipeline, periodic async
checkpoints, restart-on-failure resume, the straggler monitor and optional
int8 gradient compression (error feedback).

One process holds the whole model, its gradients and the AdamW state in
the JAX package's stacked layout (``Transformer.tree``).  In a world of
several ranks (``torchrun``), or with ``model_axis`` > 1, they are
sharded on a ``(world // model_axis, model_axis)`` mesh by
``param_pspecs`` (FSDP on 'data' x TP on 'model', the JAX package's
default), the moments like their parameters, and every rank draws the
same global batch and keeps its ``batch_pspec`` rows.  Entry points run
on the card unless given ``device="cpu"``.

Usage:
  python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 50 \\
      --batch 8 --seq 128 --ckpt-dir DIR [--resume] [--fail-at-step 30] \\
      [--device cpu]
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --model-axis 2 [...]
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import mesh_config
from repro_torch.models import (ModelConfig, Transformer, init_params,
                                loss_fn, model_struct)
from repro_torch.models.base import tree_leaves, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.runtime import StragglerMonitor, ef_compress_grads
from repro_torch.sharding import local_batch, param_pspecs


def build_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                      mesh=None):
    """(model, opt_state): f32 parameters drawn by ``init_params`` from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, as a trainable
    :class:`Transformer`, and AdamW's zeroed state.  On a ``mesh`` the
    parameters are DTensors laid out by ``param_pspecs`` (each drawn whole,
    so the values are those of one device) and the moments follow them."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    struct = model_struct(cfg)
    params = init_params(struct, gen, device=dev, mesh=mesh,
                         specs=None if mesh is None
                         else param_pspecs(struct, cfg, mesh))
    model = Transformer(cfg, params)
    model.trainable()
    return model, adamw_init(params)


def make_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, total_steps: int,
              compress: bool = False):
    """One training step, an eager function
    ``step(model, opt_state, err_state, batch) -> (model, opt_state,
    err_state, metrics)``: the loss and its gradients (into ``model.grads``),
    int8 error feedback when ``compress``, the cosine lr at the optimizer's
    step, and AdamW in place in ``model.tree``.  ``metrics`` holds 0-dim
    tensors on the device: ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr``; nothing is read back to the host."""
    def step(model: Transformer, opt_state, err_state, batch):
        grads = model.trainable()
        for g in tree_leaves(grads):
            g.zero_()
        loss, metrics = loss_fn(model, cfg, batch)
        loss.backward()
        if compress:
            grads, err_state = ef_compress_grads(grads, err_state)
        lr = cosine_schedule(opt_state["step"], peak_lr=opt_cfg.lr,
                             total=total_steps)
        _, opt_state, gnorm = adamw_update(model.tree, grads, opt_state,
                                           opt_cfg, lr=lr)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return model, opt_state, err_state, dict(
            metrics, loss=loss.detach(), grad_norm=gnorm, lr=lr)
    return step


def train(arch: str | ModelConfig, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 20, resume: bool = False,
          fail_at_step: int | None = None, compress: bool = False,
          lr: float = 3e-3, seed: int = 0, log_every: int = 10,
          model_axis: int = 1, device=None) -> dict:
    """Train ``arch`` (a registered name, its smoke config if ``smoke``, or
    a :class:`ModelConfig`) for ``steps`` steps.  Returns the losses, the
    final ``params`` tree (``model.tree``), ``opt_state`` and
    ``final_loss``.  In a running world, or one that ``torchrun`` set up,
    or with ``model_axis`` > 1, it trains on :func:`make_host_mesh`'s
    mesh (``model_axis`` its TP size); the losses are the global ones."""
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke) if isinstance(arch, str) else arch
    mesh = None
    if (model_axis != 1 or dist.is_initialized()
            or int(os.environ.get("WORLD_SIZE", 1)) > 1):
        mesh = make_host_mesh(model_axis, dev)
        cfg = mesh_config(cfg, mesh, batch)
    rank = 0 if mesh is None else dist.get_rank()
    world = 1 if mesh is None else dist.get_world_size()
    opt_cfg = AdamWConfig(lr=lr)
    model, opt_state = build_train_state(cfg, seed, dev, mesh)
    err_state = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         model.tree) if compress else None

    start = 0
    mgr = CheckpointManager(ckpt_dir, keep=3, process_index=rank,
                            process_count=world) if ckpt_dir else None
    if resume and ckpt_dir and (last := latest_step(ckpt_dir)) is not None:
        state = restore_checkpoint(
            ckpt_dir, last, {"params": model.tree, "opt": opt_state})
        with torch.no_grad():
            for p, saved in zip(tree_leaves(model.tree),
                                tree_leaves(state["params"]), strict=True):
                _local(p).copy_(_local(saved))
        opt_state = state["opt"]
        start = last
        if rank == 0:
            print(f"[train] resumed from step {start}", flush=True)

    pipe = SyntheticPipeline(cfg, batch, seq, dc=DataConfig(seed=seed))
    step_fn = make_step(cfg, opt_cfg, total_steps=steps, compress=compress)
    mon = StragglerMonitor()
    losses = []
    try:
        for i in range(start, steps):
            if fail_at_step is not None and i == fail_at_step:
                raise RuntimeError(f"injected failure at step {i}")
            t0 = time.time()
            hb = {k: torch.from_numpy(v).to(dev)
                  for k, v in pipe.get(i).items()}
            if mesh is not None:
                hb = local_batch(hb, cfg, mesh)
            model, opt_state, err_state, metrics = step_fn(
                model, opt_state, err_state, hb)
            loss = float(metrics["loss"])
            losses.append(loss)
            mon.record(rank, time.time() - t0)
            if mgr and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, {"params": model.tree, "opt": opt_state})
            if (i + 1) % log_every == 0 and rank == 0:
                print(f"[train] step {i+1:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({time.time()-t0:.2f}s)", flush=True)
        if mgr:
            mgr.save(steps, {"params": model.tree, "opt": opt_state})
    finally:
        if mgr:
            mgr.close()
    return {"losses": losses, "params": model.tree, "opt_state": opt_state,
            "final_loss": losses[-1] if losses else None}


def _local(t):
    return t.to_local() if hasattr(t, "device_mesh") else t


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    res = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                fail_at_step=args.fail_at_step, compress=args.compress,
                lr=args.lr, model_axis=args.model_axis, device=args.device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"[train] done; final loss {res['final_loss']:.4f}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
