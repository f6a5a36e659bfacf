"""Meshes (port of ``repro.launch.mesh``).  Functions, so that importing
never touches ``torch.distributed``.

* :func:`make_production_mesh` is the (16, 16) / (2, 16, 16) mesh of the
  JAX package as an :class:`~repro_torch.sharding.AbstractMesh`, for the
  rule engine.  A ``DeviceMesh`` of that shape needs 256 (512) ranks.
* :func:`make_host_mesh` is a ``(world // model, model)`` ``DeviceMesh``
  named ``("data", "model")`` over the ranks of this world.

Backends: ``nccl`` when every rank has a card of its own; ``gloo`` for CPU
ranks and for ranks that share one card (NCCL refuses two ranks on one
GPU).  :func:`init_distributed` starts a world at a given address or
through a given store; :func:`spawn_world` serves its world's store;
``make_host_mesh`` starts one from ``torchrun``'s environment when none is
running.
"""
from __future__ import annotations

import os
import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.device import resolve
from repro_torch.sharding.specs import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def pick_backend(device: torch.device, local_world: int) -> tuple[str, str]:
    """(backend, why) for ``local_world`` ranks of one host on ``device``."""
    if device.type != "cuda":
        return "gloo", f"{local_world} CPU rank(s)"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s) on {cards} card(s), one each"
    return "gloo", f"{local_world} ranks share {cards} card(s)"


def init_distributed(rank: int, world: int, port: int | None, device=None,
                     local_world: int | None = None, *, store=None) -> str:
    """Join a world of ``world`` ranks with the backend
    :func:`pick_backend` names, through ``store`` (a c10d store that every
    rank reaches) or, without one, at ``tcp://localhost:port`` (rank 0
    binds the port); on the card, bind this rank to card ``rank %
    device_count``.  Returns the backend's name."""
    dev = resolve(device)
    backend, why = pick_backend(dev, world if local_world is None
                                else local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if store is None:
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
    if rank == 0:
        print(f"[mesh] backend {backend}: {why}", flush=True)
    return backend


def make_host_mesh(model: int = 1, device=None):
    """A ``(world // model, model)`` ``DeviceMesh`` named ``("data",
    "model")`` over every rank of this world, on the card unless
    ``device="cpu"``.  Without a running world, one is started from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_PORT``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", 1))
        assert world % model == 0, (world, model)
        init_distributed(int(os.environ.get("RANK", 0)), world,
                         int(os.environ.get("MASTER_PORT", 29500)), dev,
                         int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    n = dist.get_world_size()
    assert n % model == 0, (n, model)
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def _rank_main(rank, fn, nprocs, port, device, queue, args):
    store = dist.TCPStore("localhost", port, nprocs, is_master=False)
    init_distributed(rank, nprocs, None, device, store=store)
    try:
        # pickled here, by value: a tensor put as it is travels as a file
        # descriptor that this process serves until it exits, which can be
        # before the caller reads it
        queue.put((rank, pickle.dumps(fn(rank, nprocs, *args))))
    finally:
        dist.destroy_process_group()


def spawn_world(fn, nprocs: int, *args, device=None, timeout: float = 900):
    """Run ``fn(rank, nprocs, *args)`` on ``nprocs`` spawned processes that
    have joined one world (:func:`init_distributed`); returns their results
    in rank order.  ``fn`` is a module-level function and its result
    picklable.  A rank that fails fails the call.

    The world meets at a TCP store that this process serves for as long as
    the ranks run, on a port of localhost that the system picks when the
    store binds it: no other process can take the port between its choice
    and the ranks' connection (as it could a port found free and closed
    again, for a world spawned beside others).  A rank sends its result
    pickled by value, so that it outlives the rank's process."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    store = dist.TCPStore("localhost", 0, nprocs, is_master=True,
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = mp.start_processes(
        _rank_main, args=(fn, nprocs, store.port, device, q, args),
        nprocs=nprocs, join=False, start_method="spawn")
    out: dict = {}
    deadline = time.monotonic() + timeout
    while len(out) < nprocs:
        try:
            r, res = q.get(timeout=1.0)
            out[r] = pickle.loads(res)
        except queue_mod.Empty:
            if procs.join(timeout=0):      # every rank ended, some without
                break                      # a result: join raised if one failed
            if time.monotonic() > deadline:
                for p in procs.processes:
                    p.terminate()
                raise TimeoutError(f"spawn_world: {nprocs} ranks, "
                                   f"{len(out)} results in {timeout} s")
    while not procs.join():
        pass
    if len(out) < nprocs:
        raise RuntimeError(f"spawn_world: {len(out)} of {nprocs} results")
    return [out[r] for r in range(nprocs)]
