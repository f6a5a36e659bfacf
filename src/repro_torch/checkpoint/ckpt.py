"""Sharded, atomic, async checkpointing (port of ``repro.checkpoint.ckpt``),
in the JAX package's on-disk layout, one directory per step::

    <dir>/step_000123/
        manifest.json            # leaf keys, global shapes and dtypes
        proc00.npz               # this process's shards
        ...
        COMMIT                   # written last: partial ckpts never load

The leaves are those of the saved tree in the JAX package's order (dict
keys sorted, lists in order: the stacked segment leaves of a param tree).
A whole tensor is stored under ``leaf%05d__full`` (by rank 0); a DTensor
leaf as each rank's shard under the JAX package's per-shard tag
(``leaf%05d__0-64_-``: each dimension's ``start-stop``, or ``-`` where it
is whole), one copy of each shard (the replica at coordinate 0 of the
mesh dimensions that replicate it writes it).  The layout is
mesh-agnostic: a restore reassembles each global leaf and places it on
any mesh, or whole.  Either package restores an f32 or int32 checkpoint
that the other wrote, sharded or not.

With several processes each rank moves its file into the step directory
and leaves a ``done`` marker of that save; rank 0 writes the manifest and
``COMMIT`` once every rank's marker is there (no collective: the saves
may run on the manager's writer thread).

bf16 leaves are stored as the JAX package stores them: their bits as
2-byte voids (numpy has no bf16 of its own).  This module reads them back,
its own and the JAX package's; the JAX package's restore cannot cast them.

``CheckpointManager`` adds async saves (background thread) and keep-last-k
garbage collection.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.models.base import tree_leaves, tree_map, tree_unflatten


def _key(i: int) -> str:
    return f"leaf{i:05d}"


def _host(leaf) -> np.ndarray:
    """A leaf as the array written to disk, a copy that later in-place
    updates of the tensor do not reach: bf16 as its bits in 2-byte voids."""
    if isinstance(leaf, np.ndarray):
        return leaf
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype.kind == "V" else a.dtype.name


def _shard_tag(t) -> str | None:
    """The JAX package's tag of this rank's shard of a DTensor, or None
    when another rank writes the same shard (a replica)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    start = [0] * t.dim()
    extent = list(t.shape)
    for i, p in enumerate(t.placements):
        if not p.is_shard():
            if coord[i] != 0:
                return None
            continue
        extent[p.dim] //= mesh.size(i)
        start[p.dim] += coord[i] * extent[p.dim]
    return "_".join(
        f"{a}-{a + n}" if n != full else "-"
        for a, n, full in zip(start, extent, t.shape)) or "full"


def _snapshot(tree, process_index: int) -> tuple[dict, list]:
    """(arrays to write, manifest entries) of this process's part of a
    tree: host copies, which later in-place updates do not reach."""
    arrays: dict[str, np.ndarray] = {}
    leaves: list = []
    for i, leaf in enumerate(tree_leaves(tree)):
        if hasattr(leaf, "device_mesh"):
            tag = _shard_tag(leaf)
            a = _host(leaf.to_local())
            if tag is not None:
                arrays[f"{_key(i)}__{tag}"] = a
        else:
            a = _host(leaf)
            if process_index == 0:
                arrays[f"{_key(i)}__full"] = a
        leaves.append({"key": _key(i), "shape": list(leaf.shape),
                       "dtype": _dtype_name(a)})
    return arrays, leaves


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    process_index: int = 0, process_count: int = 1) -> str:
    """Write one checkpoint of a tree of tensors, DTensors or numpy arrays
    as process ``process_index`` of ``process_count``; returns the step
    directory path."""
    return _write(ckpt_dir, step, repr(tree_map(lambda _: "*", tree)),
                  _snapshot(tree, process_index), process_index,
                  process_count, 0)


def _write(ckpt_dir: str, step: int, treedef: str, snap, process_index: int,
           process_count: int, save_id: int) -> str:
    """Write a snapshot; ``save_id`` tells apart two saves of one step
    (a manager's count of its saves: the ranks save in the same order)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp_dir = step_dir + f".tmp{process_index}"
    os.makedirs(tmp_dir, exist_ok=True)
    arrays, leaves = snap
    meta: dict = {"treedef": treedef, "leaves": leaves, "step": step}

    np.savez(os.path.join(tmp_dir, f"proc{process_index:02d}.npz"), **arrays)
    os.makedirs(step_dir, exist_ok=True)
    for name in os.listdir(tmp_dir):
        os.replace(os.path.join(tmp_dir, name), os.path.join(step_dir, name))
    shutil.rmtree(tmp_dir, ignore_errors=True)
    with open(os.path.join(step_dir, f"done{process_index:02d}.{save_id}"),
              "w") as f:
        f.write("ok")
    if process_index != 0:
        return step_dir
    done = [os.path.join(step_dir, f"done{r:02d}.{save_id}")
            for r in range(process_count)]
    deadline = time.monotonic() + 600
    while not all(os.path.exists(d) for d in done):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{step_dir}: not every rank saved")
        time.sleep(0.05)
    with open(os.path.join(step_dir, "manifest.json"), "w") as f:
        json.dump(meta, f)
    for d in done:
        os.remove(d)
    with open(os.path.join(step_dir, "COMMIT"), "w") as f:
        f.write("ok")
    return step_dir


def _committed_steps(ckpt_dir: str) -> list[int]:
    return sorted(
        int(m.group(1)) for name in os.listdir(ckpt_dir)
        if (m := re.fullmatch(r"step_(\d+)", name))
        and os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _parse_tag(tag: str, shape) -> tuple:
    if tag == "full":
        return tuple(slice(None) for _ in shape)
    out = []
    for part in tag.split("_"):
        a, b = part.split("-")
        out.append(slice(int(a) if a else None, int(b) if b else None))
    return tuple(out)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V":                          # bf16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, *,
                       shardings=None, mesh=None):
    """The checkpoint's tree, laid out as ``like_tree``: each leaf
    reassembled whole from the shards on disk, with its like's shape and
    dtype, then placed: as a DTensor on ``mesh`` laid out by the
    PartitionSpec at its place in ``shardings``; else like its like (a
    DTensor like on the like's mesh and placements, a tensor on its
    device)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    if not os.path.exists(os.path.join(step_dir, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    likes = tree_leaves(like_tree)
    specs = (tree_leaves(shardings) if shardings is not None
             else [None] * len(likes))
    files = [np.load(os.path.join(step_dir, name))
             for name in sorted(os.listdir(step_dir))
             if name.endswith(".npz")]
    try:
        index: dict[str, list] = {}
        for z in files:
            for k in z.files:
                index.setdefault(k.split("__", 1)[0], []).append((z, k))
        out = []
        for i, (like, spec) in enumerate(zip(likes, specs, strict=True)):
            full = torch.zeros(like.shape, dtype=like.dtype)
            if _key(i) not in index:
                raise FileNotFoundError(f"leaf {i} missing from {step_dir}")
            for z, k in index[_key(i)]:
                tag = k.split("__", 1)[1]
                full[_parse_tag(tag, like.shape)] = _tensor(z[k]).to(
                    like.dtype)
            out.append(_place(full, like, spec, mesh))
    finally:
        for z in files:
            z.close()
    return tree_unflatten(like_tree, out)


def _place(full: torch.Tensor, like, spec, mesh):
    if spec is not None:
        from repro_torch.sharding.specs import distribute
        return distribute(full.to(mesh.device_type), mesh, spec)
    if hasattr(like, "device_mesh"):
        from torch.distributed.tensor import DTensor

        from repro_torch.sharding.specs import local_chunk
        local = local_chunk(full.to(like.to_local().device),
                            like.device_mesh, like.placements)
        return DTensor.from_local(local, like.device_mesh, like.placements,
                                  run_check=False, shape=full.shape,
                                  stride=full.stride())
    return full.to(like.device)


class CheckpointManager:
    """Async save + keep-last-k retention."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 process_index: int = 0, process_count: int = 1):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.process_index = process_index
        self.process_count = process_count
        self._saves = 0
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._last: Future | None = None
        self._lock = threading.Lock()

    def save(self, step: int, tree) -> Future:
        # snapshot to host memory synchronously (the caller updates these
        # tensors in place in its next step); only the disk write is async
        snap = _snapshot(tree, self.process_index)
        treedef = repr(tree_map(lambda _: "*", tree))
        self._saves += 1
        save_id = self._saves

        def work():
            _write(self.ckpt_dir, step, treedef, snap, self.process_index,
                   self.process_count, save_id)
            if self.process_index == 0:
                self._gc()
            return step

        with self._lock:
            if self._last is not None:
                self._last.result()          # serialize saves
            self._last = self._pool.submit(work)
            return self._last

    def wait(self):
        with self._lock:
            if self._last is not None:
                self._last.result()

    def close(self):
        """Wait for the last save and stop the writer thread."""
        self.wait()
        self._pool.shutdown()

    def _gc(self):
        for s in _committed_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)
