"""Atomic, async checkpointing (port of ``repro.checkpoint.ckpt``), in the
JAX package's on-disk layout, one directory per step::

    <dir>/step_000123/
        manifest.json            # leaf keys, shapes and dtypes
        proc00.npz               # the leaves
        COMMIT                   # written last: partial ckpts never load

The leaves are those of the saved tree in the JAX package's order (dict
keys sorted, lists in order: the stacked segment leaves of a param tree),
each stored whole under ``leaf%05d__full``.  Either package restores an
f32 or int32 checkpoint that the other wrote.  One card holds every leaf
whole, so there is no sharding to restore; a checkpoint the JAX package
wrote from sharded arrays (keys tagged with slices) is reassembled.

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


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write one checkpoint of a tree of tensors (or numpy arrays) as
    process 0, the one process; returns the step directory path."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp0"
    os.makedirs(tmp_dir, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"treedef": repr(tree_map(lambda _: "*", tree)),
                  "leaves": [], "step": step}
    for i, leaf in enumerate(tree_leaves(tree)):
        a = _host(leaf)
        meta["leaves"].append({"key": _key(i), "shape": list(a.shape),
                               "dtype": _dtype_name(a)})
        arrays[f"{_key(i)}__full"] = a

    np.savez(os.path.join(tmp_dir, "proc00.npz"), **arrays)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(meta, f)
    # single-process commit protocol
    os.makedirs(step_dir, exist_ok=True)
    for name in os.listdir(tmp_dir):
        os.replace(os.path.join(tmp_dir, name), os.path.join(step_dir, name))
    shutil.rmtree(tmp_dir, ignore_errors=True)
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


def restore_checkpoint(ckpt_dir: str, step: int, like_tree):
    """The checkpoint's tree, laid out as ``like_tree``, each leaf with its
    like's shape, dtype and device."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    if not os.path.exists(os.path.join(step_dir, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    data: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(step_dir)):
        if name.endswith(".npz"):
            with np.load(os.path.join(step_dir, name)) as z:
                for k in z.files:
                    data[k] = z[k]

    out = []
    for i, like in enumerate(tree_leaves(like_tree)):
        full = torch.zeros(like.shape, dtype=like.dtype)
        found = False
        for k, v in data.items():
            if not k.startswith(_key(i) + "__"):
                continue
            tag = k.split("__", 1)[1]
            full[_parse_tag(tag, like.shape)] = _tensor(v).to(like.dtype)
            found = True
        if not found:
            raise FileNotFoundError(f"leaf {i} missing from {step_dir}")
        out.append(full.to(like.device))
    return tree_unflatten(like_tree, out)


class CheckpointManager:
    """Async save + keep-last-k retention."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._last: Future | None = None
        self._lock = threading.Lock()

    def save(self, step: int, tree) -> Future:
        # snapshot to host memory synchronously (the caller updates these
        # tensors in place in its next step); only the disk write is async
        host_tree = tree_map(_host, tree)

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree)
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
