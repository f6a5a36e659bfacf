"""Persistent kernel cache and start-up warming for the torch batch paths
(port of ``repro.engine.compile_cache``).

A long-lived service pays each hot (cfg, pad-class, batch-class) signature's
first-launch costs once — until the process restarts.  In the reference that
cost is an XLA trace and compile; in the port it is what a kernel-cache miss
pays on the card (:func:`repro_torch.engine.adapters.prepare_launch`): the
kernel library's load (and, in a fresh checkout, its ``nvcc`` build), CUDA's
lazy load of the kernel instance at its first launch, and the caching
allocator's first segments at that shape.  This module makes the record of
what was hot durable:

* **Signature manifest** — every miss writes one small JSON file under
  ``{dir}/sigs/`` recording the (mechanism, cfg, majority_first, pad-class,
  batch-class) key and its load time: the reference's manifest, file for
  file.  Replaying it prepares each signature before a restarted worker
  admits traffic.
* **The "executable" layer** is the built kernel library under
  ``build/repro_torch/``, named by a hash of its sources: there is nothing
  to pickle.  A manifest key loads from disk when its library is built
  (:func:`supports_serialization`); on the CPU no library is needed.

The manifest is written atomically (tmp file + ``os.replace``), one file an
entry, so N shard processes share one cache directory without coordination.

:class:`~repro_torch.service.core.SimulationService` wires this up through
its ``warm_start=`` argument; shards warm only the slice of the manifest
whose :func:`affinity_token` hashes to them, the slice the service's
signature-affine routing sends them.  The module imports no torch at top
level.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Iterable

from repro_torch.core.isa import MachineConfig

__all__ = [
    "affinity_token", "shard_of_token", "CacheEntry", "CompileCache",
    "WarmReport", "install_compile_cache", "installed_cache",
    "uninstall_compile_cache", "compile_cache_stats",
    "supports_serialization",
]


# ---------------------------------------------------------------------------
# affinity hashing — shared by service routing and warm-start sharding
# ---------------------------------------------------------------------------

def _canon_cfg(cfg: MachineConfig) -> str:
    return json.dumps(cfg._asdict(), sort_keys=True, separators=(",", ":"))


def affinity_token(mechanism: str, cfg: MachineConfig,
                   majority_first: bool, pad_len: int) -> str:
    """The stable routing token of one compiled-state locality class.

    Everything that shares a token shares kernel-cache state (mechanism +
    canonical cfg + scheduling flavor + padding class), so the service
    routes it to one shard and warm-start replays it there.  The token is
    plain text — hash it with :func:`shard_of_token`, never with the
    builtin ``hash`` (randomized per process, useless across a pool).
    """
    return (f"{mechanism}|{_canon_cfg(cfg)}|mf{int(bool(majority_first))}"
            f"|pad{int(pad_len)}")


def shard_of_token(token: str, n_shards: int) -> int:
    """Deterministic shard assignment of a token: crc32 mod ``n_shards``."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(token.encode("utf-8")) % n_shards


# ---------------------------------------------------------------------------
# the libraries behind the manifest
# ---------------------------------------------------------------------------

def _kernels_of(mechanism: str) -> tuple[str, ...]:
    from .adapters import KERNELS
    return KERNELS.get(mechanism, ())


def supports_serialization(
        mechanisms: Iterable[str] = ("hanoi_torch", "sm_torch")) -> bool:
    """Whether the kernel libraries the manifest's mechanisms need are
    built on disk for the current sources, so a restart loads them without
    running ``nvcc`` (the reference asks whether jaxlib can serialize its
    executables)."""
    from repro_torch.kernels import _build, hanoi_step, sm_sched  # noqa: F401
    return all(_build.is_built(n) for m in mechanisms
               for n in _kernels_of(m))


# ---------------------------------------------------------------------------
# cache entries
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CacheEntry:
    """One manifest record: a hot launch-shape signature."""

    mechanism: str
    cfg: dict[str, Any]
    majority_first: bool
    batch: int
    pad_len: int
    token: str
    compile_time_s: float = 0.0

    def machine_config(self) -> MachineConfig:
        known = {k: v for k, v in self.cfg.items()
                 if k in MachineConfig._fields}
        return MachineConfig(**known)


@dataclass
class WarmReport:
    """Outcome of replaying the manifest slice assigned to one shard."""

    shard: int = 0
    n_shards: int = 1
    signatures: int = 0     # manifest entries assigned to this shard
    loaded: int = 0         # prepared from the disk (library built)
    retraced: int = 0       # a miss: the library had to be built first
    errors: int = 0
    wall_s: float = 0.0

    def as_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "WarmReport":
        r = WarmReport()
        for k, v in d.items():
            if hasattr(r, k):
                setattr(r, k, v)
        return r


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


@dataclass
class CompileCache:
    """One on-disk cache directory: the ``sigs/*.json`` manifest."""

    directory: str
    stats: dict[str, Any] = field(default_factory=lambda: {
        "stored": 0, "disk_hits": 0, "disk_misses": 0, "load_errors": 0,
        "load_time_s": 0.0})

    def __post_init__(self) -> None:
        self.directory = os.path.abspath(self.directory)
        self._lock = threading.Lock()
        os.makedirs(self._sig_dir, exist_ok=True)

    @property
    def _sig_dir(self) -> str:
        return os.path.join(self.directory, "sigs")

    # -- keying ----------------------------------------------------------

    @staticmethod
    def _digest(token: str, batch: int) -> str:
        return hashlib.sha1(f"{token}|b{int(batch)}"
                            .encode("utf-8")).hexdigest()[:20]

    def _paths(self, mechanism: str, cfg: MachineConfig,
               majority_first: bool, batch: int, pad_len: int
               ) -> tuple[str, str]:
        token = affinity_token(mechanism, cfg, majority_first, pad_len)
        return token, os.path.join(self._sig_dir,
                                   f"{self._digest(token, batch)}.json")

    # -- store / load ----------------------------------------------------

    def store_executable(self, mechanism: str, cfg: MachineConfig,
                         majority_first: bool, batch: int, pad_len: int,
                         compile_time_s: float | None = None) -> bool:
        """Record a miss in the manifest (the reference also pickles the
        executable here; the port's libraries live in the build directory
        already).  Returns whether they are built on disk, i.e. whether a
        restart loads this key without ``nvcc``."""
        token, sig_path = self._paths(mechanism, cfg, majority_first, batch,
                                      pad_len)
        entry = {"mechanism": mechanism, "cfg": cfg._asdict(),
                 "majority_first": bool(majority_first), "batch": int(batch),
                 "pad_len": int(pad_len), "token": token,
                 "compile_time_s": float(compile_time_s or 0.0)}
        _atomic_write(sig_path,
                      json.dumps(entry, sort_keys=True).encode("utf-8"))
        with self._lock:
            self.stats["stored"] += 1
        return supports_serialization([mechanism])

    def has(self, mechanism: str, cfg: MachineConfig, majority_first: bool,
            batch: int, pad_len: int) -> bool:
        """Whether the manifest already records this signature."""
        return os.path.exists(self._paths(mechanism, cfg, majority_first,
                                          batch, pad_len)[1])

    def load_executable(self, mechanism: str, cfg: MachineConfig,
                        majority_first: bool, batch: int, pad_len: int, *,
                        device=None) -> tuple[str, ...] | None:
        """The kernel names of a manifest signature, their libraries loaded
        on ``device`` (None: the card; on the CPU nothing is loaded), or
        None when the manifest lacks the signature or a library is not
        built on disk (the caller then takes a miss)."""
        import torch

        names = _kernels_of(mechanism)
        if not self.has(mechanism, cfg, majority_first, batch, pad_len) \
                or not names:
            with self._lock:
                self.stats["disk_misses"] += 1
            return None
        dev = torch.device("cuda" if device is None else device)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            if not supports_serialization([mechanism]):
                with self._lock:
                    self.stats["disk_misses"] += 1
                return None
            from repro_torch.kernels import _build
            try:
                for n in names:
                    _build.load(n)
            except (OSError, RuntimeError):
                with self._lock:
                    self.stats["load_errors"] += 1
                return None
        with self._lock:
            self.stats["disk_hits"] += 1
            self.stats["load_time_s"] += time.perf_counter() - t0
        return names

    # -- manifest --------------------------------------------------------

    def entries(self) -> list[CacheEntry]:
        """All manifest entries, sorted by token then batch (stable warm
        order).  Corrupt files are skipped, not fatal."""
        out: list[CacheEntry] = []
        try:
            names = sorted(os.listdir(self._sig_dir))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._sig_dir, name),
                          encoding="utf-8") as f:
                    d = json.load(f)
                out.append(CacheEntry(
                    mechanism=str(d["mechanism"]), cfg=dict(d["cfg"]),
                    majority_first=bool(d["majority_first"]),
                    batch=int(d["batch"]), pad_len=int(d["pad_len"]),
                    token=str(d["token"]),
                    compile_time_s=float(d.get("compile_time_s", 0.0))))
            except (OSError, ValueError, KeyError, TypeError):
                continue
        out.sort(key=lambda e: (e.token, e.batch))
        return out

    # -- warming ---------------------------------------------------------

    def warm(self, *, shard: int = 0, n_shards: int = 1,
             mechanisms: Iterable[str] = ("hanoi_torch", "sm_torch"),
             device=None) -> WarmReport:
        """Replay this shard's manifest slice: prepare each hot signature
        (loaded from disk where its library is built, a miss otherwise)
        and launch its kernel once on a dummy batch of its shape on
        ``device`` (None: the card), *before* the caller admits traffic."""
        from repro_torch.device import resolve

        from .adapters import batch_cache_stats, warm_launch

        dev = resolve(device)
        wanted = set(mechanisms)
        report = WarmReport(shard=int(shard), n_shards=int(n_shards))
        t0 = time.perf_counter()
        for entry in self.entries():
            if entry.mechanism not in wanted:
                continue
            if shard_of_token(entry.token, n_shards) != shard:
                continue
            report.signatures += 1
            before = batch_cache_stats()
            try:
                warm_launch(entry.mechanism, entry.machine_config(),
                            entry.majority_first, entry.batch,
                            entry.pad_len, dev)
            except Exception:
                report.errors += 1
                continue
            after = batch_cache_stats()
            if after["misses"] > before["misses"]:
                report.retraced += 1
            elif after["disk_hits"] > before["disk_hits"]:
                report.loaded += 1
            # a plain in-memory hit (duplicate manifest slice) counts as
            # neither — the signature was already warm
        report.wall_s = time.perf_counter() - t0
        return report

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            snap = dict(self.stats)
        snap["manifest_entries"] = len(self.entries())
        snap["supports_serialization"] = supports_serialization()
        return snap


# ---------------------------------------------------------------------------
# process-global installation (consulted by adapters.prepare_launch)
# ---------------------------------------------------------------------------

_INSTALLED: CompileCache | None = None


def install_compile_cache(directory: str) -> CompileCache:
    """Install (or re-point) the process-global persistent cache."""
    global _INSTALLED
    _INSTALLED = CompileCache(directory)
    return _INSTALLED


def installed_cache() -> CompileCache | None:
    return _INSTALLED


def uninstall_compile_cache() -> None:
    global _INSTALLED
    _INSTALLED = None


def compile_cache_stats() -> dict[str, Any]:
    """One merged snapshot: the in-memory kernel-cache counters plus (when
    a persistent cache is installed) its disk-layer counters."""
    from .adapters import batch_cache_stats
    snap: dict[str, Any] = dict(batch_cache_stats())
    cache = installed_cache()
    if cache is not None:
        snap["disk"] = cache.snapshot()
    return snap
