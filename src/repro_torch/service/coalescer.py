"""Admission queue + batch coalescer (a copy of
``repro.service.coalescer``).

Requests are admitted one at a time but executed in signature-homogeneous
groups (that is where one launch of K1 a batch earns its keep), so the
service buffers admissions briefly and flushes a group when either

* **size**     — the group reaches ``max_batch`` requests (flushed
  synchronously on the admitting thread: no reason to wait once a full
  native batch is assembled), or
* **deadline** — the group's *oldest* entry has waited ``max_wait_s``
  (flushed by the service's flusher thread: bounded admission latency), or
* **manual**   — :meth:`BatchCoalescer.flush_all` (service ``flush()`` /
  shutdown).

The coalescer is pure bookkeeping — it never executes anything and is
safe to drive from multiple admitting threads plus one flusher.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Generic, TypeVar

from .signature import ExecSignature

__all__ = ["Admission", "BatchCoalescer", "FlushedGroup"]

T = TypeVar("T")


@dataclass
class Admission(Generic[T]):
    """One admitted request: the payload plus its admission timestamp."""

    payload: T
    submitted_at: float


@dataclass(frozen=True)
class FlushedGroup(Generic[T]):
    """A signature-homogeneous group handed to the dispatcher."""

    signature: ExecSignature
    entries: tuple[Admission[T], ...]
    cause: str                    # "size" | "deadline" | "manual"

    @property
    def size(self) -> int:
        return len(self.entries)


@dataclass
class _Pending(Generic[T]):
    entries: list[Admission[T]] = field(default_factory=list)
    oldest_at: float = 0.0


class BatchCoalescer(Generic[T]):
    """Thread-safe signature-keyed admission buffer with flush rules."""

    def __init__(self, *, max_batch: int = 64,
                 max_wait_s: float = 0.005,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: dict[ExecSignature, _Pending[T]] = {}

    # -- admission ----------------------------------------------------------

    def add(self, sig: ExecSignature, payload: T
            ) -> tuple[FlushedGroup[T] | None, bool]:
        """Admit one payload.

        Returns ``(flushed, created)``: a size-triggered flush (or None),
        and whether a new bucket was created.  ``created`` lets the caller
        wake its deadline timer only when the earliest deadline can have
        moved — appending to an existing bucket never does (all buckets
        share ``max_wait_s`` and age from their oldest entry).
        """
        now = self._clock()
        with self._lock:
            bucket = self._pending.get(sig)
            created = bucket is None
            if created:
                bucket = self._pending[sig] = _Pending(oldest_at=now)
            bucket.entries.append(Admission(payload, now))
            if len(bucket.entries) >= self.max_batch:
                del self._pending[sig]
                return FlushedGroup(sig, tuple(bucket.entries), "size"), \
                    created
        return None, created

    # -- flush rules --------------------------------------------------------

    def due(self, now: float | None = None) -> list[FlushedGroup[T]]:
        """Pop every group whose oldest entry has waited ``max_wait_s``."""
        if now is None:
            now = self._clock()
        flushed: list[FlushedGroup[T]] = []
        with self._lock:
            for sig in [s for s, b in self._pending.items()
                        if now - b.oldest_at >= self.max_wait_s]:
                bucket = self._pending.pop(sig)
                flushed.append(FlushedGroup(sig, tuple(bucket.entries),
                                            "deadline"))
        return flushed

    def flush_all(self) -> list[FlushedGroup[T]]:
        """Pop every pending group regardless of age."""
        with self._lock:
            flushed = [FlushedGroup(sig, tuple(b.entries), "manual")
                       for sig, b in self._pending.items()]
            self._pending.clear()
        return flushed

    # -- introspection ------------------------------------------------------

    def next_deadline(self) -> float | None:
        """Absolute clock time of the earliest pending deadline, or None."""
        with self._lock:
            if not self._pending:
                return None
            return min(b.oldest_at
                       for b in self._pending.values()) + self.max_wait_s

    def depth(self) -> int:
        """Number of admitted-but-unflushed requests."""
        with self._lock:
            return sum(len(b.entries) for b in self._pending.values())

    def group_count(self) -> int:
        with self._lock:
            return len(self._pending)
