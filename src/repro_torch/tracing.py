"""Spans and counters at the layer boundaries of the prefill path.

Off (the default), :func:`span` returns one shared no-op context and
:func:`count` returns at once: each is a test of a module-level flag and
nothing else (no clock read, no allocation, no device work, no host sync).
:func:`recording` turns them on for the block it wraps and yields a
:class:`Recorder`:

* each span appends a :class:`Span` record: its name, ``parent`` (the
  index of the enclosing span on the same thread), ``call`` (the index of
  the enclosing ``prefill`` span, which every request of one call shares),
  its start and end on ``time.perf_counter_ns`` and its thread.  While a
  ``torch.profiler`` records, a span is also a ``record_function`` range,
  so it lands in the profiler's trace as a ``user_annotation`` on the
  device operations' clock;
* with ``counters=True``, ``count(name, n)`` adds ``n``, a Python int or a
  0-dim device tensor (added on the device into an accumulator, never read
  back while the program runs); the recorder reads the accumulators back
  once, when the block ends.

Nothing is written anywhere: the caller reads the recorder when the block
ends.  Spans and counters may be entered from several threads at once.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

# every span the program opens, in the order of the layers they wrap
SPANS = ("prefill", "embed", "attention", "mla", "mla.q", "mla.kv",
         "mla.attend", "mla.out", "mlp", "moe", "moe.route", "moe.dispatch",
         "moe.experts", "moe.combine", "moe.shared", "rglru", "time_mix",
         "channel_mix", "cache_stack", "head")
COUNTERS = ("moe.slots", "moe.dropped", "moe.bias_moved")

_NULL = contextlib.nullcontext()
_spans = None       # the Recorder that takes spans, or None: off
_counts = None      # the Recorder that takes counts, or None: off


class Span(NamedTuple):
    name: str
    parent: int | None      # index of the enclosing span on this thread
    call: int | None        # index of the enclosing ``prefill`` span
    t0_ns: int
    t1_ns: int | None       # None while the span is open
    thread: int


class Recorder:
    """What one :func:`recording` block recorded: ``spans`` (records in
    the order they were entered) and, once the block has ended,
    ``counters`` (name -> int)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()     # .stack: [(index, call)]
        self._device: dict[str, torch.Tensor] = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name: str, n) -> None:
        with self._lock:
            if not isinstance(n, torch.Tensor):
                self.counters[name] = self.counters.get(name, 0) + n
                return
            acc = self._device.get(name)
            if acc is None:
                # a normal tensor, so later adds may come from outside
                # inference mode
                with torch.inference_mode(False):
                    acc = self._device[name] = torch.zeros(
                        (), dtype=torch.int64, device=n.device)
            acc.add_(n)

    def _close(self) -> None:
        for name, acc in self._device.items():
            self.counters[name] = self.counters.get(name, 0) + int(acc)
        self._device = {}
        self._local = None


class _Open:
    """One span while it is open."""
    __slots__ = ("rec", "name", "index", "stack", "rf")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.stack = stack = rec._stack()
        parent, call = stack[-1] if stack else (None, None)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        t0 = time.perf_counter_ns()
        with rec._lock:
            self.index = i = len(rec.spans)
            if self.name == "prefill":
                call = i
            rec.spans.append(Span(self.name, parent, call, t0, None,
                                  threading.get_ident()))
        stack.append((i, call))
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        rec = self.rec
        with rec._lock:
            rec.spans[self.index] = rec.spans[self.index]._replace(t1_ns=t1)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context for the span ``name`` (one of :data:`SPANS`)."""
    if _spans is None:
        return _NULL
    return _Open(_spans, name)


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-dim tensor on the device) to ``name``."""
    if _counts is not None:
        _counts._add(name, n)


def counting() -> bool:
    """Whether counters are on: a caller computes a tensor to
    :func:`count` only then."""
    return _counts is not None


@contextlib.contextmanager
def recording(spans: bool = True, counters: bool = False):
    """Turn spans (and counters) on for the block and yield its
    :class:`Recorder`; on exit turn both off and read the counters back."""
    global _spans, _counts
    if _spans is not None or _counts is not None:
        raise RuntimeError("tracing is already recording")
    rec = Recorder()
    _spans = rec if spans else None
    _counts = rec if counters else None
    try:
        yield rec
    finally:
        _spans = _counts = None
        rec._close()
