"""Discrete-event simulator core for the cycle-level SM timing model.

Port of ``repro.timing.events`` (numpy only, copied).

Two layers, both deliberately tiny:

* :class:`EventQueue` — a stable priority queue of ``(time, payload)``
  events.  Same-time events pop in push order (FIFO), which is what makes
  the SM model's warp wake-ups deterministic: ties never depend on heap
  internals or payload comparability.
* :class:`Scheduler` + generator *processes* — a coroutine-style layer in
  the style of Paladin's ``@task`` simulator: a process is a generator that
  ``yield``\\ s :class:`Delay` (sleep N cycles) or :class:`Signal` (park
  until fired).  The SM issue loop itself drives :class:`EventQueue`
  directly (its per-cycle policy arbitration is clearer as an explicit
  loop), but co-simulated models — a memory pipe, a DMA engine, a second
  SM — compose as processes on the same clock.

Nothing here knows about warps or instructions; :mod:`repro_torch.timing.sm_model`
is the SM-specific consumer.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Any, Generator, Iterator

__all__ = ["Delay", "EventQueue", "Process", "Scheduler", "Signal"]


class EventQueue:
    """Stable min-heap of ``(time, payload)`` events.

    >>> q = EventQueue()
    >>> q.push(5, "b"); q.push(5, "a"); q.push(1, "c")
    >>> q.pop()
    (1, 'c')
    >>> q.pop()           # same-time events keep push order
    (5, 'b')
    """

    def __init__(self) -> None:
        self._heap: list[tuple[int, int, Any]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, time: int, payload: Any) -> None:
        heapq.heappush(self._heap, (int(time), next(self._seq), payload))

    def peek_time(self) -> int:
        """Time of the earliest event; raises IndexError when empty."""
        return self._heap[0][0]

    def pop(self) -> tuple[int, Any]:
        time, _, payload = heapq.heappop(self._heap)
        return time, payload

    def pop_until(self, time: int) -> Iterator[Any]:
        """Drain (in order) every event with ``event_time <= time``."""
        while self._heap and self._heap[0][0] <= time:
            yield heapq.heappop(self._heap)[2]


@dataclass(frozen=True)
class Delay:
    """Process yield value: sleep for ``cycles`` (>= 0) simulated cycles."""

    cycles: int


@dataclass
class Signal:
    """Process yield value: park until some other process ``fire()``\\ s it.

    ``fire`` releases every currently-parked waiter at the scheduler's
    current time; a process yielding an already-fired one-shot signal
    (``sticky=True``) resumes immediately.
    """

    sticky: bool = False
    fired: bool = field(default=False, init=False)
    _waiters: list = field(default_factory=list, init=False)

    def fire(self, scheduler: "Scheduler") -> None:
        if self.sticky:
            self.fired = True
        waiters, self._waiters = self._waiters, []
        for proc in waiters:
            scheduler._resume(proc, scheduler.now)


class Process:
    """One running generator coroutine (created via Scheduler.spawn)."""

    def __init__(self, gen: Generator, name: str = "") -> None:
        self.gen = gen
        self.name = name or getattr(gen, "__name__", "process")
        self.done = False


class Scheduler:
    """Runs generator processes against one shared clock.

    >>> sched = Scheduler()
    >>> log = []
    >>> def ticker(n):
    ...     for i in range(n):
    ...         yield Delay(2)
    ...         log.append((sched.now, i))
    >>> _ = sched.spawn(ticker(3))
    >>> sched.run()
    >>> log
    [(2, 0), (4, 1), (6, 2)]
    """

    def __init__(self) -> None:
        self.now = 0
        self._queue = EventQueue()
        self._live = 0

    def spawn(self, gen: Generator, name: str = "") -> Process:
        proc = Process(gen, name)
        self._live += 1
        self._queue.push(self.now, proc)
        return proc

    def _resume(self, proc: Process, time: int) -> None:
        self._queue.push(time, proc)

    def _step_process(self, proc: Process) -> None:
        try:
            yielded = next(proc.gen)
        except StopIteration:
            proc.done = True
            self._live -= 1
            return
        if isinstance(yielded, Delay):
            if yielded.cycles < 0:
                raise ValueError(f"negative delay: {yielded.cycles}")
            self._queue.push(self.now + yielded.cycles, proc)
        elif isinstance(yielded, Signal):
            if yielded.sticky and yielded.fired:
                self._queue.push(self.now, proc)
            else:
                yielded._waiters.append(proc)
        else:
            raise TypeError(f"process {proc.name!r} yielded "
                            f"{type(yielded).__name__}; expected Delay or "
                            f"Signal")

    def run(self, until: int | None = None) -> int:
        """Run until no runnable process remains (or past ``until``).

        Returns the final clock.  Processes parked on a never-fired signal
        do not keep the scheduler alive — a co-simulation that ends with a
        stuck consumer terminates instead of spinning.
        """
        while self._queue:
            time = self._queue.peek_time()
            if until is not None and time > until:
                break
            self.now = max(self.now, time)
            _, proc = self._queue.pop()
            self._step_process(proc)
        return self.now
