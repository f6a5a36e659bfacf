"""Mechanism registry: named, swappable control-flow-management models.

A *mechanism* is anything that can execute a SASS-lite warp and return a
normalized :class:`~repro.engine.types.SimResult` — the paper's comparable
family (pre-Volta SIMT-Stack, Hanoi, the Turing runtime heuristic), the
Dual-Path comparison point, and the vectorized JAX engine are all registered
here.  Third-party mechanisms (e.g. a DARM-style divergence-melding variant)
plug in with the decorator::

    from repro_torch.engine import SimRequest, SimResult, register_mechanism

    @register_mechanism("darm", backend="numpy",
                        description="branch-melding prototype")
    def run_darm(req: SimRequest) -> SimResult:
        ...

and immediately work with :class:`~repro.engine.simulator.Simulator`,
``run_batch`` and ``compare`` — no other plumbing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

from .types import SimRequest, SimResult

Runner = Callable[[SimRequest], SimResult]
BatchRunner = Callable[[Sequence[SimRequest]], "list[SimResult]"]


@dataclass(frozen=True)
class Mechanism:
    """A registered control-flow-management model.

    ``runner`` executes one request; ``batch_runner`` (optional) executes a
    *homogeneous* batch natively (the JAX engine vmaps over warps and over
    padded programs).  Without one, the Simulator runs requests
    sequentially (or through an opt-in thread pool — see ``Simulator``'s
    ``max_workers``).
    """

    name: str
    runner: Runner
    backend: str = "numpy"                 # "numpy" | "jax"
    description: str = ""
    batch_runner: BatchRunner | None = None
    uses_skip_pcs: bool = False            # consumes SimRequest.bsync_skip_pcs
    tags: tuple[str, ...] = ()

    def __call__(self, req: SimRequest) -> SimResult:
        return self.runner(req)


_REGISTRY: dict[str, Mechanism] = {}


def register_mechanism(name: str, *, backend: str = "numpy",
                       description: str = "",
                       batch_runner: BatchRunner | None = None,
                       uses_skip_pcs: bool = False,
                       tags: Sequence[str] = (),
                       overwrite: bool = False) -> Callable[[Runner], Runner]:
    """Decorator registering ``fn(SimRequest) -> SimResult`` under ``name``."""
    def deco(fn: Runner) -> Runner:
        if name in _REGISTRY and not overwrite:
            raise ValueError(f"mechanism {name!r} already registered "
                             f"(pass overwrite=True to replace)")
        _REGISTRY[name] = Mechanism(
            name=name, runner=fn, backend=backend, description=description,
            batch_runner=batch_runner, uses_skip_pcs=uses_skip_pcs,
            tags=tuple(tags))
        return fn
    return deco


def unregister_mechanism(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_mechanism(name: str) -> Mechanism:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY)) or "<none>"
        raise KeyError(f"unknown mechanism {name!r}; registered: {known}") \
            from None


def available_mechanisms() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def iter_mechanisms() -> Iterator[Mechanism]:
    for name in available_mechanisms():
        yield _REGISTRY[name]
