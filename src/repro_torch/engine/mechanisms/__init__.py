"""Registered mechanism plugins beyond the built-in adapter family (port of
``repro.engine.mechanisms``).

Each submodule registers one mechanism with the
:mod:`repro_torch.engine.registry` at import time:

* :mod:`.volta`    — ``volta_itps``: Volta-style independent thread
  scheduling (per-thread PCs, no reconvergence stack, greedy convergence
  optimizer with a forward-progress guarantee);
* :mod:`.sm`       — ``sm_interleave``: a per-SM model that time-multiplexes
  N warps through any registered single-warp mechanism under a pluggable
  warp-scheduler policy;
* :mod:`.sm_torch` — ``sm_torch``: the same SM model for a whole grid of
  cells in one launch of K1 (the warps) and one of K2 (the issue
  scheduler), SM traces bit-identical to ``sm_interleave``; the
  counterpart of the reference's ``sm_jax``.

Importing this package (done by ``repro_torch.engine``) registers all of
them.
"""
from . import volta, sm, sm_torch  # noqa: F401  (import side effect:
#                                    registration)

from .sm import (SM_POLICIES, build_sm_result, interleave_cycle,  # noqa: F401
                 interleave_traces)
from .sm_torch import run_cells  # noqa: F401
from .volta import run_volta_itps  # noqa: F401

__all__ = ["SM_POLICIES", "build_sm_result", "interleave_cycle",
           "interleave_traces", "run_cells",
           "run_volta_itps"]
