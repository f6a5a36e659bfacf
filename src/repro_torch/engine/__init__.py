"""The unified control-flow simulation API (port of ``repro.engine``).

::

    from repro_torch.core.isa import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import Simulator

    cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    sim = Simulator()
    # a whole batch in one launch of kernel K1 on the card
    results = sim.run_batch(make_suite(cfg), cfg, mechanism="hanoi_torch")
    # the paper's Fig 9 and Fig 10 evaluation in one call
    report = sim.compare("hanoi_torch", baseline="turing_oracle",
                         timing="cycle")
    # one SM of 8 warps: K1 for the warps, K2 for the issue schedule
    sm = sim.run_sm(make_suite(cfg)[0], cfg, n_warps=8,
                    policy="greedy_then_oldest", sm_mechanism="sm_torch")

Layout: :mod:`.types` (frozen :class:`SimRequest` / :class:`SimResult` /
:class:`SmResult`, :class:`SimStatus`), :mod:`.registry` (the mechanism
registry), :mod:`.adapters` (``hanoi``, ``turing_oracle``, ``simt_stack``,
``dualpath`` and ``hanoi_torch``), :mod:`.mechanisms` (``volta_itps``,
``sm_interleave`` and ``sm_torch``), :mod:`.sinks` (the
:class:`TraceSink` consumers and the archive's replay meta),
:mod:`.simulator` (the :class:`Simulator` façade), :mod:`.compile_cache`
(affinity tokens, the persistent kernel cache and warm start).  The
registry is the port's own: nothing is registered into ``repro``'s.
"""
from repro_torch.core.isa import MachineConfig

from .registry import (Mechanism, available_mechanisms, get_mechanism,
                       iter_mechanisms, register_mechanism,
                       unregister_mechanism)
from .sinks import (JsonlSink, MemorySink, RingBufferSink, RotatingJsonlSink,
                    TraceSink, feed_result, replay_payload, run_meta,
                    sm_run_meta, timing_meta)
from .types import (SimRequest, SimResult, SimStatus, SmResult,
                    classify_status, worst_status)
from .simulator import CompareReport, CompareRow, Simulator, as_request
from .compile_cache import (CompileCache, WarmReport, compile_cache_stats,
                            install_compile_cache, installed_cache,
                            uninstall_compile_cache)
from . import adapters as _adapters            # registers the built-ins
from . import mechanisms as _mechanisms        # registers the plugins

__all__ = [
    "CompareReport", "CompareRow", "CompileCache", "JsonlSink",
    "MachineConfig",
    "Mechanism", "MemorySink", "RingBufferSink", "RotatingJsonlSink",
    "SimRequest", "SimResult", "SimStatus", "Simulator", "SmResult",
    "TraceSink", "WarmReport", "as_request",
    "available_mechanisms", "classify_status", "compile_cache_stats",
    "feed_result", "get_mechanism", "install_compile_cache",
    "installed_cache", "iter_mechanisms", "register_mechanism",
    "replay_payload", "run_meta", "sm_run_meta", "timing_meta",
    "uninstall_compile_cache", "unregister_mechanism", "worst_status",
]
