"""The unified control-flow simulation API (port of ``repro.engine``).

::

    from repro_torch.core.isa import MachineConfig
    from repro_torch.core.programs import make_suite
    from repro_torch.engine import Simulator

    cfg = MachineConfig(n_threads=32, mem_size=256, max_steps=60_000)
    sim = Simulator()
    # a whole batch in one launch of kernel K1 on the card
    results = sim.run_batch(make_suite(cfg), cfg, mechanism="hanoi_torch")
    # the paper's Fig 9 evaluation in one call
    report = sim.compare("hanoi_torch", baseline="turing_oracle",
                         timing=False)

Layout: :mod:`.types` (frozen :class:`SimRequest` / :class:`SimResult`,
:class:`SimStatus`), :mod:`.registry` (the mechanism registry),
:mod:`.adapters` (``hanoi``, ``turing_oracle``, ``simt_stack``,
``dualpath`` and ``hanoi_torch``), :mod:`.simulator` (the
:class:`Simulator` façade), :mod:`.compile_cache` (affinity tokens).  The
registry is the port's own: nothing is registered into ``repro``'s.
"""
from repro_torch.core.isa import MachineConfig

from .registry import (Mechanism, available_mechanisms, get_mechanism,
                       iter_mechanisms, register_mechanism,
                       unregister_mechanism)
from .types import (SimRequest, SimResult, SimStatus, classify_status,
                    worst_status)
from .simulator import CompareReport, CompareRow, Simulator, as_request
from . import adapters as _adapters            # registers the built-ins

__all__ = [
    "CompareReport", "CompareRow", "MachineConfig", "Mechanism",
    "SimRequest", "SimResult", "SimStatus", "Simulator", "as_request",
    "available_mechanisms", "classify_status", "get_mechanism",
    "iter_mechanisms", "register_mechanism", "unregister_mechanism",
    "worst_status",
]
