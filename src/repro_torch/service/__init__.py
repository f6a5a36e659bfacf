"""Dispatch planning of the simulation service (port of
``repro.service.signature`` and ``repro.service.planner``): the execution
signature and the one grouping and routing path ``Simulator.run_batch``
takes.  The queue-fed service, its process tier and warm start are not
ported yet (ROADMAP.md, open items, item 4)."""
from .planner import DispatchGroup, execute_plan, plan_dispatch, run_group
from .signature import ExecSignature, meta_key, shard_of, signature_of

__all__ = ["DispatchGroup", "ExecSignature", "execute_plan", "meta_key",
           "plan_dispatch", "run_group", "shard_of", "signature_of"]
