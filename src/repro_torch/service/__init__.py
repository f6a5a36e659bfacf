"""repro_torch.service — the queue-fed, coalescing, sharded simulation
service (port of ``repro.service``).

The :mod:`repro_torch.engine` façade answers "run these requests"; this
package answers "keep answering that at scale":

* **admission + coalescing** — :class:`~repro_torch.service.coalescer
  .BatchCoalescer` buckets incoming requests by *execution signature*
  (:func:`~repro_torch.service.signature.signature_of`: mechanism, resolved
  machine config, program padding class, scheduling options, mechanism
  meta — the device among them) and flushes groups on size or deadline;
* **planning/dispatch** — :mod:`repro_torch.service.planner` routes
  signature-homogeneous groups to a mechanism's native ``batch_runner``
  (``hanoi_torch``: one launch of K1 a group) and the remainder to
  per-request execution; it is the **same** dispatch path
  ``Simulator.run_batch`` uses;
* **the service** — :class:`~repro_torch.service.core.SimulationService`:
  worker pool (or, with ``procs=N``, spawned shard processes with a
  persistent kernel cache and warm start), per-(SM, policy) ``run_sm``
  cells (``sm_torch``: K1 and K2), durable trace archival through any
  :class:`~repro_torch.engine.sinks.TraceSink`, and frozen
  :class:`~repro_torch.service.core.ServiceStats` metrics.

Quick start
-----------
::

    from repro_torch.service import SimulationService
    from repro_torch.engine import RotatingJsonlSink

    with SimulationService(archive=RotatingJsonlSink("sim-archive"),
                           max_batch=64, workers=4) as svc:   # the card
        tickets = [svc.submit(prog, cfg) for prog in programs]     # async
        mixed   = svc.run(requests, mechanism="hanoi")             # sync
        sm      = svc.submit_sm(bench, cfg, n_warps=8,
                                policy="greedy_then_oldest").result()
        print(svc.stats().native_batches, svc.stats().warps_per_s)

``SimulationService(device="cpu")`` runs the plain twins of the kernels.
``repro_torch.launch.serve --mode sim`` and ``serve_simulations`` are thin
clients of this package.
"""
from .coalescer import Admission, BatchCoalescer, FlushedGroup
from .core import (ServiceStats, ServiceStopped, ShardStats, SimTicket,
                   SimulationService)
from .planner import DispatchGroup, execute_plan, plan_dispatch, run_group
from .procpool import ArchiveSpec, ProcPool
from .signature import ExecSignature, meta_key, shard_of, signature_of

__all__ = [
    "Admission", "ArchiveSpec", "BatchCoalescer", "DispatchGroup",
    "ExecSignature", "FlushedGroup", "ProcPool", "ServiceStats",
    "ServiceStopped", "ShardStats", "SimTicket", "SimulationService",
    "execute_plan", "meta_key", "plan_dispatch", "run_group", "shard_of",
    "signature_of",
]
