"""Execution signatures: the grouping key for coalescing and dispatch.

Two requests may share one native batch execution (the vmap-batched JAX
path, one compiled executable) exactly when everything the compiled state
machine closes over is equal: the mechanism, the resolved
:class:`~repro.core.isa.MachineConfig` (fuel folded in), the program's
*padding class* (length rounded up to
:data:`~repro.engine.adapters.PAD_QUANTUM` — programs in one class batch
into the same padded shape), the scheduling options
(``majority_first``), the oracle skip set, and any mechanism-specific
``meta`` options.  Per-request *data* — registers, memory image, lane ids —
is deliberately **not** part of the signature: the batch runner carries it
as vmapped operands.

:func:`signature_of` derives that key from a request; the coalescer buckets
admissions by it and the planner routes each bucket either to the
mechanism's native ``batch_runner`` (``sig.batchable`` and a runner exists)
or to the per-request path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

from repro_torch.core.isa import MachineConfig
from repro_torch.engine.adapters import padded_len
from repro_torch.engine.compile_cache import affinity_token, shard_of_token
from repro_torch.engine.registry import Mechanism, get_mechanism
from repro_torch.engine.types import SimRequest

__all__ = ["ExecSignature", "signature_of", "meta_key", "shard_of"]


def meta_key(meta: Mapping[str, Any]) -> tuple[tuple[str, str], ...]:
    """A hashable, order-independent key for a ``meta`` mapping.

    Values are keyed by ``repr`` so unhashable option values (lists, dicts)
    still coalesce; two requests whose options merely *print* differently
    are conservatively kept apart, which can only split batches, never
    merge incompatible ones.
    """
    return tuple(sorted((str(k), repr(v)) for k, v in meta.items()))


@dataclass(frozen=True)
class ExecSignature:
    """Everything that must match for two requests to share one execution.

    ``batchable`` is request-side eligibility for a native batch runner
    (currently: a default entry mask — ``active0 is None`` — which the
    vmapped JAX path assumes).  Whether a batch runner actually exists is
    a property of the mechanism, not the request; the planner combines
    both (see :func:`repro.service.planner.plan_dispatch`).
    """

    mechanism: str
    cfg: MachineConfig                     # resolved: fuel folded into max_steps
    pad_len: int                           # program-length padding class
    majority_first: bool
    batchable: bool                        # active0 is None
    record_trace: bool
    skip_pcs: tuple[int, ...]
    meta: tuple[tuple[str, str], ...]

    @property
    def key(self) -> str:
        """Compact human-readable form for logs / stats."""
        opts = ",".join(f"{k}={v}" for k, v in self.meta)
        return (f"{self.mechanism}/w{self.cfg.n_threads}"
                f"/L{self.pad_len}/f{self.cfg.max_steps}"
                + ("" if self.majority_first else "/minor")
                + ("" if self.batchable else "/masked")
                + ("" if self.record_trace else "/notrace")
                + (f"/skip{len(self.skip_pcs)}" if self.skip_pcs else "")
                + (f"/{opts}" if opts else ""))

    @property
    def token(self) -> str:
        """The compiled-state locality token of this signature — the same
        string the persistent compile cache stamps into its manifest, so
        process-tier routing and warm-start sharding agree on which shard
        owns which hot jit/executable cache state."""
        return affinity_token(self.mechanism, self.cfg, self.majority_first,
                              self.pad_len)


def shard_of(sig: ExecSignature, n_shards: int) -> int:
    """Signature-affine shard assignment: a stable crc32 of the locality
    token, mod the pool size.  Stable across processes and runs (unlike the
    builtin ``hash``, which is salted per interpreter)."""
    return shard_of_token(sig.token, n_shards)


def signature_of(mechanism: "str | Mechanism", req: SimRequest) -> ExecSignature:
    """Derive the coalescing/dispatch signature of one request."""
    name = mechanism.name if isinstance(mechanism, Mechanism) \
        else get_mechanism(mechanism).name
    return ExecSignature(
        mechanism=name,
        cfg=req.resolved_cfg(),
        pad_len=padded_len(int(np.asarray(req.program).shape[0])),
        majority_first=bool(req.majority_first),
        batchable=req.active0 is None,
        record_trace=bool(req.record_trace),
        skip_pcs=tuple(req.bsync_skip_pcs),
        meta=meta_key(req.meta))
