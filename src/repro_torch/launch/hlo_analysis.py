"""Roofline terms of a cell on one NVIDIA H100 (port of
``repro.launch.hlo_analysis``).

The JAX package reads a compiled module's ``cost_analysis()`` and its HLO
text; the port counts one run of the cell's step on a rank's shards
(``launch/hlo_static.py``, through ``launch/steps.py::lower_cell``) and
scores it against the card's datasheet:

* 989e12 FLOP/s: bf16 dense on the tensor cores (H100 SXM5);
* 3.35e12 B/s: HBM3 (H100 SXM5, 80 GB);
* 450e9 B/s: NVLink 4 per direction (900 GB/s both ways, H100 SXM5).

All three assume the card's full power limit, 700 W; the card of the
repo's chip runs reports "NVIDIA H100 80GB HBM3, 700.00 W".  A rank's
collectives are priced at the NVLink rate, as if each rank were a card
of an NVLink domain; a mesh of 256 or 512 ranks spans many hosts, so the
collective term is a lower bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclass
class Roofline:
    flops: float               # per-rank FLOPs
    hbm_bytes: float           # per-rank bytes into and out of its ops
    coll_bytes: float          # per-rank collective bytes
    collectives: CollectiveStats | None = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline lower bound: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "coll_by_kind": dict(self.collectives.bytes_by_kind)
            if self.collectives else {},
            "coll_count_by_kind": dict(self.collectives.count_by_kind)
            if self.collectives else {},
        }


def analyze_cell(lowered) -> Roofline:
    """The roofline terms of a lowered cell (``steps.lower_cell``): its
    counted FLOPs, op bytes and collective bytes (the counterpart of
    ``analyze_compiled``, whose trip-count corrections the eager run makes
    unnecessary)."""
    st = lowered.cost
    cs = CollectiveStats(bytes_by_kind=dict(st.coll_bytes_by_kind),
                         count_by_kind=dict(st.coll_count_by_kind))
    return Roofline(flops=st.flops, hbm_bytes=st.hbm_bytes,
                    coll_bytes=st.coll_bytes, collectives=cs)


def _paths(tree, prefix=()):
    """(path, leaf) of a structure tree, dict keys and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    else:
        yield prefix, tree


def model_flops(cfg, shape, *, backward: bool) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) 'useful' flops for the cell."""
    from repro_torch.models import model_struct
    n = 0
    for path, leaf in _paths(model_struct(cfg)):
        size = 1
        for d in leaf.shape:
            size *= d
        keys = "/".join(path)
        if cfg.n_experts and ("w_gate" in keys or "w_up" in keys
                              or "w_down" in keys) and "shared" not in keys \
                and "segments" in keys and size >= cfg.n_experts:
            # routed expert weights: only top-k/E of them are active
            size = size * cfg.experts_per_token // cfg.n_experts
        n += size
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6 if backward else 2
    return float(mult) * n * tokens
