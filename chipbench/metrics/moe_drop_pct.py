"""Layer: the layers, MoE (``models/moe.py``).  The share of routed slots
(a token's place in one of its top-k experts) that overflowed the
expert's capacity in their group and were dropped: the program's counters
``moe.dropped`` over ``moe.slots`` (%; segment 4 of the traced run,
``chipbench/layer_trace.py``).  Nothing to read where no slot was routed."""
from chipbench import layer_trace


def read(run):
    lt = layer_trace.of(run)
    if lt is None or not lt.counters.get("moe.slots"):
        return None
    return 100.0 * lt.counters.get("moe.dropped", 0) \
        / lt.counters["moe.slots"]
