"""Layer: the layers, MoE (``models/moe.py``), the sigmoid router.  The
share of routed slots whose expert the router's correction bias changed:
the program's counters ``moe.bias_moved`` (a token's k less the size of
its biased and unbiased top k's intersection) over ``moe.slots`` (%;
segment 4 of the traced run, ``chipbench/layer_trace.py``).  Nothing to
read where the program counts no such slot (a softmax router, or a
program without the counter)."""
from chipbench import layer_trace


def read(run):
    lt = layer_trace.of(run)
    if lt is None or "moe.bias_moved" not in lt.counters \
            or not lt.counters.get("moe.slots"):
        return None
    return 100.0 * lt.counters["moe.bias_moved"] / lt.counters["moe.slots"]
