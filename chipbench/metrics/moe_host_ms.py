"""Layer: the layers, MoE (``models/moe.py``).  The host's wall a step
inside the program's ``moe`` spans: routing, dispatch, the experts, the
combine and the shared experts, as Python issues them (ms; segment 4 of
the traced run, no profiler: ``chipbench/layer_trace.py``).  Nothing to
read where no ``moe`` span opens."""
from chipbench import layer_trace


def read(run):
    lt = layer_trace.of(run)
    if lt is None or not lt.opened("moe"):
        return None
    return 1e-6 * lt.host_ns["moe"] / lt.steps
