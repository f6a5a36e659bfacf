"""Layer: the layers, MoE (``models/moe.py``).  Device operations
(kernels, copies, fills) launched inside the program's ``moe`` spans, a
step (segment 3 of the traced run: each operation put down to the spans
open at its launch, ``chipbench/layer_trace.py``).  Nothing to read where
no ``moe`` span opens or no device operation ran."""
from chipbench import layer_trace


def read(run):
    lt = layer_trace.of(run)
    if lt is None or not lt.busy_s or not lt.opened("moe"):
        return None
    n, _ = lt.device_in("moe")
    return n / lt.steps_3
