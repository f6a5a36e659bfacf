"""Layer: the layers, MoE (``models/moe.py``).  The device time of the
operations launched inside the program's ``moe.route``, ``moe.dispatch``
and ``moe.combine`` spans (the router's top-k, the groups' sort, scatter
and gather), over the device's busy time (%; segment 3 of the traced run,
``chipbench/layer_trace.py``).  Nothing to read where no ``moe`` span
opens or no device operation ran."""
from chipbench import layer_trace

ROUTING = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    lt = layer_trace.of(run)
    if lt is None or not lt.busy_s or not lt.opened("moe"):
        return None
    _, seconds = lt.device_in(*ROUTING)
    return 100.0 * seconds / lt.busy_s
