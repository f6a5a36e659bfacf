"""Layer: the model (``models/transformer.py::_forward``).  The device
time of the operations launched inside the program's ``cache_stack``
spans (each segment's ``torch.stack`` of its layers' caches), over the
device's busy time (%; segment 3 of the traced run,
``chipbench/layer_trace.py``).  Nothing to read where no cache is stacked
or no device operation ran."""
from chipbench import layer_trace


def read(run):
    lt = layer_trace.of(run)
    if lt is None or not lt.busy_s or not lt.opened("cache_stack"):
        return None
    _, seconds = lt.device_in("cache_stack")
    return 100.0 * seconds / lt.busy_s
