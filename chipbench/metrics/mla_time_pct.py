"""Layer: the layers, latent attention (``models/mla.py``).  The device
time of the operations launched inside the program's ``mla`` spans (the
query, the latent and its expansion, K3, the output projection), over the
device's busy time (%; segment 3 of the traced run,
``chipbench/layer_trace.py``).  Nothing to read where no ``mla`` span
opens or no device operation ran."""
from chipbench import layer_trace


def read(run):
    lt = layer_trace.of(run)
    if lt is None or not lt.busy_s or not lt.opened("mla"):
        return None
    _, seconds = lt.device_in("mla")
    return 100.0 * seconds / lt.busy_s
