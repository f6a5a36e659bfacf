"""Layer: the device (H100).  The share of the device's idle time inside
the traced steps during which the host was inside a program ``moe`` span
(%; segment 3 of the traced run: each idle gap put down to the spans open
at its middle, ``chipbench/layer_trace.py``).  As ``device_idle_pct`` is
in a host-paced cell, the profiler's cost a launch makes it an upper
bound.  Nothing to read where no ``moe`` span opens or no device operation
ran."""
from chipbench import layer_trace


def read(run):
    lt = layer_trace.of(run)
    if lt is None or not lt.busy_s or not lt.idle_s or not lt.opened("moe"):
        return None
    return 100.0 * lt.idle_in("moe") / lt.idle_s
