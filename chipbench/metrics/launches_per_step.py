"""Layer: the model (``models/transformer.py::forward``).  Device
operations (kernels, copies, fills) in the traced steps, a step.  Fusion
moves it."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.device_ops) / run.trace.steps
