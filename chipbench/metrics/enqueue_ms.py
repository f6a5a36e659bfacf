"""Layer: the entry (``launch/steps.py::prefill``).  The host's wall from
the call to ``prefill`` to its return, before the wait for the device,
averaged over the window's steps (host clock, ms).  Near the step's wall,
the host sets the pace."""


def read(run):
    return 1e3 * sum(run.enqueue) / len(run.enqueue)
