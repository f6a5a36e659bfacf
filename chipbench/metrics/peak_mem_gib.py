"""The most device memory the program held during the window, weights
included: ``torch.cuda.max_memory_allocated()`` after a reset at the end
of the warm-up, in GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / 2 ** 30
