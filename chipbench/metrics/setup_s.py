"""Process start to the first timed step: imports, the program's kernel
build (nvcc on a checkout's first run), drawing the weights and the pool
of prompts, and the warm-up steps of the cell's own shape (host clock)."""


def read(run):
    return run.setup_s
