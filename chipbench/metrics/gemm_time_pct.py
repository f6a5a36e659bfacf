"""Layer: the layers (``models/layers.py``, ``models/moe.py``,
``models/recurrent.py``).  The share of the device's busy time in the
traced steps that matrix-product kernels take (%).

Matrix products are the kernels whose names match ``GEMM``: cuBLAS's and
cuBLASLt's (``gemm``, ``gemv``, ``nvjet``, ``xmma``, ``cublas``, split-K
reductions) and CUTLASS's (``cutlass``)."""

GEMM = r"(?i)gemm|gemv|nvjet|xmma|cublas|cutlass|splitKreduce"


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    _, seconds = run.trace.ops_matching(GEMM)
    return 100.0 * seconds / run.trace.busy_s
