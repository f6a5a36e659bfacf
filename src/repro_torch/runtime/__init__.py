from .compression import (compressed_allreduce, dequantize_int8,
                          ef_compress_grads, quantize_int8)
from .straggler import StragglerMonitor, rebalance_batches

__all__ = ["StragglerMonitor", "compressed_allreduce", "dequantize_int8",
           "ef_compress_grads", "quantize_int8", "rebalance_batches"]
