from .compression import (compressed_allreduce, dequantize_int8,
                          ef_compress_grads, quantize_int8)
from .elastic import full_tensor, reshard_tree, survivors_mesh
from .straggler import StragglerMonitor, rebalance_batches

__all__ = ["StragglerMonitor", "compressed_allreduce", "dequantize_int8",
           "ef_compress_grads", "full_tensor", "quantize_int8",
           "rebalance_batches", "reshard_tree", "survivors_mesh"]
