from .specs import (AbstractMesh, batch_pspec, cache_pspecs, data_axes,
                    distribute, local_batch, local_chunk, logical_rules, mesh_shape,
                    param_pspecs, placements)

__all__ = ["AbstractMesh", "batch_pspec", "cache_pspecs", "data_axes",
           "distribute", "local_batch", "local_chunk", "logical_rules", "mesh_shape",
           "param_pspecs", "placements"]
