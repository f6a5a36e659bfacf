"""Parameters from the JAX package, so that both compute the same function.

The JAX package draws its weights from ``jax.random`` and this port from a
``torch.Generator``; the two give different numbers from one seed.  A test
materializes the weights with the JAX package, hands them over as numpy
arrays (this module never imports JAX), and builds the port's model from
them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve

from .base import ModelConfig, tree_map
from .transformer import Transformer


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                                   # own, writable copy
    if a.dtype.name == "bfloat16":                    # ml_dtypes' bf16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def tensors_from_jax(tree, device=None):
    """A JAX param or cache tree (every leaf a numpy array) as torch tensors
    in the same layout."""
    dev = resolve(device)
    return tree_map(lambda a: _tensor(a, dev), tree)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Transformer:
    """The port's model from the JAX param tree of ``cfg``: stacked
    ``[L, ...]`` per segment, ``tree["segments"][i]["0"]["attn"]["wq"]``."""
    return Transformer(cfg, tensors_from_jax(tree, device))
