"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
structure and names (``models/base.py``, ``models/layers.py``,
``kernels/ops.py``, ...) and imports nothing of it and nothing of JAX.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
