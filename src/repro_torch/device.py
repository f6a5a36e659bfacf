"""Device resolution for the port's entry points.

``device=None`` means the card.  Without one the entry point raises: it never
carries on quietly on the CPU.  Tests ask for the CPU by name.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU and none is visible; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev
