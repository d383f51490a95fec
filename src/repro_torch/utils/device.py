"""Device resolution for the port's entry points (no twin in ``repro``).

Every function that takes a ``device`` argument resolves ``None`` to
``"cuda"``: the port runs on the card unless the caller asks for the CPU.
Without a CUDA device that resolution raises instead of carrying on on the
CPU, so a run that meant to measure the card never measures the host.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a visible GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path on "
            "the host")
    return dev


__all__ = ["resolve_device"]
