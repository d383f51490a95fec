"""Device resolution and the population shards for the port's entry
points (no twin in ``repro``).

Every function that takes a ``device`` argument resolves ``None`` to
``"cuda"``: the port runs on the card unless the caller asks for the CPU.
Without a CUDA device that resolution raises instead of carrying on on the
CPU, so a run that meant to measure the card never measures the host.
"""
from __future__ import annotations

from contextlib import nullcontext

import numpy as np
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


def resolve_devices(devices) -> list[torch.device]:
    """``None`` -> every visible CUDA device ``[cuda:0 .. cuda:k-1]``
    (raises without a GPU); one device -> ``[that device]``; a sequence is
    taken as given, repeats included."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")          # raises with the message above
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)]
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("an empty device list")
    return out


def cli_devices(device: str):
    """A CLI's ``--device``: ``cuda`` -> None (every visible card, as
    ``resolve_devices`` reads it), ``cpu`` -> the host."""
    return None if device == "cuda" else device


def on_device(dev: torch.device):
    """Context in which ``dev`` is the current CUDA device (a no-op on the
    CPU), so a shard's launches go to its own device's current stream."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def shard_rows(x: np.ndarray, devices: list[torch.device], dtype
               ) -> list[torch.Tensor]:
    """Cut the rows of ``x`` (a multiple of ``len(devices)``) into equal
    contiguous shards, shard i on ``devices[i]``."""
    s = len(x) // len(devices)
    return [torch.as_tensor(x[i * s:(i + 1) * s], dtype=dtype, device=dev)
            for i, dev in enumerate(devices)]


def gather_rows(shards, Pn: int) -> np.ndarray:
    """The shards' outputs on the host, in shard order, cut to ``Pn``
    rows."""
    return np.concatenate([x.cpu().numpy() for x in shards])[:Pn]


__all__ = ["resolve_device", "resolve_devices", "cli_devices", "on_device",
           "shard_rows", "gather_rows"]
