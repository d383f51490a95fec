"""Kernels of the port: hand-written Hopper CUDA beside plain PyTorch
versions. Sources are in ``csrc/`` and build at first use (``build.py``)."""
from .ops import load_propagate

__all__ = ["load_propagate"]
