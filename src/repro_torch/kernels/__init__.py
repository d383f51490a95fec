"""Kernels of the port: hand-written Hopper CUDA beside plain PyTorch
versions. Sources are in ``csrc/`` and build at first use (``build.py``).

* minplus    — batched (min, +) product (``ops.minplus_matmul``)
* apsp       — all-pairs min-plus squaring, fused and tiled (``ops.apsp``)
* load_prop  — per-destination load propagation (``ops.load_propagate``)
"""
from .ops import load_propagate, minplus_matmul
from .ref import minplus_ref

__all__ = ["minplus_matmul", "load_propagate", "minplus_ref"]
