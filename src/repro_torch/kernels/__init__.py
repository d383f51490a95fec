"""Kernels of the port: hand-written Hopper CUDA beside plain PyTorch
versions. Sources are in ``csrc/`` and build at first use (``build.py``).

* minplus        — batched (min, +) product (``ops.minplus_matmul``)
* apsp           — all-pairs min-plus squaring, fused and tiled (``ops.apsp``)
* load_prop      — per-destination load propagation (``ops.load_propagate``)
* flow_accum     — the pair walk's per-hop scatter (``ops.flow_accumulate``)
* selective_scan — Mamba-1 scan forward and backward (``ops.selective_scan``)
"""
from .ops import flow_accumulate, load_propagate, minplus_matmul
from .ref import flow_accumulate_ref, minplus_ref

__all__ = ["minplus_matmul", "load_propagate", "flow_accumulate",
           "minplus_ref", "flow_accumulate_ref"]
