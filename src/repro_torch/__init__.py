"""RapidChiplet in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro``, module for module
(``repro_torch/core/latency.py`` <-> ``repro/core/latency.py``). It never
imports ``jax`` or ``repro``: numpy host modules are carried over as copies.
Entry points (``core.evaluate_design``, ``dse.DseEngine``) run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
