"""Benchmark of the PyTorch/CUDA port: see ``perfbench/run.py``."""
