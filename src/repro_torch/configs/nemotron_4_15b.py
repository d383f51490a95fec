# Copy of src/repro/configs/nemotron_4_15b.py (the port's ModelConfig).
"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP, partial rotary.
[arXiv:2402.16819; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="decoder",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    attention="gqa",
    mlp="relu2",             # squared-ReLU (Nemotron / Primer)
    rotary_pct=0.5,          # Nemotron uses 50% partial rotary
    rope_theta=10000.0,
)
