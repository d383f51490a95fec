# Copy of src/repro/configs/qwen2_5_3b.py (the port's ModelConfig).
"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA with QKV bias. [hf:Qwen/Qwen2.5-*; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="decoder",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1000000.0,
)
