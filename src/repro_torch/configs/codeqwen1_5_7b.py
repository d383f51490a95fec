# Copy of src/repro/configs/codeqwen1_5_7b.py (the port's ModelConfig).
"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (MHA kv=32) d_ff=13440
vocab=92416 — qwen1.5 architecture (QKV bias).
[hf:Qwen/CodeQwen1.5-7B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="decoder",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    attention="gqa",
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1000000.0,
)
