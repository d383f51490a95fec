# Copy of src/repro/configs/glm4_9b.py (the port's ModelConfig).
"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — partial RoPE, GQA. [hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="decoder",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    attention="gqa",
    qkv_bias=True,           # GLM-4 uses attention bias
    mlp="swiglu",
    rotary_pct=0.5,          # GLM partial rotary
    rope_theta=10000.0,
)
