# Copy of src/repro/configs/olmoe_1b_7b.py (the port's ModelConfig).
"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="decoder",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,               # unused (all layers MoE); kept for the record
    vocab_size=50304,
    attention="gqa",
    mlp="swiglu",
    n_experts=64,
    n_shared_experts=0,
    top_k=8,
    moe_d_ff=1024,
    rope_theta=10000.0,
)
