# Copy of src/repro/configs/deepseek_v2_lite_16b.py (the port's ModelConfig).
"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed experts top-6 + 2 shared — MLA kv_lora=512.
[arXiv:2405.04434; hf]

Note: the assignment inline text says "160 routed" but the headline config
("MoE 64e top-6") and the HF DeepSeek-V2-Lite checkpoint both say 64 routed
experts; we follow 64 (recorded in DESIGN.md §Arch-applicability).
DeepSeek-V2-Lite has no q-LoRA (q_lora_rank=0) and its first layer is dense.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="decoder",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,              # dense-layer FFN (first layer)
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    mlp="swiglu",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10000.0,
)
