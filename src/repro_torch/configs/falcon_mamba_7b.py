# Copy of src/repro/configs/falcon_mamba_7b.py (the port's ModelConfig).
"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — Mamba-1 architecture. [arXiv:2410.05355; unverified]

Attention-free: O(1) decode state, so this arch runs the long_500k shape
(DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,               # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab_size=65024,
    attention="none",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_dt_rank=256,
    ssm_chunk=256,
)
