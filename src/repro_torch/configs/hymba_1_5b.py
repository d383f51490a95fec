# Copy of src/repro/configs/hymba_1_5b.py (the port's ModelConfig).
"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads.
[arXiv:2411.13676; hf]

Each block computes sliding-window attention and a Mamba mixer on the same
normed input and sums them (the paper's parallel-head hybrid). Deviations
recorded in DESIGN.md: all attention layers use SWA (the released model
keeps 3 full-attention layers) and meta tokens are omitted. The SWA ring
cache + O(1) SSM state make long_500k runnable.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab_size=32001,
    attention="gqa",
    window=2048,
    mlp="swiglu",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_dt_rank=100,
    rope_theta=10000.0,
)
