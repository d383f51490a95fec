# Copy of src/repro/configs/llava_next_34b.py (the port's ModelConfig).
"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling frontend (STUB: input_specs provides
precomputed patch embeddings). [hf:llava-hf/llava-v1.6-*; unverified]

The backbone is the Yi-34B-class decoder; the vision tower + anyres tiling
is a modality frontend stub per the assignment: 576 patch embeddings are
prepended to the text sequence (within the assigned seq_len budget).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    attention="gqa",
    mlp="swiglu",
    rope_theta=5000000.0,
    n_image_tokens=576,
)
