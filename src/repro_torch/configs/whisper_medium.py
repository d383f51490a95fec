# Copy of src/repro/configs/whisper_medium.py (the port's ModelConfig).
"""whisper-medium [audio]: 24L d_model=1024 16H d_ff=4096 vocab=51865 —
encoder-decoder; conv frontend STUB (input_specs provides precomputed frame
embeddings, 1500 frames). [arXiv:2212.04356; unverified]

Whisper-medium is 24 encoder + 24 decoder layers, LayerNorm + GELU, learned
positions, full (not rotary) attention. The decoder serves the decode
shapes (self-attn KV cache + fixed cross-attention KV).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,             # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    attention="gqa",
    mlp="gelu",
    rotary_pct=0.0,          # learned absolute positions, no RoPE
    n_audio_frames=1500,
)
