# Port of src/repro/models/config.py, with torch dtypes.
"""Model configuration covering all assigned architecture families:
decoder-only transformers (dense / MoE / MLA), SSM (Mamba-1), hybrid
(parallel attention+SSM heads), encoder-decoder (Whisper), and VLM backbones
with stub frontends.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # decoder | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads

    # --- attention ---
    attention: str = "gqa"         # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0        # partial-rotary fraction (glm4, nemotron)
    window: int = 0                # sliding-window size; 0 = full attention

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0           # 0 -> direct q projection (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MLP ---
    mlp: str = "swiglu"            # swiglu | relu2 | gelu

    # --- MoE ---
    n_experts: int = 0             # routed experts; 0 = dense
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    first_dense_layers: int = 0    # leading dense layers (DeepSeek)
    capacity_factor: float = 1.25
    moe_group_size: int = 1024     # tokens per dispatch group

    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 256           # chunked-scan block length (training)
    ssm_kernel: bool = False       # fused selective-scan kernel (B7/B8)

    # --- encoder-decoder (Whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500     # stub conv-frontend output length

    # --- VLM stub frontend ---
    n_image_tokens: int = 0        # patch embeddings provided by input_specs

    # --- numerics / compilation ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Cast the whole f32 param tree to bf16 at loss entry so FSDP gathers
    # move bf16 instead of f32 (§Perf A it5; masters stay f32 in the
    # optimizer state).
    cast_params_bf16: bool = False
    scan_layers: bool = True
    remat: str = "full"            # none | full | dots
    attn_chunk_q: int = 1024       # flash-chunk block sizes (0 = never chunk)
    attn_chunk_kv: int = 1024
    attn_chunk_threshold: int = 2048   # chunk when seq >= threshold
    logit_softcap: float = 0.0

    # --- sharding hints (the reference's field, kept for its configs;
    # neither package's sharding rules read it) ---
    seq_shard_threshold: int = 16384   # sequence-parallel residual stream

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.ssm_state and self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank",
                               -(-self.d_model // 16))

    # ------------------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def uses_attention(self) -> bool:
        return self.attention != "none"

    @property
    def uses_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this model decode with a cache that does not grow with the
        full context (SSM state or sliding window)? Decides long_500k."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return self.window > 0
        return False

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "none":
            return 0
        if self.attention == "mla":
            qd = self.n_heads * (self.nope_head_dim + self.rope_head_dim)
            p = (d * self.q_lora_rank + self.q_lora_rank * qd
                 if self.q_lora_rank else d * qd)
            p += d * (self.kv_lora_rank + self.rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (
                self.nope_head_dim + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        return (d * self.n_heads * self.d_head             # q
                + 2 * d * self.n_kv_heads * self.d_head    # kv
                + self.n_heads * self.d_head * d)           # o

    def _ssm_params(self) -> int:
        if not self.uses_ssm:
            return 0
        d, di = self.d_model, self.d_inner
        return (d * 2 * di + di * d                        # in/out proj
                + di * self.ssm_conv                        # depthwise conv
                + di * (self.ssm_dt_rank + 2 * self.ssm_state)   # x_proj
                + self.ssm_dt_rank * di                     # dt proj
                + di * self.ssm_state + di)                 # A_log, D

    def n_params(self) -> int:
        """Parameter count (embeddings + blocks), for the roofline's
        MODEL_FLOPS = 6*N*D utilization ratio."""
        d, l = self.d_model, self.n_layers
        mult = 3 if self.mlp == "swiglu" else 2
        mlp_dense = 0 if self.family == "ssm" else mult * d * self.d_ff
        mlp_moe = (d * self.n_experts +
                   (self.n_experts + self.n_shared_experts) *
                   mult * d * self.moe_d_ff)
        mixer = self._attn_params() + self._ssm_params()
        if self.is_moe:
            moe_layers = l - self.first_dense_layers
            blocks = (moe_layers * (mixer + mlp_moe) +
                      self.first_dense_layers * (mixer + mlp_dense))
        else:
            blocks = l * (mixer + mlp_dense)
        if self.family == "encdec":
            # decoder layers additionally carry cross-attention
            blocks += l * self._attn_params()
            blocks += self.n_encoder_layers * (self._attn_params() + mlp_dense)
        p = self.vocab_size * d * 2 + blocks    # untied embed + unembed
        return int(p)

    def active_params(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.n_params()
        mult = 3 if self.mlp == "swiglu" else 2
        moe_layers = self.n_layers - self.first_dense_layers
        inactive = moe_layers * (self.n_experts - self.top_k) * \
            mult * self.d_model * self.moe_d_ff
        return int(self.n_params() - inactive)

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    shrink = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        moe_group_size=64,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        attn_chunk_threshold=64,
        ssm_chunk=16,
    )
    if cfg.is_moe:
        shrink.update(n_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32,
                      n_shared_experts=min(cfg.n_shared_experts, 1),
                      first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.uses_ssm:
        shrink.update(ssm_state=8, ssm_dt_rank=8)
    if cfg.attention == "mla":
        shrink.update(kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
                      v_head_dim=16)
    if cfg.family == "encdec":
        shrink.update(n_encoder_layers=2, n_audio_frames=24)
    if cfg.family == "vlm":
        shrink.update(n_image_tokens=8)
    if cfg.window:
        shrink.update(window=32)
    shrink.update(overrides)
    return cfg.replace(**shrink)
