"""Input specifications per (architecture x assigned shape); port of the host
part of ``src/repro/models/inputs.py``.

``token_spec`` returns ``(shape, torch.dtype)`` pairs where the reference
returns ``jax.ShapeDtypeStruct``s (the dry-run that lowers them waits for
ROADMAP Queue A 14c); ``make_inputs`` materializes small random inputs for
smoke tests, equal to the reference's for the same seed bit for bit.
Modality frontends are stubs per the assignment: the VLM's patch embeddings
and Whisper's frame embeddings arrive as inputs, in bf16 as the reference
keeps them (its local ``f32`` is ``jnp.bfloat16``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import resolve_device
from .config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


ASSIGNED_SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in ASSIGNED_SHAPES}


def shape_applicable(cfg: ModelConfig, spec: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped). long_* needs sub-quadratic attention
    (SSM state / sliding window); pure full-attention archs skip it."""
    if spec.name.startswith("long") and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k-token quadratic attention "
                       "excluded per assignment (see DESIGN.md)")
    return True, ""


def token_spec(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """{input name: (shape, dtype)} for every model input of the step
    kind."""
    b, s = spec.global_batch, spec.seq_len
    emb = torch.bfloat16
    i32 = torch.int32
    if spec.kind in ("train", "prefill"):
        s_text = s - (cfg.n_image_tokens if cfg.family == "vlm" else 0)
        d = {"tokens": ((b, s_text), i32)}
        if spec.kind == "train":
            d["labels"] = ((b, s_text), i32)
        if cfg.family == "vlm":
            d["patches"] = ((b, cfg.n_image_tokens, cfg.d_model), emb)
        if cfg.family == "encdec":
            d["frames"] = ((b, cfg.n_audio_frames, cfg.d_model), emb)
        return d
    # decode: one new token against a cache of seq_len
    return {"tokens": ((b, 1), i32), "pos": ((), i32)}


def make_inputs(cfg: ModelConfig, spec: ShapeSpec, seed: int = 0,
                device=None) -> dict:
    """Materialized random inputs on ``device`` (the card unless the caller
    passes ``device="cpu"``), drawn from numpy in the reference's order:
    token ids as int32, the stub embeddings as float64 normals rounded to
    float32 and then to bf16, as the reference's conversion rounds them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype) in token_spec(cfg, spec).items():
        if dtype == torch.int32:
            if k == "pos":
                t = torch.tensor(spec.seq_len - 1, dtype=torch.int32)
            else:
                t = torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, shape).astype(np.int32))
        else:
            t = torch.from_numpy(rng.normal(0, 1, shape).astype(
                np.float32)).to(dtype)
        out[k] = t.to(dev)
    return out


__all__ = ["ShapeSpec", "ASSIGNED_SHAPES", "SHAPES_BY_NAME",
           "shape_applicable", "token_spec", "make_inputs"]
