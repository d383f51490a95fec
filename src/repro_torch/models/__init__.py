"""Model stack of the port (``src/repro/models``): every family's forward,
loss, caches, decode step and prefill (``Model``, ``ModelConfig``,
``reduced``), and the input specifications per assigned shape."""
from .config import ModelConfig, reduced
from .model import Model
from .inputs import (
    ASSIGNED_SHAPES, SHAPES_BY_NAME, ShapeSpec,
    make_inputs, shape_applicable, token_spec,
)

__all__ = [
    "ModelConfig", "reduced", "Model",
    "ASSIGNED_SHAPES", "SHAPES_BY_NAME", "ShapeSpec",
    "make_inputs", "shape_applicable", "token_spec",
]
