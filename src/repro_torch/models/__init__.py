"""Model stack of the port (``src/repro/models``): every family's forward,
loss, caches, decode step and prefill (``Model``, ``ModelConfig``,
``reduced``), the input specifications per assigned shape, and the
caches of both packages as arrays (``cache_arrays``)."""
from .config import ModelConfig, reduced
from .convert import cache_arrays
from .model import Model
from .inputs import (
    ASSIGNED_SHAPES, SHAPES_BY_NAME, ShapeSpec,
    make_inputs, shape_applicable, token_spec,
)

__all__ = [
    "ModelConfig", "reduced", "Model", "cache_arrays",
    "ASSIGNED_SHAPES", "SHAPES_BY_NAME", "ShapeSpec",
    "make_inputs", "shape_applicable", "token_spec",
]
