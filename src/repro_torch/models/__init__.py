"""Model stack of the port (``src/repro/models``): every decoder-only
family's forward, loss, caches, decode step and prefill (``Model``,
``ModelConfig``, ``reduced``)."""
from .config import ModelConfig, reduced
from .model import Model

__all__ = ["Model", "ModelConfig", "reduced"]
