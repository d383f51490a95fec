"""Model stack of the port (``src/repro/models``): the SSM family's
training path (``Model``, ``ModelConfig``, ``reduced``)."""
from .config import ModelConfig, reduced
from .model import Model

__all__ = ["Model", "ModelConfig", "reduced"]
