"""Training stack of the port (``src/repro/train``): optimizers as plain
functions on tensors and the train-step builder."""
from .optimizer import (OptConfig, adafactor_init, adafactor_update,
                        adamw_init, adamw_update)
from .step import make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "make_train_step"]
