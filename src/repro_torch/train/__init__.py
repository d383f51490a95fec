"""Training stack of the port (``src/repro/train``): optimizers as plain
functions on tensors, the train-step builder and the train state."""
from .optimizer import (OptConfig, adafactor_init, adafactor_update,
                        adamw_init, adamw_update)
from .step import make_train_step, microbatches
from .state import (init_train_state, place_train_state,
                    train_state_shardings, train_state_specs)

__all__ = ["OptConfig", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "make_train_step", "microbatches",
           "init_train_state",
           "train_state_specs", "train_state_shardings",
           "place_train_state"]
