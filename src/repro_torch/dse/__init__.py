from .sweep import ExperimentSpec, expand_experiments, DesignPoint
from .batch import DesignBatch, batch_from_numpy, encode_designs
from .engine import batched_evaluate, DseEngine, DseResult

__all__ = [
    "ExperimentSpec", "expand_experiments", "DesignPoint",
    "DesignBatch", "batch_from_numpy", "encode_designs",
    "batched_evaluate", "DseEngine", "DseResult",
]
