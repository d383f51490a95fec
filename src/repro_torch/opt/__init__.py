"""Search spaces of the design-space optimizers (port of
``src/repro/opt``; the optimizers, archive and runner are not ported yet)."""
from .space import (DEFAULT_TOPOLOGIES, AdjacencySpace, ParametricSpace,
                    SearchSpace)

__all__ = ["DEFAULT_TOPOLOGIES", "AdjacencySpace", "ParametricSpace",
           "SearchSpace"]
