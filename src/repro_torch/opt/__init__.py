# Port of src/repro/opt/__init__.py: the same exports.
"""Population-based multi-objective ICI design optimization.

The paper positions the proxies as "a cost function for optimization
algorithms"; this package is that consumer. Search spaces encode designs as
integer genomes (registered parametric topologies or PlaceIT-style free-form
adjacency), seeded vectorized operators vary whole populations, and every
generation is one batched proxy evaluation on the engine's device
(``DseEngine.evaluate_genomes``). A Pareto archive with a 2-D hypervolume
indicator and area/power/cost constraint masks tracks the front; the runner
checkpoints optimizer state after every generation and resumes
bit-identically.

``archive``/``operators`` are dependency-light and imported eagerly (the
sweep-side ``dse.pareto`` re-exports the front computation from here); the
engine-facing modules load lazily on first attribute access.
"""
from .archive import ArchiveEntry, ParetoArchive, hypervolume_2d, pareto_front
from .operators import mutate_genes, tournament_select, uniform_crossover

_LAZY = {
    "SearchSpace": "space", "ParametricSpace": "space",
    "AdjacencySpace": "space", "DEFAULT_TOPOLOGIES": "space",
    "Budgets": "algorithms", "PopulationEvaluator": "algorithms",
    "EvaluatedPopulation": "algorithms", "EvolutionarySearch": "algorithms",
    "SimulatedAnnealing": "algorithms", "RandomSearch": "algorithms",
    "ALGORITHMS": "algorithms", "nondominated_ranks": "algorithms",
    "crowding_distance": "algorithms",
    "OptRunner": "runner", "OptResult": "runner", "AsyncStepper": "runner",
    "make_space": "runner", "make_optimizer": "runner",
    "save_checkpoint": "runner", "load_checkpoint": "runner",
}

__all__ = [
    "ArchiveEntry", "ParetoArchive", "hypervolume_2d", "pareto_front",
    "mutate_genes", "tournament_select", "uniform_crossover",
    *sorted(_LAZY),
]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
