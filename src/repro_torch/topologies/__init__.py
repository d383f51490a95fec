# Copy of src/repro/topologies/__init__.py, kept so repro_torch never imports repro.
from .registry import TOPOLOGIES, topology_edges, diameter_bound, custom_edges
from .factory import make_design, make_chiplet, grid_placement, hex_placement

__all__ = [
    "TOPOLOGIES", "topology_edges", "diameter_bound", "custom_edges",
    "make_design", "make_chiplet", "grid_placement", "hex_placement",
]
