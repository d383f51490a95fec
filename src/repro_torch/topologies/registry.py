# Copy of src/repro/topologies/registry.py, kept so repro_torch never imports repro.
"""Topology registry (paper §2.3.3): 16 ICI topology generators behind one
name-based interface, plus per-topology diameter bounds for the throughput
proxy's static hop count.
"""
from __future__ import annotations

import math
from typing import Callable

from . import grid as _g
from . import hex as _h
from . import interposer as _i

Edge = tuple[int, int]


def _grid_args(n: int) -> tuple[int, int]:
    return _g.grid_dims(n)


def _wrap_grid(fn: Callable[[int, int], list[Edge]]):
    def gen(n: int, **kw) -> list[Edge]:
        r, c = _grid_args(n)
        return fn(r, c, **kw)
    return gen


def custom_edges(n: int, edges=()) -> list[Edge]:
    """Validate + canonicalize an explicit link list (PlaceIT-style free-form
    topologies; the optimizer's adjacency genome decodes through this).

    Accepts any iterable of (u, v) chiplet-index pairs; returns the sorted,
    deduplicated undirected edge list. Raises on self-loops and out-of-range
    indices."""
    edges = list(edges)
    if not edges:
        raise ValueError("custom topology requires a non-empty edges list")
    seen: set[Edge] = set()
    for (u, v) in edges:
        u, v = int(u), int(v)
        if u == v:
            raise ValueError(f"custom topology: self-loop on chiplet {u}")
        if not (0 <= u < n and 0 <= v < n):
            raise ValueError(
                f"custom topology: edge ({u},{v}) out of range for n={n}")
        seen.add((min(u, v), max(u, v)))
    return sorted(seen)


# name -> (edge generator over n chiplets, uses_interposer_routers, placement)
TOPOLOGIES: dict[str, dict] = {
    "custom":           {"gen": custom_edges, "routers": False, "placement": "grid"},
    "mesh":             {"gen": _wrap_grid(_g.mesh), "routers": False, "placement": "grid"},
    "torus":            {"gen": _wrap_grid(_g.torus), "routers": False, "placement": "grid"},
    "folded_torus":     {"gen": _wrap_grid(_g.folded_torus), "routers": False, "placement": "grid"},
    "flattened_butterfly": {"gen": _wrap_grid(_g.flattened_butterfly), "routers": False, "placement": "grid"},
    "shg":              {"gen": None, "routers": False, "placement": "grid"},   # parametrized; see shg_design
    "sid_mesh":         {"gen": _wrap_grid(_g.sid_mesh), "routers": False, "placement": "grid"},
    "octamesh":         {"gen": _wrap_grid(_g.octamesh), "routers": False, "placement": "grid"},
    "octatorus":        {"gen": _wrap_grid(_g.octatorus), "routers": False, "placement": "grid"},
    "folded_octatorus": {"gen": _wrap_grid(_g.folded_octatorus), "routers": False, "placement": "grid"},
    "hypercube":        {"gen": _g.hypercube, "routers": False, "placement": "grid"},
    "hexamesh":         {"gen": _wrap_grid(_h.hexamesh), "routers": False, "placement": "hex"},
    "hexatorus":        {"gen": _wrap_grid(_h.hexatorus), "routers": False, "placement": "hex"},
    "folded_hexatorus": {"gen": _wrap_grid(_h.folded_hexatorus), "routers": False, "placement": "hex"},
    "double_butterfly": {"gen": _wrap_grid(_i.double_butterfly), "routers": True, "placement": "grid"},
    "butterdonut":      {"gen": _wrap_grid(_i.butterdonut), "routers": True, "placement": "grid"},
    "cluscross":        {"gen": _wrap_grid(_i.cluscross), "routers": True, "placement": "grid"},
    "kite":             {"gen": _wrap_grid(_i.kite), "routers": True, "placement": "grid"},
}


def topology_edges(name: str, n: int, **kw) -> list[Edge]:
    if name == "shg":
        bits = kw.pop("bits", 0)
        r, c = _grid_args(n)
        return _g.shg_from_bits(r, c, bits)
    try:
        spec = TOPOLOGIES[name]
    except KeyError:
        raise ValueError(f"unknown topology {name!r}; options: "
                         f"{sorted(TOPOLOGIES)}") from None
    return spec["gen"](n, **kw)


def diameter_bound(name: str, n: int) -> int:
    """A safe (not necessarily tight) bound on the routed diameter, used as
    the static hop count of the flow accumulation. Interposer topologies get
    +2 for the chiplet->router attach hops."""
    r, c = _grid_args(n)
    bounds = {
        "mesh": r + c,
        "torus": r // 2 + c // 2 + 2,
        "folded_torus": r // 2 + c // 2 + 2,
        "flattened_butterfly": 3,
        "shg": r + c,
        "sid_mesh": max(r, c) + 1,
        "octamesh": max(r, c) + 1,
        "octatorus": max(r, c) // 2 + 2,
        "folded_octatorus": max(r, c) // 2 + 2,
        "hypercube": max(1, int(math.log2(max(n, 2)))) + 1,
        "hexamesh": r + c,
        "hexatorus": r // 2 + c // 2 + 2,
        "folded_hexatorus": r // 2 + c // 2 + 2,
        "double_butterfly": r + c,
        "butterdonut": r + c,
        "cluscross": r + c + 2,
        "kite": (r + c) // 2 + 3,
    }
    b = bounds.get(name, n - 1)
    if TOPOLOGIES.get(name, {}).get("routers", False):
        b += 2
    # up*/down* detours can exceed shortest-path bounds; stay safe.
    return min(max(b + 2, 4), max(n, 4))
