"""A pod of accelerators' interconnect modeled with RapidChiplet itself;
port of ``src/repro/core/ici_model.py``.

A pod is, structurally, exactly the object the paper models: an
interconnect of dies (chips instead of chiplets) with fixed per-link
bandwidth and a 2D-torus (or mesh) topology. This module builds that
design, generates the traffic matrices of the standard collectives (ring
all-gather / reduce-scatter / all-reduce, all-to-all), and predicts their
sustained bandwidth with the paper's throughput proxy. The sharding layer
(``sharding/autoshard``) ranks collective schedules with these
predictions.

The one hardware input is the per-link, per-direction bandwidth
``link_bw`` (bytes/s), an argument of every function that prices. It
defaults to ``NVLINK4_LINK_BW``, one NVLink 4 link of an H100 SXM5; a
caller modelling another machine passes its own. ``tpu_pod_design`` keeps
the reference's name: it models the pod's 16 x 16 torus shape.

``estimate_collective`` runs the proxies on ``device`` (None -> cuda,
which raises without a GPU): the routing table and the traffic go to the
device, ``core/throughput.edge_flows`` takes load propagation (on CUDA the
kernel, B1 up to 160 chips and B2's slab form above, so the 16 x 16 pod
runs B2), and ``average_latency`` and ``routed_diameter`` run there too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .design import Packaging, Technology
from .latency import average_latency, routed_diameter
from .proxies import prepare_arrays
from .throughput import edge_flows
from ..topologies import make_design
from ..utils.device import resolve_device

# One NVLink 4 link of an H100 SXM5, per direction, in bytes/s. NVIDIA's
# H100 Tensor Core GPU datasheet gives 900 GB/s of NVLink bandwidth over 18
# links: 50 GB/s a link, 25 GB/s each way.
NVLINK4_LINK_BW = 25e9


def tpu_pod_design(rows: int = 16, cols: int = 16, wrap: bool = True,
                   link_bw: float = NVLINK4_LINK_BW):
    """A pod as a RapidChiplet design: chips are 'chiplets' on a 2D torus
    (wrap=True) or mesh. Link bandwidths are overridden to ``link_bw``
    (bytes/s per direction) instead of bump-derived wire counts."""
    topo = "torus" if wrap else "mesh"
    design = make_design(
        topo, rows * cols,
        packaging=Packaging(name="tpu_ici", link_latency_per_mm=0.0,
                            link_latency_const=1.0),
        technology=Technology(name="tpu_chip"),
        chiplet_kwargs={"base_area": 300.0, "internal_latency": 1.0,
                        "phy_latency": 0.0, "technology": "tpu_chip"},
    )
    arrays, g = prepare_arrays(design)
    g.adj_bw = np.where(np.isfinite(g.adj_lat), link_bw, 0.0)
    arrays = dataclasses.replace(arrays, adj_bw=g.adj_bw.astype(np.float32))
    return design, arrays, g


def _pod_structure(rows: int, cols: int, wrap: bool, link_bw: float,
                   device: torch.device):
    """Cached (arrays, routed diameter, device tensors) of the pod design.

    ``estimate_collective`` is autoshard's inner loop, so the 256-chip pod
    graph and routing table are built once, in the shared sweep-preparation
    cache (``core/structure_cache``), and so are their copies on each
    device. The cached arrays and tensors are shared and read-only."""
    from .structure_cache import GLOBAL_STRUCTURE_CACHE, StructureEntry

    key = ("tpu_pod", rows, cols, wrap, float(link_bw))

    def build():
        _, arrays, _ = tpu_pod_design(rows, cols, wrap, link_bw)
        return StructureEntry(arrays=arrays)

    entry = GLOBAL_STRUCTURE_CACHE.get_or_build(key, build)
    on_dev = entry.extra.get(str(device))
    if on_dev is None:
        a = entry.arrays
        on_dev = {name: torch.from_numpy(getattr(a, name)).to(device)
                  for name in ("next_hop", "step_cost", "node_weight",
                               "adj_bw")}
        entry.extra[str(device)] = on_dev
    if entry.diameter is None:
        entry.diameter = max(routed_diameter(on_dev["next_hop"]), 1)
    return entry.arrays, entry.diameter, on_dev


# ---------------------------------------------------------------------------
# Collective traffic patterns over the pod grid
# ---------------------------------------------------------------------------

def _ring_order(rows: int, cols: int, axis: str) -> list[list[int]]:
    """Chip-index rings along the chosen mesh axis ('data' = rows of the
    grid, i.e. ring over columns; 'model' = columns)."""
    rings = []
    if axis in ("data", "row"):
        for r in range(rows):
            rings.append([r * cols + c for c in range(cols)])
    elif axis in ("model", "col"):
        for c in range(cols):
            rings.append([r * cols + c for r in range(rows)])
    else:
        raise ValueError(f"unknown pod axis {axis!r}")
    return rings


def collective_traffic(kind: str, rows: int, cols: int, axis: str,
                       bytes_per_device: float) -> np.ndarray:
    """Traffic matrix of one collective over the pod grid.

    Ring collectives (all_gather / reduce_scatter / all_reduce) move
    (k-1)/k * bytes per device (2x for all_reduce) around the ring on
    bidirectional rings, so each device sends half that volume to each ring
    neighbor. all_to_all sends bytes/k to every ring member.
    """
    n = rows * cols
    t = np.zeros((n, n), np.float64)
    for ring in _ring_order(rows, cols, axis):
        k = len(ring)
        if k < 2:
            continue
        if kind in ("all_gather", "reduce_scatter", "all_reduce"):
            per_neighbor = bytes_per_device * (k - 1) / k / 2.0
            if kind == "all_reduce":
                per_neighbor *= 2.0    # reduce-scatter + all-gather phases
            for i, u in enumerate(ring):
                t[u, ring[(i + 1) % k]] += per_neighbor
                t[u, ring[(i - 1) % k]] += per_neighbor
        elif kind == "all_to_all":
            per_pair = bytes_per_device / k
            for u in ring:
                for v in ring:
                    if u != v:
                        t[u, v] += per_pair
        else:
            raise ValueError(f"unknown collective {kind!r}")
    return t


@dataclass(frozen=True)
class CollectiveEstimate:
    kind: str
    axis: str
    bytes_per_device: float
    analytic_s: float          # ring formula at full per-link bandwidth
    proxy_sustained_fraction: float   # RapidChiplet throughput proxy
    proxy_s: float             # analytic_s / sustained fraction
    proxy_latency_cycles: float


def analytic_collective_time(kind: str, bytes_per_device: float, k: int,
                             link_bw: float = NVLINK4_LINK_BW) -> float:
    """Standard bidirectional-ring formulas: both link directions carry
    half the ring volume."""
    if k <= 1:
        return 0.0
    if kind == "all_gather" or kind == "reduce_scatter":
        return bytes_per_device * (k - 1) / k / (2.0 * link_bw)
    if kind == "all_reduce":
        return bytes_per_device * (k - 1) / k / link_bw
    if kind == "all_to_all":
        # Bisection bound on a bidirectional ring: (k/2)*(k/2)*(b/k) bytes
        # cross each way over 2 links x 2 directions -> k*b/8 per channel.
        return bytes_per_device * k / 8.0 / link_bw
    raise ValueError(f"unknown collective {kind!r}")


def estimate_collective(kind: str, axis: str, bytes_per_device: float,
                        rows: int = 16, cols: int = 16, wrap: bool = True,
                        link_bw: float = NVLINK4_LINK_BW,
                        device: str | torch.device | None = None
                        ) -> CollectiveEstimate:
    """Predict a collective's time on the pod's interconnect using the
    paper's proxies, on ``device`` (None -> cuda).

    The throughput proxy's min_e B(e)/F(e) is "collective executions per
    second" when the traffic matrix is in bytes and B in bytes/s, so the
    predicted time is its reciprocal: max_e F(e)/B(e). Links are
    full-duplex, so directed flows are held against per-direction
    bandwidth (the reference's deviation from the paper's undirected
    formula).
    """
    dev = resolve_device(device)
    _, mh, on_dev = _pod_structure(rows, cols, wrap, link_bw, dev)
    t = collective_traffic(kind, rows, cols, axis, bytes_per_device)
    total = t.sum()
    k = cols if axis in ("data", "row") else rows
    analytic = analytic_collective_time(kind, bytes_per_device, k, link_bw)
    if total <= 0:
        return CollectiveEstimate(kind, axis, bytes_per_device,
                                  analytic, 1.0, analytic, 0.0)
    nh = on_dev["next_hop"]
    flow = edge_flows(nh, torch.from_numpy(t.astype(np.float32)).to(dev),
                      max_hops=mh)
    bw = on_dev["adj_bw"]
    per_edge_s = torch.where((flow > 0) & (bw > 0), flow / bw,
                             torch.zeros((), dtype=flow.dtype, device=dev))
    proxy_s = float(per_edge_s.max())
    tn = torch.from_numpy((t / total).astype(np.float32)).to(dev)
    lat = float(average_latency(nh, on_dev["step_cost"],
                                on_dev["node_weight"], tn))
    frac = analytic / proxy_s if proxy_s > 0 else 1.0
    return CollectiveEstimate(kind=kind, axis=axis,
                              bytes_per_device=bytes_per_device,
                              analytic_s=analytic,
                              proxy_sustained_fraction=min(frac, 1.0),
                              proxy_s=proxy_s,
                              proxy_latency_cycles=lat)


__all__ = ["NVLINK4_LINK_BW", "tpu_pod_design", "collective_traffic",
           "CollectiveEstimate", "analytic_collective_time",
           "estimate_collective"]
