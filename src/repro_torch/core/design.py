# Copy of src/repro/core/design.py, kept so repro_torch never imports repro.
"""Design IR for RapidChiplet: chiplets, placements, packaging, technology.

This mirrors the paper's input files (Fig. 2): chiplets, placement, topology,
packaging, technology, plus the design file that bundles them. All structures
are immutable dataclasses so designs are hashable work units for the DSE
engine (idempotent restartable sweeps).

Units:
  lengths  : mm
  latency  : cycles (link latency may be cycles/mm * length)
  area     : mm^2
  power    : W
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal


class DesignValidationError(ValueError):
    """Raised when a design's input files are inconsistent (paper §2.1.1)."""


@dataclass(frozen=True)
class Phy:
    """A PHY location within a chiplet, relative to the chiplet's origin
    (lower-left corner), before rotation."""
    x: float
    y: float


@dataclass(frozen=True)
class Chiplet:
    """A chiplet *type* (the library entry, reusable across placements)."""
    name: str
    width: float
    height: float
    phys: tuple[Phy, ...]
    internal_latency: float = 3.0   # cycles (paper §3.1 uses 3)
    phy_latency: float = 12.0       # cycles (paper §3.1 uses 12)
    power: float = 1.0              # W
    technology: str = "generic_7nm"
    # Fraction of total chiplet area usable for link bumps (split across PHYs).
    bump_area_fraction: float = 0.10
    # Relay capability: can traffic be routed *through* this chiplet?
    relay: bool = True

    @property
    def area(self) -> float:
        return self.width * self.height

    def validate(self) -> None:
        if self.width <= 0 or self.height <= 0:
            raise DesignValidationError(f"chiplet {self.name}: non-positive size")
        for i, p in enumerate(self.phys):
            if not (0 <= p.x <= self.width and 0 <= p.y <= self.height):
                raise DesignValidationError(
                    f"chiplet {self.name}: PHY {i} at ({p.x},{p.y}) outside die "
                    f"({self.width}x{self.height})")
        if not (0 < self.bump_area_fraction <= 1):
            raise DesignValidationError(
                f"chiplet {self.name}: bump_area_fraction must be in (0,1]")


@dataclass(frozen=True)
class PlacedChiplet:
    """One instance of a chiplet in the package. Rotation is in degrees
    counter-clockwise and must be a multiple of 90."""
    chiplet: str
    x: float
    y: float
    rotation: int = 0


@dataclass(frozen=True)
class Placement:
    chiplets: tuple[PlacedChiplet, ...]
    # On-interposer routers (active interposers only): absolute positions.
    interposer_routers: tuple[tuple[float, float], ...] = ()


# An endpoint of a link: ("chiplet", chiplet_index, phy_index) or
# ("router", router_index, 0).
Endpoint = tuple[Literal["chiplet", "router"], int, int]


@dataclass(frozen=True)
class Link:
    a: Endpoint
    b: Endpoint


@dataclass(frozen=True)
class Topology:
    links: tuple[Link, ...]


@dataclass(frozen=True)
class Packaging:
    """Packaging technology parameters (paper §2.1: packaging input file)."""
    name: str = "passive_interposer"
    # "manhattan" or "euclidean" physical link routing (paper §2.1.2).
    link_routing: Literal["manhattan", "euclidean"] = "manhattan"
    # Link latency model: latency = const + per_mm * length (set per_mm=0 for
    # length-independent links).
    link_latency_per_mm: float = 0.25   # cycles/mm (paper §3.1 uses 0.25)
    link_latency_const: float = 0.0
    # Bump geometry for the throughput proxy's bandwidth term.
    bump_pitch: float = 0.05            # mm  (50um microbump pitch)
    non_data_wires: int = 2             # N_ndw: clock/handshake wires per link
    # Active interposer router properties.
    has_interposer_routers: bool = False
    router_latency: float = 3.0         # cycles
    router_power: float = 0.1           # W per router
    # Power model: per-mm link power (length-dependent term, paper §2.1.4).
    link_power_per_mm: float = 0.0      # W/mm
    link_power_const: float = 0.0       # W per link
    # Cost model.
    packaging_cost_per_mm2: float = 0.02  # $ / mm^2 of interposer
    packaging_cost_base: float = 1.0      # $ fixed per package

    def validate(self) -> None:
        if self.link_routing not in ("manhattan", "euclidean"):
            raise DesignValidationError(f"unknown link routing {self.link_routing}")
        if self.bump_pitch <= 0:
            raise DesignValidationError("bump_pitch must be positive")


@dataclass(frozen=True)
class Technology:
    """Manufacturing technology node, for the yield/cost model (paper §2.1.4)."""
    name: str = "generic_7nm"
    wafer_radius: float = 150.0        # mm (300mm wafer)
    wafer_cost: float = 9000.0         # $
    defect_density: float = 0.001      # defects / mm^2
    critical_level_ratio: float = 0.5  # fraction of defects that kill the die
    clustering_alpha: float = 3.0      # negative-binomial clustering parameter


@dataclass(frozen=True)
class TrafficEntry:
    src: int
    dst: int
    amount: float


@dataclass(frozen=True)
class Design:
    """A complete design point = one evaluation unit.

    Mirrors the paper's `design` file which references one file from each
    input directory.
    """
    name: str
    chiplet_library: tuple[Chiplet, ...]
    placement: Placement
    topology: Topology
    packaging: Packaging
    technologies: tuple[Technology, ...] = (Technology(),)
    routing: str = "dijkstra_lowest_id"   # or "updown_random"
    routing_metric: Literal["hops", "latency"] = "hops"
    seed: int = 0

    def library(self) -> dict[str, Chiplet]:
        return {c.name: c for c in self.chiplet_library}

    def technology_map(self) -> dict[str, Technology]:
        return {t.name: t for t in self.technologies}

    @property
    def n_chiplets(self) -> int:
        return len(self.placement.chiplets)

    @property
    def n_routers(self) -> int:
        return len(self.placement.interposer_routers)

    @property
    def n_nodes(self) -> int:
        return self.n_chiplets + self.n_routers

    def replace(self, **kw) -> "Design":
        return dataclasses.replace(self, **kw)


def validate_design(design: Design) -> None:
    """Input validation (paper §2.1.1): every referenced entity must exist and
    be self-consistent. Raises DesignValidationError."""
    lib = design.library()
    for c in design.chiplet_library:
        c.validate()
    design.packaging.validate()
    tech = design.technology_map()
    for c in design.chiplet_library:
        if c.technology not in tech:
            raise DesignValidationError(
                f"chiplet {c.name}: unknown technology {c.technology!r}")
    n_c, n_r = design.n_chiplets, design.n_routers
    if n_c == 0:
        raise DesignValidationError("placement has no chiplets")
    for i, pc in enumerate(design.placement.chiplets):
        if pc.chiplet not in lib:
            raise DesignValidationError(
                f"placement[{i}]: unknown chiplet type {pc.chiplet!r}")
        if pc.rotation % 90 != 0:
            raise DesignValidationError(
                f"placement[{i}]: rotation {pc.rotation} not a multiple of 90")
    if design.placement.interposer_routers and not design.packaging.has_interposer_routers:
        raise DesignValidationError(
            "placement has interposer routers but packaging does not support them")
    phy_use: dict[tuple[int, int], int] = {}
    for li, link in enumerate(design.topology.links):
        for ep in (link.a, link.b):
            kind, idx, phy = ep
            if kind == "chiplet":
                if not (0 <= idx < n_c):
                    raise DesignValidationError(f"link[{li}]: chiplet index {idx} out of range")
                ctype = lib[design.placement.chiplets[idx].chiplet]
                if not (0 <= phy < len(ctype.phys)):
                    raise DesignValidationError(
                        f"link[{li}]: phy index {phy} out of range for {ctype.name} "
                        f"({len(ctype.phys)} PHYs)")
                key = (idx, phy)
                phy_use[key] = phy_use.get(key, 0) + 1
                if phy_use[key] > 1:
                    raise DesignValidationError(
                        f"link[{li}]: PHY {phy} of chiplet {idx} used by multiple links")
            elif kind == "router":
                if not (0 <= idx < n_r):
                    raise DesignValidationError(f"link[{li}]: router index {idx} out of range")
            else:
                raise DesignValidationError(f"link[{li}]: unknown endpoint kind {kind!r}")
        if link.a == link.b:
            raise DesignValidationError(f"link[{li}]: self-loop")


def validate_traffic(design: Design, traffic: list[TrafficEntry]) -> None:
    n = design.n_chiplets
    for i, t in enumerate(traffic):
        if not (0 <= t.src < n and 0 <= t.dst < n):
            raise DesignValidationError(
                f"traffic[{i}]: endpoint out of range (n_chiplets={n})")
        if t.amount < 0:
            raise DesignValidationError(f"traffic[{i}]: negative amount")
