# Port of src/repro/core/visualize.py: design_to_svg is a copy;
# latency_vs_load forwards backend/device to FastSim.run_batch.
"""Visualization (paper §2.5): render designs as SVG (chiplets, PHYs,
links, on-interposer routers) and emit latency-vs-load curves from the
cycle simulator — the two plot kinds of the paper's Fig. 4.

No plotting dependencies: SVG is written directly; curve data is returned
as rows (and saved as CSV by the benchmarks) so any plotter can consume it.
"""
from __future__ import annotations

import html

import numpy as np

from .design import Design
from .geometry import chiplet_footprint, endpoint_position, phy_positions


def design_to_svg(design: Design, path: str | None = None,
                  scale: float = 8.0) -> str:
    """Render the placement + topology. Chiplets are rectangles, PHYs dots,
    links lines (Manhattan links drawn as L-shapes), routers diamonds."""
    lib = design.library()
    phy_pos = phy_positions(design)
    xs, ys = [], []
    for pc in design.placement.chiplets:
        ct = lib[pc.chiplet]
        fw, fh = chiplet_footprint(ct.width, ct.height, pc.rotation)
        xs += [pc.x, pc.x + fw]
        ys += [pc.y, pc.y + fh]
    for (rx, ry) in design.placement.interposer_routers:
        xs.append(rx)
        ys.append(ry)
    x0, y0, x1, y1 = min(xs), min(ys), max(xs), max(ys)
    pad = 2.0
    w = (x1 - x0 + 2 * pad) * scale
    h = (y1 - y0 + 2 * pad) * scale

    def tx(x):
        return (x - x0 + pad) * scale

    def ty(y):
        return h - (y - y0 + pad) * scale   # flip y for SVG

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{w:.0f}" '
           f'height="{h:.0f}" viewBox="0 0 {w:.0f} {h:.0f}">',
           f'<rect width="100%" height="100%" fill="#fafafa"/>']
    # links first (under chiplets)
    for link in design.topology.links:
        ax, ay = endpoint_position(design, link.a, phy_pos)
        bx, by = endpoint_position(design, link.b, phy_pos)
        if design.packaging.link_routing == "manhattan":
            out.append(f'<polyline points="{tx(ax):.1f},{ty(ay):.1f} '
                       f'{tx(bx):.1f},{ty(ay):.1f} {tx(bx):.1f},{ty(by):.1f}"'
                       f' fill="none" stroke="#4878cf" stroke-width="1.2"'
                       f' opacity="0.7"/>')
        else:
            out.append(f'<line x1="{tx(ax):.1f}" y1="{ty(ay):.1f}" '
                       f'x2="{tx(bx):.1f}" y2="{ty(by):.1f}" '
                       f'stroke="#4878cf" stroke-width="1.2" opacity="0.7"/>')
    # chiplets
    for ci, pc in enumerate(design.placement.chiplets):
        ct = lib[pc.chiplet]
        fw, fh = chiplet_footprint(ct.width, ct.height, pc.rotation)
        out.append(f'<rect x="{tx(pc.x):.1f}" y="{ty(pc.y + fh):.1f}" '
                   f'width="{fw * scale:.1f}" height="{fh * scale:.1f}" '
                   f'fill="#e8e8f0" stroke="#333" stroke-width="1"/>')
        out.append(f'<text x="{tx(pc.x + fw / 2):.1f}" '
                   f'y="{ty(pc.y + fh / 2) + 3:.1f}" font-size="{2.2 * scale:.0f}px" '
                   f'text-anchor="middle" fill="#333">{ci}</text>')
        for pi in range(len(ct.phys)):
            px, py = phy_pos[ci, pi]
            if np.isnan(px):
                continue
            out.append(f'<circle cx="{tx(px):.1f}" cy="{ty(py):.1f}" '
                       f'r="{0.4 * scale:.1f}" fill="#c44"/>')
    # routers
    for (rx, ry) in design.placement.interposer_routers:
        s = 0.8 * scale
        out.append(f'<path d="M {tx(rx):.1f} {ty(ry) - s:.1f} '
                   f'L {tx(rx) + s:.1f} {ty(ry):.1f} '
                   f'L {tx(rx):.1f} {ty(ry) + s:.1f} '
                   f'L {tx(rx) - s:.1f} {ty(ry):.1f} Z" '
                   f'fill="#7a7" stroke="#252"/>')
    out.append(f'<text x="4" y="{h - 6:.0f}" font-size="11px" fill="#666">'
               f'{html.escape(design.name)}</text>')
    out.append('</svg>')
    svg = "\n".join(out)
    if path:
        with open(path, "w") as f:
            f.write(svg)
    return svg


def latency_vs_load(design: Design, traffic: np.ndarray,
                    rates=(0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5),
                    config=None, engine: str = "fast",
                    backend: str = "auto", device=None) -> list[dict]:
    """Latency-vs-injection-rate curve from the cycle simulator (paper
    Fig. 4 right). Returns rows of {rate, latency, accepted, stable}.

    ``engine`` picks the simulator: ``'fast'`` (vectorized FastSim, the
    default) or ``'cycle'`` (the per-flit reference oracle). ``backend``
    and ``device`` go to ``FastSim.run_batch``: ``'auto'`` (C, else numpy),
    ``'numpy'``, ``'c'`` or ``'torch'`` (the cycle loop on ``device``, the
    card unless the caller passes ``device="cpu"``); every backend gives
    the same rows. The ``'cycle'`` engine ignores both."""
    from ..sim import SimConfig, make_sim

    cfg = config or SimConfig(packet_size_flits=2, warmup_cycles=400,
                              measure_cycles=1200, drain_cycles=1500)
    sim = make_sim(design, traffic, cfg, engine=engine)
    if hasattr(sim, "run_batch"):
        # FastSim: all rates in one vectorized pass (identical stats)
        stats = sim.run_batch(list(rates), cfg, backend=backend,
                              device=device)
    else:
        stats = []
        for r in rates:
            st = sim.run(r, cfg)
            stats.append(st)
            if not st.stable:
                break
    rows = []
    for r, st in zip(rates, stats):
        rows.append({"rate": r, "latency": st.avg_packet_latency,
                     "accepted": st.accepted_flits_per_node,
                     "stable": st.stable})
        if not st.stable:
            break
    return rows
