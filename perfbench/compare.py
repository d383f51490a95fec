"""The comparison that decides ``correct``: what the timed path produced for
the sampled calls against the plain reference's float64 answers for the
same raw offspring and scenarios.

Numbers compared, each the worst over the sampled calls, each against the
cell's limit (``perfbench/limits/<cell>.json``):

* ``repair_bits``: repaired bits that differ from the reference's repair;
* ``routed_diff``: (genome, scenario) entries where one side routes some
  traffic and the other none;
* ``latency_rel``, ``throughput_rel``: the largest relative gap of the
  latency and throughput proxies over the entries both sides route;
* ``reach_abs``: the largest gap of the delivered-traffic fraction;
* ``report_rel``: the largest relative gap of the report columns (area,
  interposer area, power, cost, connected fraction).
"""
from __future__ import annotations

import numpy as np

from perfbench.reference import grid as refgrid

NAMES = ("repair_bits", "routed_diff", "latency_rel", "throughput_rel",
         "reach_abs", "report_rel")
REPORT_COLUMNS = ("total_chiplet_area", "interposer_area", "power", "cost",
                  "reachable_fraction")


def _column(reports, name: str) -> np.ndarray:
    if isinstance(reports, dict):
        return np.asarray(reports[name], np.float64)
    return np.asarray(getattr(reports, name), np.float64)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def gaps(repaired: np.ndarray, got, ref: refgrid.GridResult) -> dict:
    """The compared numbers of one call. ``got`` has ``latency``,
    ``throughput``, ``reachable_fraction`` [P, F] and ``reports``."""
    lat = np.asarray(got.latency, np.float64)
    thr = np.asarray(got.throughput, np.float64)
    reach = np.asarray(got.reachable_fraction, np.float64)
    routed_got = lat < refgrid.BIG / 2
    routed_ref = ref.latency < refgrid.BIG / 2
    both = routed_got & routed_ref
    return {
        "repair_bits": int(np.sum(np.asarray(repaired) % 2
                                  != ref.repaired % 2)),
        "routed_diff": int(np.sum(routed_got != routed_ref)),
        "latency_rel": _rel(lat[both], ref.latency[both]),
        "throughput_rel": _rel(thr[both], ref.throughput[both]),
        "reach_abs": float(np.max(np.abs(reach - ref.reachable_fraction),
                                  initial=0.0)),
        "report_rel": max(_rel(_column(got.reports, c),
                               _column(ref.reports, c))
                          for c in REPORT_COLUMNS),
    }


def worst(per_call: list[dict]) -> dict:
    if not per_call:
        return {name: float("inf") for name in NAMES}
    return {name: max(g[name] for g in per_call) for name in NAMES}


def reference(mix, call: int, n: int, max_degree: int,
              device: str) -> refgrid.GridResult:
    """The reference over call ``call``'s raw offspring, made again from
    the seed."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return refgrid.evaluate(mix.offspring(call), mix.link_fail,
                            mix.node_fail, n, max_degree, device=device)


def check_calls(kept, mix, n: int, max_degree: int, device: str,
                limits: dict) -> dict:
    """(value, limit) of every compared number over the kept calls
    (call index, the program's repaired genomes, its result)."""
    per_call = [gaps(rep, res, reference(mix, i, n, max_degree, device))
                for i, rep, res in kept]
    w = worst(per_call)
    return {name: (w[name], float(limits[name])) for name in NAMES}
