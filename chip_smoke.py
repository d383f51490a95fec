#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA Hopper GPU
and check it.

    python3 chip_smoke.py

Phases, each fatal on error (exit code 1, no result line):

1. build every CUDA source of the port with nvcc for sm_90a;
2. the load-propagation kernel against its plain PyTorch version on the
   card (random routing tables with unreachable pairs and padded vertices,
   n in {16, 100, 128, 160, 256}, B in {1, 7, 256}; W and flow within
   rtol 1e-5 / atol 1e-6), and each design of a batch of 256 bit-equal to
   the same design run alone;
3. the main path: the README sweep (10 topologies x {16, 36, 64} chiplets x
   2 traffic patterns x 2 routings = 120 points) through
   ``DseEngine(device="cuda", chunk_size=60).run``, held within rtol 1e-5
   of the same sweep through the port on the CPU (plain version);
4. the large-n tier (256-chiplet mesh/torus/hexamesh, 100-chiplet kite) via
   ``evaluate_points``, same checks;
5. ``evaluate_design`` on one 64-chiplet mesh, on the card and on the CPU;
6. the report: kernel launches on the main path (phases 3-5), per-layer
   times, and the kernel's time beside its bound and the plain version's.

The second-to-last line carries the card's name and power limit from
nvidia-smi, the line before it the ``{"kernels": [...]}`` record, and the
last line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-5, 1e-6
# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
KERNEL_NS = (16, 100, 128, 160, 256)
KERNEL_BATCHES = (1, 7, 256)
SWEEP_TOPOLOGIES = ("mesh", "torus", "folded_torus", "flattened_butterfly",
                    "hexamesh", "hexatorus", "sid_mesh", "octamesh", "kite",
                    "double_butterfly")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_cuda(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, each between
    two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def random_routing(rng, batch: int, n: int, n_real: int):
    """Random routing tables: toward each destination d a random tree (each
    vertex's next hop sits earlier in a random order that starts at d), 5%
    of the vertices stuck (self-loop: unreachable, load piles up there),
    and vertices >= n_real padded (self-loop, zero load). Returns
    (next_hop src-major int32, load0 dest-major f32)."""
    ids = np.arange(n_real)
    keys = rng.random((batch, n_real, n_real))
    keys[:, ids, ids] = -1.0                     # d comes first for d
    perm = np.argsort(keys, axis=-1)             # perm[b, d, pos] = vertex
    rank = np.argsort(perm, axis=-1)             # rank[b, d, u] = position
    parent_pos = np.floor(rng.random(rank.shape) * rank).astype(np.int64)
    nh_dm = np.take_along_axis(perm, parent_pos, axis=-1)   # [b, d, u]
    stuck = rng.random(nh_dm.shape) < 0.05
    nh_dm = np.where(stuck, ids[None, None, :], nh_dm)
    nh = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (batch, 1, n))
    nh[:, :n_real, :n_real] = nh_dm.transpose(0, 2, 1)
    l0 = np.zeros((batch, n, n), np.float32)
    l0[:, :n_real, :n_real] = rng.random((batch, n_real, n_real))
    l0[:, np.arange(n), np.arange(n)] = 0.0
    return nh, l0


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import evaluate_design
    from repro_torch.core.latency import (latency_proxy, path_cost_doubling,
                                          routed_diameter_batch)
    from repro_torch.core.throughput import (_dest_major_load0,
                                             undirected_flows)
    from repro_torch.dse import (DseEngine, ExperimentSpec, encode_designs,
                                 expand_experiments)
    from repro_torch.kernels import build
    from repro_torch.kernels import load_prop as lp
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build ------------------------------------------------------------
    secs = build.build_all()
    log(f"phase 1: built {list(build.SOURCES)} in {secs:.3f} s")
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # -- 2. kernel vs plain --------------------------------------------------
    def plain(nh, l0, hops):
        if nh.shape[-1] > 160:
            return lp.load_prop_plain_blocked(
                nh, l0, hops, False, lp.pick_tile(nh.shape[-1], nh.shape[0]))
        return lp.load_prop_plain(nh, l0, hops, adaptive=False)

    max_err = 0.0
    rng = np.random.default_rng(2023)
    for n in KERNEL_NS:
        for batch in KERNEL_BATCHES:
            nh, l0 = random_routing(rng, batch, n, n - n // 10)
            nh_t = torch.from_numpy(nh).to(dev)
            l0_t = torch.from_numpy(l0).to(dev)
            hops = int(routed_diameter_batch(nh_t).max()) + 2
            w_k, f_k = lp.load_prop_cuda(nh_t, l0_t, hops)
            w_p, f_p = plain(nh_t, l0_t, hops)
            torch.cuda.synchronize()
            for got, want, what in ((w_k, w_p, "W"), (f_k, f_p, "flow")):
                if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                    fail(f"phase 2: kernel {what} differs from plain at "
                         f"n={n} B={batch}: max abs err "
                         f"{(got - want).abs().max().item()}")
                max_err = max(max_err, (got - want).abs().max().item())
            if batch == max(KERNEL_BATCHES):
                for b in (0, batch // 2, batch - 1):
                    w1, f1 = lp.load_prop_cuda(nh_t[b:b + 1].contiguous(),
                                               l0_t[b:b + 1].contiguous(),
                                               hops)
                    if not (torch.equal(w1[0], w_k[b])
                            and torch.equal(f1[0], f_k[b])):
                        fail(f"phase 2: design {b} alone differs from the "
                             f"same design in a batch of {batch} at n={n}")
            log(f"phase 2: n={n:3d} B={batch:3d} hops={hops:3d} ok")
    log(f"phase 2: kernel within rtol {RTOL} / atol {ATOL} of plain, max abs "
        f"err {max_err:.3g}; batch of 256 bit-equal to solo")

    # -- 3. main path: the README sweep ---------------------------------------
    points = expand_experiments(ExperimentSpec(
        topologies=SWEEP_TOPOLOGIES, chiplet_counts=(16, 36, 64),
        traffic_patterns=("random_uniform", "hotspot"),
        routings=("dijkstra_lowest_id", "updown_random")))

    def check_rows(where, got, ref):
        for what in ("latency", "throughput"):
            g, r = getattr(got, what), getattr(ref, what)
            if not (np.all(np.isfinite(g)) and np.all(g > 0)):
                fail(f"{where}: non-finite or non-positive {what}")
            if not np.allclose(g, r, rtol=RTOL, atol=0.0):
                fail(f"{where}: {what} differs from the CPU run by "
                     f"{np.max(np.abs(g / r - 1))} (relative)")

    launches = {}
    lp.load_prop_cuda.launches = 0
    t0 = time.perf_counter()
    sweep = DseEngine(device="cuda", chunk_size=60).run(points)
    sweep_s = time.perf_counter() - t0
    launches["sweep"] = lp.load_prop_cuda.launches
    sweep_cpu = DseEngine(device="cpu", chunk_size=60).run(points)
    check_rows("phase 3", sweep, sweep_cpu)
    log(f"phase 3: {len(points)} points in {sweep_s:.3f} s "
        f"({len(points) / sweep_s:.2f} designs/s, cold structure cache); "
        f"kernel launches {launches['sweep']}; CPU agrees within {RTOL}")
    # the whole device stage gives a design the same bits alone as in its
    # chunk (same padded n)
    engine = DseEngine(device="cuda")
    chunk = points[60:120]
    n_chunk = encode_designs(chunk, validate=False, device=dev).n
    together = engine.evaluate_points(chunk, n_pad=n_chunk)
    for i in (0, 31, 59):
        alone = engine.evaluate_points([chunk[i]], n_pad=n_chunk)
        if not (alone.latency[0] == together.latency[i]
                and alone.throughput[0] == together.throughput[i]):
            fail(f"phase 3: point {chunk[i].index} alone differs from the "
                 f"same point in its chunk")
    log("phase 3: a design alone is bit-equal to it inside its chunk")

    # -- 4. large-n tier -------------------------------------------------------
    big = expand_experiments(ExperimentSpec(
        topologies=("mesh", "torus", "hexamesh"), chiplet_counts=(256,),
        traffic_patterns=("random_uniform", "hotspot")))
    big += expand_experiments(ExperimentSpec(
        topologies=("kite",), chiplet_counts=(100,),
        traffic_patterns=("random_uniform", "hotspot")))
    big = [dataclasses.replace(pt, index=i) for i, pt in enumerate(big)]
    lp.load_prop_cuda.launches = 0
    t0 = time.perf_counter()
    large = DseEngine(device="cuda").evaluate_points(big)
    large_s = time.perf_counter() - t0
    launches["large_n"] = lp.load_prop_cuda.launches
    check_rows("phase 4", large, DseEngine(device="cpu").evaluate_points(big))
    log(f"phase 4: {len(big)} large-n points in {large_s:.3f} s; kernel "
        f"launches {launches['large_n']}; CPU agrees within {RTOL}")

    # -- 5. one design -----------------------------------------------------------
    design = make_design("mesh", 64)
    traffic = make_traffic("random_uniform", 64)
    lp.load_prop_cuda.launches = 0
    one = evaluate_design(design, traffic, device="cuda")
    launches["single"] = lp.load_prop_cuda.launches
    one_cpu = evaluate_design(design, traffic, device="cpu")
    for what in ("latency", "throughput"):
        g, r = getattr(one, what), getattr(one_cpu, what)
        if not (np.isfinite(g) and g > 0 and abs(g / r - 1) <= RTOL):
            fail(f"phase 5: {what} {g} vs CPU {r}")
    if one.to_dict()["cost"] != one_cpu.to_dict()["cost"]:
        fail("phase 5: cost report differs between cuda and cpu")
    log(f"phase 5: 64-chiplet mesh latency {one.latency} throughput "
        f"{one.throughput}; launches {launches['single']}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"the main path launched no kernel in {missing}")

    # -- 6. report -------------------------------------------------------------
    # warm sweep: structures cached, so this is the device side plus encode
    t0 = time.perf_counter()
    DseEngine(device="cuda", chunk_size=60).run(points)
    warm_s = time.perf_counter() - t0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        DseEngine(device="cuda", chunk_size=60).run(points)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    kernel_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            kernel_us[ev.key] = us
    busy_s = sum(kernel_us.values()) / 1e6
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:6]

    # host layers over the sweep's unique structures
    from repro_torch.core.graph import build_graph, step_cost_matrix
    from repro_torch.routing.tables import build_routing_table
    graph_s = routing_s = 0.0
    seen = set()
    for pt in points:
        if pt.structure_key() in seen:
            continue
        seen.add(pt.structure_key())
        d = pt.build()
        t0 = time.perf_counter()
        g = build_graph(d)
        step_cost_matrix(g)
        t1 = time.perf_counter()
        build_routing_table(g, d.routing, d.routing_metric, d.seed)
        t2 = time.perf_counter()
        graph_s += t1 - t0
        routing_s += t2 - t1

    def kernel_record(batch):
        nh = batch.next_hop
        l0 = _dest_major_load0(nh, batch.traffic).contiguous()
        hops = batch.max_hops
        B, n, _ = nh.shape
        w_k, f_k = lp.load_prop_cuda(nh, l0, hops)
        w_p, f_p = plain(nh, l0, hops)
        err = max((w_k - w_p).abs().max().item(),
                  (f_k - f_p).abs().max().item())
        if not (torch.allclose(w_k, w_p, rtol=RTOL, atol=ATOL)
                and torch.allclose(f_k, f_p, rtol=RTOL, atol=ATOL)):
            fail(f"phase 6: kernel differs from plain at B={B} n={n}")
        ms = time_cuda(torch, lambda: lp.load_prop_cuda(nh, l0, hops))
        plain_ms = time_cuda(torch, lambda: plain(nh, l0, hops), reps=10)
        # the work this data needs: each destination row's live hops
        # (2 n float adds each: W accumulation and the gather) plus n^2
        # adds per design for the flow contraction
        ids = torch.arange(n, device=dev)
        oh = (nh.transpose(1, 2).long()[..., None] == ids).float()
        offdiag = ids[:, None] != ids
        load = torch.where(offdiag, l0, 0.0)
        live_rows = 0
        for _ in range(hops):
            live_rows += int((load != 0).any(dim=-1).sum())
            load = torch.where(offdiag,
                               torch.einsum("bduv,bdu->bdv", oh, load), 0.0)
        del oh
        nbytes = 16 * B * n * n
        ops = 2 * n * live_rows + B * n * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        return {"shape": [B, n, n], "max_hops": hops, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops, "max_abs_err": err}

    chunks = [encode_designs(points[i:i + 60], validate=False, device=dev)
              for i in range(0, len(points), 60)]
    chunk_recs = [kernel_record(b) for b in chunks]
    large_rec = kernel_record(encode_designs(big, validate=False, device=dev))
    head_i = max(range(len(chunks)), key=lambda i: chunks[i].n)
    head, batch = chunk_recs[head_i], chunks[head_i]
    nh, sc, nw, tr = (batch.next_hop, batch.step_cost, batch.node_weight,
                      batch.traffic)
    plat = path_cost_doubling(nh, sc, nw)
    _, flow = lp.load_prop_cuda(nh, _dest_major_load0(nh, tr).contiguous(),
                                batch.max_hops)

    def reductions():
        latency_proxy(plat, tr)
        f = undirected_flows(flow)
        torch.where(f > 0, batch.adj_bw / torch.clamp_min(f, 1e-30),
                    torch.inf).amin(dim=(-2, -1))

    layers = {
        "shape": head["shape"],
        "host_graph_ms_per_structure": graph_s / len(seen) * 1e3,
        "host_routing_ms_per_structure": routing_s / len(seen) * 1e3,
        "routed_diameter_ms": time_cuda(
            torch, lambda: routed_diameter_batch(nh)),
        "path_doubling_ms": time_cuda(
            torch, lambda: path_cost_doubling(nh, sc, nw)),
        "load_prop_ms": head["ms"],
        "reductions_ms": time_cuda(torch, reductions),
    }
    print(json.dumps({"layers": layers}), flush=True)
    print(json.dumps({"sweep": {
        "points": len(points), "cold_s": sweep_s,
        "designs_per_s_cold": len(points) / sweep_s, "warm_s": warm_s,
        "designs_per_s_warm": len(points) / warm_s,
        "profiled_wall_s": prof_wall_s, "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / prof_wall_s,
        "top_device_us": dict(top), "large_n_points": len(big),
        "large_n_s": large_s, "launches": launches}}), flush=True)
    print(json.dumps({"kernel_shapes": chunk_recs + [large_rec]}),
          flush=True)
    total = sum(launches.values())
    log(f"kernel launches on the main path: {total} ({launches})")
    log(f"wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "load_propagate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/load_prop.cu",
        "replaces": "src/repro/kernels/load_prop.py:144",
        "also_replaces": "src/repro/kernels/load_prop.py:279",
        "launches": total,
        "max_abs_err": max([max_err] + [r["max_abs_err"]
                                        for r in chunk_recs + [large_rec]]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape": head["shape"]}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
