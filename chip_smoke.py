#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA Hopper GPU
and check it.

    python3 chip_smoke.py

Phases, each fatal on error (exit code 1, no result line):

1. build every CUDA source of the port with nvcc for sm_90a, all at once;
2. the load-propagation kernel against its plain PyTorch version on the
   card (random routing tables with unreachable pairs and padded vertices,
   n in {16, 100, 128, 160, 256}, B in {1, 7, 256}; W and flow within
   rtol 1e-5 / atol 1e-6), and each design of a batch of 256 bit-equal to
   the same design run alone;
3. the README sweep (10 topologies x {16, 36, 64} chiplets x 2 traffic
   patterns x 2 routings = 120 points) through
   ``DseEngine(device="cuda", chunk_size=60).run``, held within rtol 1e-5
   of the same sweep through the port on the CPU (plain version);
4. the large-n tier (256-chiplet mesh/torus/hexamesh, 100-chiplet kite) via
   ``evaluate_points``, same checks;
5. ``evaluate_design`` on one 64-chiplet mesh, on the card and on the CPU;
6. the report of phases 3-5: per-layer times, and the load-propagation
   kernel's time beside its bound and the plain version's;
7. the min-plus kernels against their plain versions, bit-equal: min-plus
   at M, K, N in {1, 37, 128, 200} x B in {1, 7, 64} with BIG and inf
   entries, the fused APSP at n in {16, 32, 64, 128, 160}, the tiled APSP
   at n in {161, 200, 256, 576} through ``ops.apsp``, and a design alone
   bit-equal to it in a batch of 64;
8. device routing tables: ``next_hop_lowest_id_batch`` (fused or tiled
   APSP, then the lowest-ID selection) for every registry topology at 64
   chiplets and the 256-chiplet mesh/torus/hexamesh, ``hops_next_hop_batch``
   on the same adjacencies, and ``updown_random_table_via_device`` on
   36-chiplet designs, all exactly equal to the host tables;
9. the genome cost function: ``DseEngine(device="cuda").evaluate_genomes``
   on ``AdjacencySpace(32, 8)`` (population 24, fresh populations),
   ``AdjacencySpace(256, 8)`` (population 8) and the default
   ``ParametricSpace`` (population 64), within rtol 1e-5 of the CPU run,
   reports exactly equal, a genome alone bit-equal to it in its population;
10. ``path_cost_minplus(use_kernel=True)`` on a 64-chiplet mesh, bit-equal
    to ``use_kernel=False`` and within 1e-5 of path doubling;
11. the report of phases 8-10: each kernel held bit-equal to its plain
    version on the operands it is timed on, at the shapes those paths give
    it, and its time beside its bound and the plain version's;
    routing-table time per population; the genome path's layers; the host
    syncs of the BFS and up*/down* loops.

Every path (phases 3, 4, 5, 8, 9, 10) is driven with every kernel's launch
count set to 0 just before it and read just after; a path whose kernels
were not launched fails the run. Launches made to compare a kernel with its
plain version are not counted. The second-to-last line carries the card's
name and power limit from nvidia-smi, the line before it the
``{"kernels": [...]}`` record, and the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/`` beside this file, it exits non-zero.
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
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores, FMA = 2
SMS, FP32_LANES = 132, 128      # per card, per SM
KERNEL_NS = (16, 100, 128, 160, 256)
KERNEL_BATCHES = (1, 7, 256)
MINPLUS_SIZES = (1, 37, 128, 200)          # M, K, N of the min-plus check
MINPLUS_BATCHES = (1, 7, 64)
FUSED_NS = (16, 32, 64, 128, 160)          # fused APSP check
TILED_NS = ((161, 4), (200, 4), (256, 4), (576, 2))   # tiled APSP: (n, B)
ROUTING_CHIPLETS = 64       # registry topologies for the device tables
LARGE_CHIPLETS = 256        # mesh/torus/hexamesh on the tiled APSP
GENOME_SPACES = (   # (name, n_chiplets or None for parametric, population,
    ("adjacency_32", 32, 24, 3),            # fresh populations checked)
    ("adjacency_256", 256, 8, 1),
    ("parametric", None, 64, 2))
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


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


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


def profile_device(torch, fn, n_top: int = 6):
    """Run ``fn`` once under torch.profiler: (wall s, device-busy s, the
    ``n_top`` ops by device time in us)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernel_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            kernel_us[ev.key] = us
    busy_s = sum(kernel_us.values()) / 1e6
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:n_top]
    return wall_s, busy_s, top


def random_costs(rng, batch: int, n: int, big: float):
    """Symmetric hop-cost stacks with about 4 edges per vertex (BIG = no
    edge, zero diagonal), so some vertices are cut off."""
    adj = rng.random((batch, n, n)) < 2.0 / n
    d = np.where(adj | adj.transpose(0, 2, 1), 1.0, big).astype(np.float32)
    d[:, np.arange(n), np.arange(n)] = 0.0
    return d


def minplus_paths(torch, dev, zero_counts, read_counts) -> list[dict]:
    """Phases 7-11. Returns the kernel records of apsp_fused, apsp_square
    and minplus (launch counts are filled in by the caller)."""
    from repro_torch.core.graph import build_graph, step_cost_matrix
    from repro_torch.core.latency import path_cost_doubling, path_cost_minplus
    from repro_torch.core.proxies import prepare_arrays
    from repro_torch.dse import DseEngine
    from repro_torch.dse import genomes as gn
    from repro_torch.kernels import apsp as ap
    from repro_torch.kernels import minplus as mp
    from repro_torch.kernels.load_prop import pick_tile
    from repro_torch.kernels.ops import apsp, apsp_iters
    from repro_torch.kernels.ref import BIG
    from repro_torch.opt import AdjacencySpace, ParametricSpace
    from repro_torch.routing import device as rdev
    from repro_torch.routing.tables import (_edge_costs, build_routing_table,
                                            updown_random_table)
    from repro_torch.topologies import TOPOLOGIES, make_design

    clock_hz = max_sm_clock_hz()
    instr_per_s = SMS * FP32_LANES * clock_hz   # one FP32 instruction a lane

    def bound(nbytes: float, pairs: float) -> dict:
        """Byte and operation floors; a (min, +) candidate is one FADD and
        one FMNMX instruction."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * pairs / instr_per_s * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "pairs": pairs}

    def gpu(x):
        return torch.from_numpy(x).to(dev)

    # -- 7. min-plus kernels vs plain ------------------------------------------
    rng = np.random.default_rng(7)
    n_checked = 0
    big_b = max(MINPLUS_BATCHES)
    big_s = max(MINPLUS_SIZES)
    for B in MINPLUS_BATCHES:
        for M in MINPLUS_SIZES:
            for K in MINPLUS_SIZES:
                for N in MINPLUS_SIZES:
                    a = rng.uniform(0, 50, (B, M, K)).astype(np.float32)
                    b = rng.uniform(0, 50, (B, K, N)).astype(np.float32)
                    a[rng.random(a.shape) < 0.2] = BIG
                    b[rng.random(b.shape) < 0.2] = np.inf
                    a_t, b_t = gpu(a), gpu(b)
                    got = mp.minplus_cuda(a_t, b_t)
                    if not torch.equal(got, mp.minplus_plain(a_t, b_t)):
                        fail(f"phase 7: min-plus kernel differs from plain "
                             f"at B={B} M={M} K={K} N={N}")
                    if B == big_b and M == K == N == big_s:
                        for i in (0, B // 2, B - 1):
                            one = mp.minplus_cuda(a_t[i:i + 1].contiguous(),
                                                  b_t[i:i + 1].contiguous())
                            if not torch.equal(one[0], got[i]):
                                fail("phase 7: min-plus design alone differs "
                                     "from it in a batch of 64")
                    n_checked += 1
    log(f"phase 7: min-plus kernel bit-equal to plain at {n_checked} shapes; "
        f"alone == in a batch of {big_b}")
    for n in FUSED_NS:
        d = gpu(random_costs(rng, 8, n, BIG))
        it = apsp_iters(n)
        got = ap.apsp_fused_cuda(d, it)
        if not torch.equal(got, ap.apsp_plain(d, it)):
            fail(f"phase 7: fused APSP kernel differs from plain at n={n}")
        if n in (64, max(FUSED_NS)):
            d64 = gpu(random_costs(rng, 64, n, BIG))
            all64 = ap.apsp_fused_cuda(d64, it)
            for i in (0, 63):
                if not torch.equal(ap.apsp_fused_cuda(
                        d64[i:i + 1].contiguous(), it)[0], all64[i]):
                    fail(f"phase 7: fused APSP design alone differs from it "
                         f"in a batch of 64 at n={n}")
    log("phase 7: fused APSP bit-equal to plain at n in {16..160}; alone == "
        "in a batch of 64")
    for n, B in TILED_NS:
        d = random_costs(rng, B, n, np.inf)
        got = apsp(gpu(d))
        prep = torch.where(torch.isinf(gpu(d)), BIG, gpu(d))
        want = ap.apsp_plain_blocked(prep, apsp_iters(n), pick_tile(n, B))
        want = torch.where(want >= BIG * 0.5, torch.inf, want)
        if not torch.equal(got, want):
            fail(f"phase 7: tiled APSP (ops.apsp) differs from plain at "
                 f"n={n}")
        if not (torch.isinf(got).any() and torch.isfinite(got).any()):
            fail(f"phase 7: n={n} test graph has no (un)reachable pairs")
    n_t = TILED_NS[1][0]
    d64 = gpu(random_costs(rng, 64, n_t, BIG))
    all64 = ap.apsp_square_cuda(d64, apsp_iters(n_t))
    for i in (0, 63):
        if not torch.equal(ap.apsp_square_cuda(
                d64[i:i + 1].contiguous(), apsp_iters(n_t))[0], all64[i]):
            fail("phase 7: tiled APSP design alone differs from it in a "
                 "batch of 64")
    log("phase 7: tiled APSP bit-equal to plain at n in {161, 200, 256, "
        "576}; alone == in a batch of 64")

    # -- 8. device routing tables ------------------------------------------------
    groups: dict[int, list] = {}
    for topo in TOPOLOGIES:
        if topo == "custom":
            continue
        g = build_graph(make_design(topo, ROUTING_CHIPLETS))
        if g.relay.all():
            groups.setdefault(g.n, []).append((topo, g))
    groups[LARGE_CHIPLETS] = [
        (t, build_graph(make_design(t, LARGE_CHIPLETS)))
        for t in ("mesh", "torus", "hexamesh")]
    host_ms = {}
    want = {}
    for n, members in groups.items():
        t0 = time.perf_counter()
        want[n] = np.stack([build_routing_table(g) for _, g in members])
        host_ms[n] = (time.perf_counter() - t0) / len(members) * 1e3
    ud_graphs = [build_graph(make_design(t, 36))
                 for t in ("mesh", "hexamesh", "kite", "flattened_butterfly")]
    ud_want = [updown_random_table(g, "hops", seed=5) for g in ud_graphs]
    costs = {n: np.stack([_edge_costs(g, "hops") for _, g in members])
             for n, members in groups.items()}
    syncs0 = rdev.host_syncs()
    zero_counts()
    t0 = time.perf_counter()
    lowest = {n: rdev.next_hop_lowest_id_batch(c, device=dev)
              for n, c in costs.items()}
    hops = {n: rdev.hops_next_hop_batch(gpu(np.isfinite(c))).cpu().numpy()
            for n, c in costs.items()}
    ud_got = [rdev.updown_random_table_via_device(g, "hops", seed=5,
                                                  device=dev)
              for g in ud_graphs]
    routing_s = time.perf_counter() - t0
    read_counts("routing", ("apsp_fused", "apsp_square", "minplus"))
    routing_syncs = {k: v - syncs0[k] for k, v in rdev.host_syncs().items()}
    for n, members in groups.items():
        for name, got in (("next_hop_lowest_id_batch", lowest[n]),
                          ("hops_next_hop_batch", hops[n])):
            bad = [members[i][0] for i in range(len(members))
                   if not np.array_equal(got[i], want[n][i])]
            if bad:
                fail(f"phase 8: {name} differs from the host tables at "
                     f"n={n} for {bad}")
    for g, got, ref in zip(ud_graphs, ud_got, ud_want):
        if not np.array_equal(got, ref):
            fail(f"phase 8: up*/down* device table differs from the host "
                 f"table (n={g.n})")
    log(f"phase 8: device tables equal host tables for "
        f"{ {n: [t for t, _ in m] for n, m in groups.items()} } "
        f"and {len(ud_graphs)} up*/down* designs in {routing_s:.3f} s "
        f"(host {host_ms} ms per table); host syncs {routing_syncs}")

    # -- 9. the genome cost function -------------------------------------------
    def check_genomes(what, got, ref):
        for f in ("latency", "throughput"):
            g, r = getattr(got, f), getattr(ref, f)
            if not (np.all(np.isfinite(g)) and np.all(g > 0)):
                fail(f"phase 9: {what}: non-finite or non-positive {f}")
            if not np.allclose(g, r, rtol=RTOL, atol=0.0):
                fail(f"phase 9: {what}: {f} differs from the CPU run by "
                     f"{np.max(np.abs(g / r - 1))} (relative)")
        for f in ("total_chiplet_area", "interposer_area", "power", "cost",
                  "reachable_fraction"):
            if not np.array_equal(getattr(got.reports, f),
                                  getattr(ref.reports, f)):
                fail(f"phase 9: {what}: report {f} differs from the CPU run")

    def alone_equal(what, engine, space, pop, res):
        for i in (0, len(pop) - 1):
            one = engine.evaluate_genomes(space, pop[i:i + 1])
            if not (one.latency[0] == res.latency[i]
                    and one.throughput[0] == res.throughput[i]):
                fail(f"phase 9: {what}: genome {i} alone differs from it in "
                     f"its population")

    eng, eng_cpu = DseEngine(device=dev), DseEngine(device="cpu")
    spaces = {key: (AdjacencySpace(n_chiplets=n, max_degree=8) if n
                    else ParametricSpace(), pop_size, rounds)
              for key, n, pop_size, rounds in GENOME_SPACES}
    gen_syncs = {}
    zero_counts()
    for si, (key, (space, pop_size, rounds)) in enumerate(spaces.items()):
        rng_g = np.random.default_rng(90 + si)
        for r in range(rounds):
            pop = space.sample(rng_g, pop_size)
            syncs0 = rdev.host_syncs()
            res = eng.evaluate_genomes(space, pop)
            gen_syncs[key] = {k: v - syncs0[k]
                              for k, v in rdev.host_syncs().items()}
            check_genomes(key, res, eng_cpu.evaluate_genomes(space, pop))
    read_counts("genomes", ("load_propagate", "minplus"))
    for key, (space, pop_size, _) in spaces.items():
        pop = space.sample(np.random.default_rng(99), pop_size)
        alone_equal(key, eng, space, pop, eng.evaluate_genomes(space, pop))
    # the n = 32 tables: hops builder == lowest-ID builder (fused APSP)
    space32 = spaces["adjacency_32"][0]
    pop = space32.sample(np.random.default_rng(5), 24)
    n32 = space32.n_chiplets
    adj = np.zeros((len(pop), n32, n32), bool)
    bits = pop % 2 == 1
    for b in range(len(pop)):
        adj[b, space32.pair_u[bits[b]], space32.pair_v[bits[b]]] = True
    adj |= adj.transpose(0, 2, 1)
    if not np.array_equal(
            rdev.hops_next_hop_batch(gpu(adj)).cpu().numpy(),
            rdev.next_hop_lowest_id_batch(np.where(adj, 1.0, np.inf),
                                          device=dev)):
        fail("phase 9: hops_next_hop_batch differs from "
             "next_hop_lowest_id_batch on the n = 32 population")
    # steady state: fresh populations, structures already cached
    rates = {}
    for key, (space, pop_size, _) in spaces.items():
        reps = 2 if key == "adjacency_256" else 8
        pops = [space.sample(np.random.default_rng(1000 + i), pop_size)
                for i in range(reps)]
        eng.evaluate_genomes(space, pops[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in pops:
            eng.evaluate_genomes(space, p)
        rates[key] = reps * pop_size / (time.perf_counter() - t0)
    log(f"phase 9: genome metrics within rtol {RTOL} of the CPU, reports "
        f"exact, alone == in population; steady-state evals/s {rates}; "
        f"host syncs per population {gen_syncs}")

    # -- 10. path_cost_minplus ---------------------------------------------------
    g = build_graph(make_design("mesh", 64, routing_metric="latency"))
    sc = step_cost_matrix(g)
    sc_t = gpu(np.where(np.isfinite(sc), sc, np.inf).astype(np.float32))
    nw_t = gpu(np.asarray(g.node_weight, np.float32))
    zero_counts()
    pk = path_cost_minplus(sc_t, nw_t, use_kernel=True)
    read_counts("path_cost_minplus", ("minplus",))
    pp = path_cost_minplus(sc_t, nw_t, use_kernel=False)
    if not torch.equal(pk, pp):
        fail("phase 10: path_cost_minplus kernel route differs from plain")
    arrays, _ = prepare_arrays(make_design("mesh", 64,
                                           routing_metric="latency"))
    pd = path_cost_doubling(gpu(arrays.next_hop), gpu(arrays.step_cost),
                            gpu(arrays.node_weight))
    if not torch.allclose(pk, pd, rtol=RTOL, atol=0.0):
        fail("phase 10: path_cost_minplus differs from path doubling")
    log("phase 10: path_cost_minplus kernel == plain, within 1e-5 of path "
        "doubling on the dijkstra_lowest_id table")

    # -- 11. report ----------------------------------------------------------------
    def held(what, kernel, plain, plain_reps=10) -> dict:
        """Run the kernel and its plain version once on the timed operands,
        fail unless bit-equal, and time both."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"phase 11: {what} kernel differs from plain on the timed "
                 f"operands")
        err = torch.where(got == want, 0.0, (got - want).abs()).max().item()
        return {"max_abs_err": err, "ms": time_cuda(torch, kernel),
                "plain_ms": time_cuda(torch, plain, reps=plain_reps)}

    n64 = ROUTING_CHIPLETS
    d64 = apsp(gpu(costs[n64]), 0)                       # clamped input
    d64 = torch.where(torch.isinf(d64), BIG, d64).contiguous()
    it64 = apsp_iters(n64)
    B3, _, _ = d64.shape
    fused = {"name": "apsp_fused", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/apsp.cu",
             "replaces": "src/repro/kernels/apsp.py:71",
             "shape": [B3, n64, n64], "n_iters": it64, "library_ms": None,
             **held("apsp_fused", lambda: ap.apsp_fused_cuda(d64, it64),
                    lambda: ap.apsp_plain(d64, it64)),
             **bound(8.0 * B3 * n64 * n64, B3 * it64 * n64 ** 3)}
    n256 = LARGE_CHIPLETS
    d256 = apsp(gpu(costs[n256]), 0)
    d256 = torch.where(torch.isinf(d256), BIG, d256).contiguous()
    it256 = apsp_iters(n256)
    B4 = d256.shape[0]
    square = {"name": "apsp_square", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/minplus.cu",
              "replaces": "src/repro/kernels/apsp.py:167",
              "shape": [B4, n256, n256], "n_iters": it256, "library_ms": None,
              **held("apsp_square",
                     lambda: ap.apsp_square_cuda(d256, it256),
                     lambda: ap.apsp_plain_blocked(d256, it256,
                                                   pick_tile(n256, B4)),
                     plain_reps=5),
              **bound(8.0 * B4 * n256 * n256, B4 * it256 * n256 ** 3)}

    def minplus_rec(a, b):
        B, M, K = a.shape
        N = b.shape[-1]
        return {"shape": [B, M, K, N],
                **held(f"minplus {[B, M, K, N]}",
                       lambda: mp.minplus_cuda(a, b),
                       lambda: mp.minplus_plain(a, b)),
                **bound(4.0 * B * (M * K + K * N + M * N), B * M * K * N)}

    # the genome path's selection shapes: dense at n = 32 (P bucket 32), one
    # [n, n] x [n, tile] product per destination slab at n = 256 (P = 8)
    sel = {}
    for key in ("adjacency_32", "adjacency_256"):
        space = spaces[key][0]
        n = space.n_chiplets
        P = gn.bucket_population(spaces[key][1])
        pop = space.sample(np.random.default_rng(3), P)
        tables = space.pair_u, space.pair_v
        adj = np.zeros((P, n, n), bool)
        bits = pop % 2 == 1
        for b in range(P):
            adj[b, tables[0][bits[b]], tables[1][bits[b]]] = True
        adj |= adj.transpose(0, 2, 1)
        adj_t = gpu(adj)
        tile = n if n <= 160 else pick_tile(n, P)
        edge0 = torch.where(adj_t, 0.0, BIG)
        score = torch.where(adj_t[:, :, :tile], 1.0 * (n + 1), BIG)
        sel[key] = {"minplus": minplus_rec(edge0, score.contiguous()),
                    "routing_table_ms": time_cuda(
                        torch, lambda: rdev.hops_next_hop_batch(adj_t),
                        reps=5, warmup=1)}
    head_mp = sel["adjacency_256"]["minplus"]
    minplus = {"name": "minplus", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/minplus.cu",
               "replaces": "src/repro/kernels/minplus.py:31",
               "library_ms": None, **head_mp,
               "max_abs_err": max(v["minplus"]["max_abs_err"]
                                  for v in sel.values())}

    # the genome path's layers at its two adjacency shapes
    genome_layers = {}
    for key in ("adjacency_32", "adjacency_256"):
        space = spaces[key][0]
        pipe = eng._genome_pipeline(space)
        pop = space.sample(np.random.default_rng(4), spaces[key][1])
        P = gn.bucket_population(len(pop))
        pop = np.concatenate([pop, np.repeat(pop[-1:], P - len(pop), 0)])
        bits = gpu((pop % 2).astype(np.int32))
        t = pipe._tables
        kw = dict(n=pipe.n, k_phys=pipe.k_phys, euclid=pipe._euclid)
        adj, step, bw, _ = gn._adjacency_structure(bits, t, **kw)
        nh = rdev.hops_next_hop_batch(adj)
        nw = t["consts"][4].expand(pipe.n)
        s0 = rdev.host_syncs()
        rdev.hops_next_hop_batch(adj)
        bfs_syncs = rdev.host_syncs()["bfs"] - s0["bfs"]
        bits_pad = torch.cat([bits.bool(), torch.zeros(
            (P, 1), dtype=torch.bool, device=dev)], dim=1)
        deg = bits_pad[:, t["pair_id"]].sum(dim=2)
        radix = torch.clamp(deg.amax(dim=1), 1, pipe.k_phys)
        pitch = t["side"][radix] + t["consts"][0]
        structure_ms = time_cuda(
            torch, lambda: gn._adjacency_structure(bits, t, **kw), reps=10)
        phy_ms = time_cuda(torch, lambda: gn._phy_scan(
            bits_pad, deg, radix, pitch, t, n=pipe.n, k_phys=pipe.k_phys),
            reps=10)
        host_t0 = time.perf_counter()
        pipe._report_arrays(pop, space.degrees(pop), np.zeros(len(pop)))
        reports_ms = (time.perf_counter() - host_t0) * 1e3
        wall_s, busy_s, top = profile_device(
            torch, lambda: eng.evaluate_genomes(space, pop), n_top=4)
        genome_layers[key] = {
            "population": P, "n": pipe.n, "k_phys": pipe.k_phys,
            "decode_geometry_ms": structure_ms - phy_ms,
            "phy_scan_ms": phy_ms,
            "routing_tables_ms": time_cuda(
                torch, lambda: rdev.hops_next_hop_batch(adj), reps=10),
            "proxies_ms": time_cuda(torch, lambda: gn._eval_proxies(
                nh, step, nw, bw, t["traffic"], pipe.max_hops), reps=10),
            "host_reports_ms": reports_ms,
            "bfs_host_syncs": bfs_syncs,
            "profiled_wall_ms": wall_s * 1e3,
            "device_busy_ms": busy_s * 1e3,
            "device_idle_share": 1.0 - busy_s / wall_s,
            "top_device_us": dict(top),
            "evals_per_s": rates[key]}
    print(json.dumps({"genome_layers": genome_layers,
                      "parametric_evals_per_s": rates["parametric"],
                      "routing_syncs": routing_syncs,
                      "genome_syncs": gen_syncs}), flush=True)
    print(json.dumps({"minplus_shapes": {k: v["minplus"]
                                         for k, v in sel.items()},
                      "routing_table_ms_per_population": {
                          k: v["routing_table_ms"] for k, v in sel.items()},
                      "host_routing_ms_per_table": host_ms,
                      "sm_clock_hz": clock_hz}), flush=True)
    return [fused, square, minplus]


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
    from repro_torch.kernels import apsp as ap
    from repro_torch.kernels import build
    from repro_torch.kernels import load_prop as lp
    from repro_torch.kernels import minplus as mp
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    kernels = {"load_propagate": lp.load_prop_cuda,
               "apsp_fused": ap.apsp_fused_cuda,
               "apsp_square": ap.apsp_square_cuda,
               "minplus": mp.minplus_cuda}
    path_launches: dict[str, dict] = {}

    def zero_counts() -> None:
        for fn in kernels.values():
            fn.launches = 0

    def read_counts(path: str, needs: tuple) -> dict:
        counts = {name: fn.launches for name, fn in kernels.items()}
        path_launches[path] = counts
        missing = [name for name in needs if counts[name] == 0]
        if missing:
            fail(f"the {path} path launched no {missing} kernel")
        return counts

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
    zero_counts()
    t0 = time.perf_counter()
    sweep = DseEngine(device="cuda", chunk_size=60).run(points)
    sweep_s = time.perf_counter() - t0
    launches["sweep"] = read_counts("sweep", ("load_propagate",))[
        "load_propagate"]
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
    zero_counts()
    t0 = time.perf_counter()
    large = DseEngine(device="cuda").evaluate_points(big)
    large_s = time.perf_counter() - t0
    launches["large_n"] = read_counts("large_n", ("load_propagate",))[
        "load_propagate"]
    check_rows("phase 4", large, DseEngine(device="cpu").evaluate_points(big))
    log(f"phase 4: {len(big)} large-n points in {large_s:.3f} s; kernel "
        f"launches {launches['large_n']}; CPU agrees within {RTOL}")

    # -- 5. one design -----------------------------------------------------------
    design = make_design("mesh", 64)
    traffic = make_traffic("random_uniform", 64)
    zero_counts()
    one = evaluate_design(design, traffic, device="cuda")
    launches["single"] = read_counts("single", ("load_propagate",))[
        "load_propagate"]
    one_cpu = evaluate_design(design, traffic, device="cpu")
    for what in ("latency", "throughput"):
        g, r = getattr(one, what), getattr(one_cpu, what)
        if not (np.isfinite(g) and g > 0 and abs(g / r - 1) <= RTOL):
            fail(f"phase 5: {what} {g} vs CPU {r}")
    if one.to_dict()["cost"] != one_cpu.to_dict()["cost"]:
        fail("phase 5: cost report differs between cuda and cpu")
    log(f"phase 5: 64-chiplet mesh latency {one.latency} throughput "
        f"{one.throughput}; launches {launches['single']}")

    # -- 6. report -------------------------------------------------------------
    # warm sweep: structures cached, so this is the device side plus encode
    t0 = time.perf_counter()
    DseEngine(device="cuda", chunk_size=60).run(points)
    warm_s = time.perf_counter() - t0
    prof_wall_s, busy_s, top = profile_device(
        torch, lambda: DseEngine(device="cuda", chunk_size=60).run(points))

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
    log(f"phase 6: load-propagation launches on the sweep paths: "
        f"{sum(launches.values())} ({launches})")

    # -- 7-11. min-plus kernels, device routing, genome cost function --------
    minplus_records = minplus_paths(torch, dev, zero_counts, read_counts)

    totals = {name: sum(c[name] for c in path_launches.values())
              for name in kernels}
    print(json.dumps({"path_launches": path_launches}), flush=True)
    log(f"kernel launches over all paths: {totals}")
    log(f"wall {time.perf_counter() - t_start:.1f} s")
    records = [{
        "name": "load_propagate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/load_prop.cu",
        "replaces": "src/repro/kernels/load_prop.py:144",
        "also_replaces": "src/repro/kernels/load_prop.py:279",
        "launches": totals["load_propagate"],
        "max_abs_err": max([max_err] + [r["max_abs_err"]
                                        for r in chunk_recs + [large_rec]]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape": head["shape"]}]
    for rec in minplus_records:
        records.append(dict(rec, launches=totals[rec["name"]]))
    print(json.dumps({"kernels": records}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
