#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA Hopper GPU
and check it.

    python3 chip_smoke.py

Phases, each fatal on error (exit code 1, no result line):

1. build every CUDA source of the port with nvcc for sm_90a, all at once
   with the first designs of the scan forward, load propagation and the
   fused APSP (``tools/scan_fwd_steps.py``, ``tools/load_prop_steps.py``,
   ``tools/apsp_steps.py``), and report what ptxas says of each kernel
   (registers, stack frame, spills); a stack frame in the scan forward,
   the min-plus, the load-propagation or the fused APSP kernel fails the
   run;
2. the load-propagation kernel against its plain PyTorch version on the
   card (random routing tables with unreachable pairs and padded vertices,
   n in {16, 100, 128, 160, 256}, B in {1, 7, 256}; W and flow within
   rtol 1e-5 / atol 1e-6) and bit-equal to its first design's, and each
   design of a batch of 256 bit-equal to the same design run alone;
3. the README sweep (10 topologies x {16, 36, 64} chiplets x 2 traffic
   patterns x 2 routings = 120 points) through
   ``DseEngine(device="cuda", chunk_size=60).run``, held within rtol 1e-5
   of the same sweep through the port on the CPU (plain version);
4. the large-n tier (256-chiplet mesh/torus/hexamesh, 100-chiplet kite) via
   ``evaluate_points``, same checks;
5. ``evaluate_design`` on one 64-chiplet mesh, on the card and on the CPU;
6. the report of phases 3-5: per-layer times, and the load-propagation
   kernel at the sweep paths' shapes held bit-equal to its first design
   and timed beside its bound and the plain version's, with the
   profiler's device time per call (``device_ms``, both kernels) and the
   host's time to enqueue one (``enqueue_ms``); after phase 11 the same
   at the ``AdjacencySpace(32, 8)`` genome batch's shape;
7. the min-plus kernels against their plain versions, bit-equal: min-plus
   at M, K, N in {1, 37, 128, 200} x B in {1, 7, 64} with BIG and inf
   entries, at K below, at and above each point where the k split over a
   cluster doubles, at M, N below the 32 x 32 tile, K = 0, on operands
   4 bytes off 16-byte alignment, and twice (bit-equal runs); the fused
   APSP at n in {16, 32, 64, 128, 160}, also bit-equal to its first
   design's over all the squarings, the tiled APSP
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
    it, and its time beside its bound and the plain version's, with the
    profiler's device time per launch (``device_ms``) and the host's time
    to enqueue a call (``enqueue_ms``), the fused APSP's too; the tiled
    APSP squaring's record is
    per squaring (its call divided by ``n_iters``);
    routing-table time per population; the genome path's layers; the host
    syncs of the BFS and up*/down* loops;
12. the selective-scan kernels (forward B7, backward B8) against their plain
    versions at ragged shapes (Di 12, 37, 40, 50, 70, 72 and 100, chunks
    8 to 48, N 1, 3, 4, 8, 12 and 16) and at the
    training path's [2, 2048, 8192], N 16, chunk 256: forward within rtol
    1e-4 / atol 1e-5, backward within rtol 2e-3 / atol 5e-4 (the
    reference's own test bounds: exps and sums over N and over channels in
    another order); the forward's checkpoints and final states bit-equal
    to its first design's (one thread per channel); two runs bit-equal; a
    sequence alone bit-equal to it in the batch; their times at the path's
    shape beside their bounds, the forward's device time per launch too;
13. training: ``repro_torch.launch.train.train`` on falcon-mamba-7b at its
    published widths (d_model 4096, d_inner 8192, N 16, vocab 65024, bf16
    compute, f32 parameters, remat "full") cut to 2 layers, batch 2 x 2048
    tokens, 4 AdamW steps at lr 1e-4 on ``SyntheticTokens``: every loss
    finite and the last below the first, both scan kernels launched, and
    the same run on the chunked-scan route within rtol 1e-3; one float32
    step of the kernel route against the chunked-scan route from the same
    parameters (loss within rtol 1e-4, gradient norm within rtol 1e-3);
    step time, tokens/s, peak memory, the device's idle share and the layers
    of a step (CUDA events);
14. the pair-walk throughput oracle: the flow-accumulation kernel (B6)
    bit-equal to the CPU's ascending-p scatter of the in-range pairs
    (uniform pairs, duplicate cells, one row holding every pair, pair counts
    off the chunk, out-of-range pairs, n up to 1720) and within rtol 1e-5 of
    ``index_add_`` on the card, alone == in a batch (the record's hop too);
    ``throughput_proxy(use_kernel=True)`` on every registry topology at 64
    chiplets and the 256-chiplet mesh within rtol 1e-5 of the
    load-propagation route; one hop's kernel time beside its bound, the
    plain version's and ``index_put_(accumulate=True)``'s, with its four
    kernels' device time and its enqueue time (the scan kernels' records
    carry both too);
15. the fault grid: ``DseEngine(device="cuda").evaluate_genomes_faults_async``
    on ``AdjacencySpace(32, 8)`` at population 16 under i.i.d. link faults
    (p 0.05) with F in {1, 8, 32} scenarios and under every single-chiplet
    fault: within rtol 1e-5 of the CPU grid, the pristine column bit-equal
    to ``evaluate_genomes``, a genome alone bit-equal to it in the grid; on
    the dead-chiplet grid's own operands the routing tables equal the
    CPU's and load propagation is within rtol 1e-5 / atol 1e-6 of plain and
    bit-equal to its first design; design- and scenario-evals/s per F and
    the device idle share of one F = 32 call;
16. the optimizer: (a) ``python -m repro_torch.opt``'s ``main`` at its CLI
    defaults (NSGA-II, ``AdjacencySpace(32, 8)``, population 24, 20
    generations, seed 0) on the card, sync and ``--async`` with bit-equal
    fronts, a resume from generation 10 equal to the uninterrupted run, a
    traced async run (its spans and overlap share) and a profiled one (the
    device idle share); (b) ``benchmarks/opt_convergence.py``'s
    robust-versus-pristine experiment (n 16, degree 3, population 16, 12
    generations, interposer area 6500, the exhaustive single-link battery):
    every design of the robust front keeps all its traffic under every
    scenario, both fronts' battery grids within rtol 1e-5 of the CPU's,
    printed beside the JAX package's record in ``BENCH_faults.json``;
17. the search service, ``SearchService(device="cuda")``: (a)
    ``benchmarks/serve_load.py``'s mix, 100 jobs in ``AdjacencySpace(10,
    4)`` (NSGA-II, SA and random, populations 4-8, 4 generations, 4
    tenants, 16 running at once), five sampled jobs bit-identical to their
    solo runs on the card (front bytes, eval count, ``optimizer.state()``),
    evals/s, p50/p99 job latency, rounds, mega-dispatches and their mean
    occupancy, the ``serve.*`` spans, and the device idle share of one
    profiled round of 16 jobs; (b) 8 jobs at ``AdjacencySpace(32, 8)``,
    population 24, 5 generations, each bit-identical to its solo run, its
    front's objectives within rtol 1e-5 of the CPU's; min-plus and
    load-propagation rows bit-equal at B = 8 and B = 256 (where the
    min-plus k split differs); (c) a job armed with
    ``chaos_fail_generation`` ends FAILED, its batch-mates bit-identical;
    (d) ``python -m repro_torch.serve --device cuda`` on a jobs file,
    SIGKILLed mid-run, restarted on the same state dir and SIGTERM-drained
    mid-run (exit 0, jobs suspended), then resumed to the end by a
    ``SearchService`` on that state dir: the survivors' front files
    byte-equal to their solo fronts, the chaos job FAILED;
18. the simulator: ``FastSim.run_batch(backend="torch")`` on the card
    (CUDA graphs of ``simfast_torch.K_CYCLES`` cycles) with every
    ``SimStats`` field equal to the numpy and C backends' on
    ``benchmarks/validate_proxies.py``'s engine-calibration design (a
    64-chiplet mesh, random-uniform traffic, 2560-cycle windows) at the
    saturation search's first chunk of 5 rates, and on a 16-chiplet mesh
    under transpose traffic (over a 700-cycle window also eagerly, one
    launch per op, timed against the graphs);
    ``saturation_throughput_batched(backend="torch", chunk=10)`` on the
    64-chiplet mesh with the numpy and C backends' rate and probe count
    (chunk 5); the wall time of each backend;
19. checkpointed training, trace import and the pictures: (a)
    ``repro_torch.launch.train.train`` at phase 13's configuration, 4 steps
    uninterrupted against 2 steps, a SIGTERM (the handler's checkpoint to a
    temporary directory), and a fresh ``Model`` and optimizer state
    restored from disk for the last 2 steps: losses, parameters, AdamW
    moments and the step counter bit-equal; the checkpoint's bytes and
    shards and the ``ckpt.save`` / ``ckpt.restore`` span seconds; (b) a
    20000-event ``synthetic_trace`` on a 64-chiplet mesh written, parsed
    and aggregated into traffic, ``evaluate_design`` on the card within
    rtol 1e-5 of the CPU and within rtol 1e-6 of the port's f64 oracle
    (``core/reference.py``); (c) ``design_to_svg`` of that mesh and
    ``latency_vs_load`` on it with the torch backend on the card, its rows
    equal to the numpy and C backends' field for field;
20. the static gate: ``python -m repro_torch.analysis --check`` in-process,
    the lint of ``src/repro_torch`` and every registry contract recorded on
    the card, each contract's kernels launched (B1/B2, B3/B4, B5 over the
    phase), 0 unsuppressed findings; findings per check and seconds per
    contract;
21. serving: ``repro_torch.launch.serve.generate`` and ``Model.prefill`` for
    every decoder-only config at its published widths, one model at a time
    (qwen2.5-3b and hymba-1.5b at full depth, the others cut to 2 layers,
    DeepSeek's dense first layer kept): 4 prompts of 16 tokens and 32 new
    greedy tokens (every logit finite, two runs equal), a prefill at 2 x
    2048 (flash attention, banded for hymba), the decode step's logits at
    the first 64 positions within rtol/atol 0.05 of the forward pass's in
    float32 (the reference's decode-vs-forward bound; in bf16 the
    difference is reported), hymba's ring buffer (window cut to 64, 96
    steps, float32, within 0.06); for hymba and falcon-mamba B7 held at
    the prefill in float32 against the plain scan on each layer's inputs
    within the scan's test bounds, launched once per Mamba layer, and the
    logits against the chunked-scan route's within 1e-4; every config at
    ``reduced(cfg, dtype="float32")`` on the card against the CPU (greedy
    tokens equal, logits within rtol / atol 1e-5); decode ms per step and
    tokens/s, prefill tokens/s, and the device idle share of a decode step;
22. training every family: (a) whisper-medium at its published widths and
    depth (24 encoder and 24 decoder layers, d_model 1024, vocab 51865,
    1500 frames): forward and loss at 2 x 2048 tokens, the cross-KV cache
    filled from the encoder, the decode step against the forward over the
    first 64 positions (float32 within rtol/atol 0.05; bf16 reported),
    ``launch.serve.generate`` with that cache (4 prompts of 16 tokens, 32
    new, two runs equal), 4 AdamW steps; (b) qwen2.5-3b, olmoe-1b-7b,
    deepseek-v2-lite-16b, hymba-1.5b and llava-next-34b at published widths
    cut to 2 layers (phase 21's models of that cut reused), 4 AdamW steps
    at 2 x 2048 (llava: 576 patches and 1472 tokens), losses finite, scan
    launches as remat predicts; hymba's B7 and B8 held on every launch of
    its first step against their plain versions on the layer's own inputs
    at [2, 2048, 3200] (the scans' test bounds) and B8 timed there beside
    its bound; build seconds, step ms, tokens/s, peak memory and the device
    idle share of a step; (c) each of the six at ``reduced(cfg,
    dtype="float32")`` on the card against the CPU (loss within rtol 1e-5,
    gradient norm within rtol 1e-4); (d) hymba at reduced widths under
    remat "dots", "full" and "none": losses and gradients bit-equal, the
    scan launches each policy predicts.
23. the dry-run and sharding stack: (a) ``core.ici_model
    .estimate_collective`` for every collective kind over both axes of the
    16 x 16 pod, torus and mesh (load propagation at n = 256, B2's tier),
    and of the 4 x 4 pods (B1's), one launch per estimate, every field
    within rtol 1e-5 of the host's, the torus ring all-gather's proxy
    within 1e-6 of its analytic time; B2 timed at the pod's [1, 256, 256];
    ms per estimate on the card and on the host; (b)
    ``sharding.autoshard.rank_layouts`` for every arch at train_4k on
    {data: 16, model: 16}: rankings equal to the host's, totals within
    rtol 1e-5; (c) ``quantize_int8`` bit-equal to the host's at 57 x 33
    and 4096 x 4096, ``make_compressed_allreduce`` over an NCCL world of 1
    within half a quantisation step of its input, a 1-stage
    ``pipeline_apply`` equal to the direct stack; (d) a qwen2.5-3b train
    step at published widths cut to 2 layers, 2 x 2048 tokens, under
    ``FlopCounterMode``: exactly the FLOPs of ``launch.dryrun``'s meta
    trace, its step ms and TFLOP/s, and its peak memory beside the
    dry-run's argument and temp bytes on one device; (e) the dry-run cells
    of ``dryrun_tasks`` on host worker processes during (a)-(d), each
    record rank 0 of its production mesh (``launch.mesh.counting_world``)
    and sane, with the rank's FLOPs over an ideal split of one device's
    (not a gate: the port repeats on every model rank what the rules keep
    whole), its temp bytes and its collectives by kind, seconds per
    cell; a long_500k decode step (``LONG_CONTEXT_ARCHS`` on both meshes)
    gathers no parameter (its all-gathers average at most one token's
    largest activation) and falcon-mamba-7b's on 16 x 16 is under
    ``LONG_FALCON_MAX_RATIO`` x the ideal split; olmoe-1b-7b's decode_32k
    on 16 x 16, whose MoE layer keeps each expert leaf's data shard, is
    under ``MOE_DECODE_MAX_RATIO`` x the ideal split and all-gathers fewer
    than ``MOE_DECODE_MAX_GATHER_BYTES``.
24. population sharding: engines over ``["cuda:0"] * k`` for k in {2, 4}
    (and over every visible card where there are several), each shard its
    own dispatch, adaptive loops and kernel launches: ``evaluate_genomes``
    on ``AdjacencySpace(12, 4)`` at population 10, ``(32, 8)`` at 24,
    ``(256, 8)`` at 8 (B2; 2-row shards at k = 4) and ``ParametricSpace``
    over mesh and torus at 9 and 16 chiplets at 10, and
    ``evaluate_genomes_faults_async`` at phase 15's configuration (i.i.d.
    faults at F = 8, and every single-chiplet fault): latency, throughput,
    reachable fraction and reports bit-equal to the one-shard engine on
    the card, latency and throughput within rtol 1e-5 of the CPU; phase 3's
    120-point sweep through ``DseEngine.run`` at k = 4 bit-equal to k = 1;
    NSGA-II through ``PopulationEvaluator`` (``AdjacencySpace(16, 5)``,
    population 16, 5 generations) on 4 shards with one shard's front and
    state; a ``SearchService`` round of 4 co-batched jobs over 4 shards,
    each job bit-identical to its solo run; B1, B2 and B5 launches; evals/s
    and the device idle share at k = 1, 2 and 4 on ``AdjacencySpace(32,
    8)`` at population 24.
25. sharded training over a ``torch.distributed`` device mesh: hymba-1.5b
    at its published widths cut to 2 layers (remat "full", the scan
    kernels), 2 AdamW steps at lr 1e-4 on 2 x 2048 tokens, (a) under a
    (1, 1) ("data", "model") mesh of an NCCL world of 1 (parameters,
    moments and batches placed as DTensors, the meshed step) against the
    same steps on one device: losses, gradient norms and every parameter
    within rtol 1e-6 / atol 1e-7 (bit-equal expected), B7 / B8 launched as
    remat predicts in each; (b) the meshed state saved and restored with
    ``shardings``, bit-equal; (c) a (2, 2) world, four gloo ranks sharing
    the card (NCCL ranks a card each where there are several; (1, 2) at
    two or three cards), whose steps run the context-parallel attention
    (25 heads on a model axis of 2) and the scan once a shard
    ([1, 2048, 1600]): losses and gradient norms within rtol 2e-3 of world
    1's, the largest parameter difference, step ms, tokens/s, each rank's
    bytes of parameters and optimizer state, the collectives of a step by
    kind (``CommDebugMode``), and B7 / B8 timed at the shard's shape
    beside their bounds; (d) deepseek-v2-lite-16b at its published widths
    cut to 2 layers (1 dense, 1 MoE of 64 experts top-6 and 2 shared;
    1.085e9 parameters, float32), drawn once on the host into a file the
    ranks map, 2 AdamW steps in world 1 and in the same (2, 2) world (MLA's
    heads, 32 experts a model rank, a vocabulary-parallel cross-entropy
    over 102400 words), held to world 1 by (c)'s gates, each rank's bytes
    of parameters and AdamW state logged; rank 0 counts its first step
    as the dry-run counts (``FlopCounterMode`` and ``StepCounter``), and
    its FLOPs and each collective's count and result bytes by kind must
    equal exactly the meta count of the same rank, step and mesh, taken
    on a spawned host process meanwhile; (e) qwen2.5-3b at its published
    widths cut to 2 layers (bf16), drawn once on the host into a file the
    ranks map, an AdamW step in world 1 and on a (1, 4) mesh of the same
    four ranks, whose model axis its 2 KV heads do not divide (query heads
    split, K and V projected whole on every rank, the query-split
    attention counted on each rank), held to world 1 by (c)'s gates.
    ``python3 chip_smoke.py --phase 25`` runs this phase alone.
26. serving on a ``torch.distributed`` device mesh: hymba-1.5b at its
    published widths cut to 4 layers (the scan kernels), qwen2.5-3b and
    deepseek-v2-lite-16b cut to 2, whisper-medium cut to 2 encoder and 2
    decoder layers (1500 frames), ``Model.prefill`` at 2 x 2048 and
    ``generate``'s 4 prompts of 16 tokens and 16 new ones (whisper's
    greedy tokens from its own decode loop, its cross cache from
    ``Model.encode`` and ``Model.cross_kv``), placed by the reference's
    param, cache and batch specs. (a) Under a (1, 1) mesh of an NCCL
    world of 1, for each of ``DEFAULT_RULES``, ``SERVING_RULES`` and
    ``LONG_CONTEXT_RULES`` (batch 1), float32 hymba and whisper against
    one device: the prefill's and every teacher-forced decode step's
    logits and hymba's ``generate`` tokens bit-equal, B7 launched once per
    Mamba layer of each prefill. (b) A (2, 2) world (four gloo ranks on
    the card; NCCL ranks a card each on several) teacher-forced on one
    device's tokens: hymba and whisper under all three rule sets,
    qwen2.5-3b and deepseek (32 experts a model rank) under the default
    and serving ones, float32
    logits of the prefill (the context-parallel attention, B7 once a
    shard at [1, 2048, 1600]) and of every decode step within rtol / atol
    1e-4 and every greedy token equal, bfloat16 reported; decode ms a step,
    tokens/s, prefill tokens/s, each rank's bytes of parameters and cache,
    a decode step's collectives by kind, and B7 held against its plain
    version and timed at the shard's shape beside its bound; rank 0 counts
    one more ``SERVING_RULES`` and one more ``DEFAULT_RULES`` decode step
    of deepseek, one more ``LONG_CONTEXT_RULES`` decode step of hymba and
    of whisper and one more ``SERVING_RULES`` prefill of qwen2.5-3b, each
    held exactly to the dry-run's meta count as in phase 25; a
    ``LONG_CONTEXT_RULES`` decode step, whose weights keep their data
    shards, all-gathers over "data" only one token's activation ([1, 1,
    d_model]); a ``DEFAULT_RULES`` decode step of deepseek, whose MoE
    layer gathers its tokens over "data" and keeps each leaf's data
    shard, gathers there only the tokens' activation and the output
    columns, no router, expert or shared-expert leaf; under
    ``SERVING_RULES`` qwen's and whisper's prefills take the query-split
    attention (``wk`` / ``wv`` whole over "model": K and V projected whole
    on each rank, whisper's cross-attention K and V for the rank's own
    heads), counted on every rank. ``python3 chip_smoke.py --phase 26``
    runs this phase alone.

Every path (phases 3, 4, 5, 8, 9, 10, 13, 14, 15, 16, 17, 19, 20, 21, 22,
23, 24, 25, 26)
is driven with every kernel's launch count set to 0 just before it and read
just after; a path whose kernels were not launched fails the run. Launches
made to compare a kernel with its plain version are not counted. The
second-to-last line carries the card's name and power limit from
nvidia-smi, the line before it the ``{"kernels": [...]}`` record, and the
last line ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/`` beside this file, it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
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
# min-plus at the k-split and tile edges (B, M, K, N): one 64 x 64 tile,
# whose split doubles at K = 32, 64 and 128 (K below, at and above each);
# M or N below 64 (32 x 32 tiles) and below 32; K = 0; the paths' shapes
MINPLUS_EDGES = ((1, 64, 31, 64), (1, 64, 32, 64), (1, 64, 33, 64),
                 (1, 64, 63, 64), (1, 64, 64, 64), (1, 64, 65, 64),
                 (1, 64, 127, 64), (1, 64, 128, 64), (1, 64, 129, 64),
                 (2, 70, 255, 65), (3, 63, 100, 64), (5, 7, 100, 20),
                 (1, 31, 64, 33), (4, 1, 300, 1), (32, 32, 32, 32),
                 (2, 5, 0, 7), (8, 256, 256, 64), (3, 256, 256, 256))
FUSED_NS = (16, 32, 64, 128, 160)          # fused APSP check
TILED_NS = ((161, 4), (200, 4), (256, 4), (576, 2))   # tiled APSP: (n, B)
ROUTING_CHIPLETS = 64       # registry topologies for the device tables
LARGE_CHIPLETS = 256        # mesh/torus/hexamesh on the tiled APSP
GENOME_SPACES = (   # (name, n_chiplets or None for parametric, population,
    ("adjacency_32", 32, 24, 3),            # fresh populations checked)
    ("adjacency_256", 256, 8, 1),
    ("parametric", None, 64, 2))
SCAN_SHAPES = ((2, 24, 12, 4, 8), (2, 24, 12, 8, 8),  # B, S, Di, N, chunk
               (2, 96, 40, 4, 24), (2, 96, 72, 8, 48), (1, 120, 100, 16, 40),
               # N off the padded 4 / 8 / 16, Di off the block's 32 channels
               # and off a multiple of 4, S off the 32-step tile
               (2, 64, 37, 1, 16), (2, 80, 50, 3, 40), (3, 72, 70, 12, 24))
TRAIN_ARCH = "falcon-mamba-7b"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2, 2048, 4
TRAIN_LR = 1e-4     # at 3e-4 the first AdamW step diverges at this width
# bf16 losses of the two scan routes: f32 scans summed in another order and
# cast to bf16, then AdamW steps that are close to lr * sign(g)
TRAIN_ROUTE_RTOL = 1e-3
FLOW_CHIPLETS, FLOW_LARGE = 64, 256     # pair-walk oracle: registry, mesh
FLOW_CASES = (      # flow kernel vs the CPU scatter: B, n, P, kind of pairs
    (1, 8, 64, "uniform"), (4, 20, 400, "uniform"), (13, 64, 4096, "uniform"),
    (1, 256, 65536, "uniform"), (3, 130, 16900, "uniform"),
    (1, 6, 300, "two_rows"), (2, 33, 1000, "one_row"), (2, 20, 777, "uniform"),
    (3, 12, 500, "out_of_range"), (2, 256, 140000, "one_row"),
    (1, 1720, 50000, "uniform"))
SCAN_FWD_TOL = dict(rtol=1e-4, atol=1e-5)   # the reference's test bounds
SCAN_BWD_TOL = dict(rtol=2e-3, atol=5e-4)
SFU_PER_SM = 16                 # MUFU.EX2 results per clock per SM (sm_90)
# the kernels of one call of each multi-kernel wrapper: launches per call
LOAD_PROP_KERNELS = {"load_prop_hops": 1, "load_prop_flow": 1}
FLOW_KERNELS = {"fa_hist": 1, "fa_scan": 1, "fa_scatter": 1, "fa_walk": 1}
SCAN_BWD_KERNELS = {"ssm_bwd": 1, "sum_mid": 3}
PROFILER_SESSIONS = 4   # sessions tried before a kernel's records count as lost
# the fault grid: AdjacencySpace(n, degree) at population 16, iid link
# faults (p 0.05) with F - 1 sampled scenarios after the pristine one
# (benchmarks/opt_convergence.py's fault_overhead shapes)
FAULT_SPACE, FAULT_POP, FAULT_FS = (32, 8), 16, (1, 8, 32)
# python -m repro_torch.opt at its CLI defaults
OPT_CLI = {"space": "adjacency", "n_chiplets": 32, "max_degree": 8,
           "pop_size": 24, "generations": 20, "seed": 0, "algo": "nsga2"}
# benchmarks/opt_convergence.py's robust_vs_pristine (AREA_BUDGET 6500,
# the exhaustive single-link battery)
ROBUST = {"n": 16, "degree": 3, "pop": 16, "generations": 12,
          "area_budget": 6500.0}
# benchmarks/serve_load.py's load mix: jobs in AdjacencySpace(10, 4),
# NSGA-II/SA/random, populations 4-8, 4 tenants
SERVE_SPACE = {"kind": "adjacency", "n_chiplets": 10, "max_degree": 4}
SERVE_ALGOS, SERVE_POPS = ("nsga2", "sa", "random"), (4, 5, 6, 8)
SERVE_LOAD = {"jobs": 100, "generations": 4, "max_jobs": 16, "sampled": 5}
# the optimizer CLI's space at full width: 8 co-batched jobs
SERVE_FULL = {"space": {"kind": "adjacency", "n_chiplets": 32,
                        "max_degree": 8},
              "jobs": 8, "pop_size": 24, "generations": 5}
# the simulator: benchmarks/validate_proxies.py's engine calibration (a
# 64-chiplet mesh, random-uniform traffic, cycles max(600, 40 n)) and a
# 16-chiplet mesh under transpose traffic
SIM_CHIPLETS, SIM_SMALL = 64, 16
# checkpointed training: phase 13's configuration, RESUME_STEPS steps
# uninterrupted against a SIGTERM after RESUME_AT steps and a resume
RESUME_STEPS, RESUME_AT = 4, 2
# trace import: a synthetic trace folded into a 64-chiplet mesh's traffic;
# the f32 proxies against the port's f64 oracle
TRACE_CHIPLETS, TRACE_EVENTS, ORACLE_RTOL = 64, 20000, 1e-6
# serving: every decoder-only config at its published widths through
# launch.serve.generate (its CLI's 4 prompts of 16 tokens, 32 new) and
# Model.prefill at 2 x 2048; qwen2.5-3b and hymba-1.5b at full depth, the
# others cut to SERVE_LAYERS (falcon-mamba-7b to phase 13's TRAIN_LAYERS)
SERVE_FULL_DEPTH = ("qwen2.5-3b", "hymba-1.5b")
# models phase 21 draws on the host at once, ahead of the card: at most
# three of its configs' float32 weights on the host (36 GB at the largest)
DRAW_AHEAD = 3
SERVE_LAYERS = 2
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 16, 32
PREFILL_BATCH, PREFILL_SEQ = 2, 2048
DECODE_POSITIONS = 64
DECODE_TOL = dict(rtol=0.05, atol=0.05)     # tests/test_models_smoke.py:137
RING_ARCH, RING_WINDOW, RING_STEPS = "hymba-1.5b", 64, 96
RING_TOL = dict(rtol=0.06, atol=0.06)       # tests/test_moe_cache.py:95
CARD_CPU_TOL = dict(rtol=1e-5, atol=1e-5)
# float32 logits of the two scan routes through a whole model: f32 sums in
# another order alone (decode against forward, same run) move hymba-1.5b's
# and the other configs' logits by up to 3.5e-5 on the card, so the routes
# are held at 1e-4 and B7 itself within SCAN_FWD_TOL on each layer's inputs
ROUTE_LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# training every family (phase 22): whisper-medium at its published widths
# and depth; the others at published widths cut to SERVE_LAYERS, batch
# TRAIN_BATCH x TRAIN_SEQ, FAMILY_STEPS AdamW steps at TRAIN_LR; each at
# reduced(cfg, float32) against the CPU (loss within CARD_CPU_TOL's rtol,
# the gradient norm within CARD_CPU_GRAD_RTOL: f32 sums in another order
# over every leaf); the remat policies on REMAT_ARCH at reduced widths
ENCDEC_ARCH = "whisper-medium"
FAMILY_ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                "hymba-1.5b", "llava-next-34b")
FAMILY_STEPS = 4
CARD_CPU_GRAD_RTOL = 1e-4
REMAT_ARCH = "hymba-1.5b"
# the dry-run and sharding stack (phase 23): the pod interconnect model at
# 16 x 16 (B2, n = 256) and 4 x 4 (B1), every estimate held against the CPU
# at ICI_RTOL and the torus ring all-gather's proxy against its analytic
# time at RING_ALLGATHER_REL (tests/test_ici_model.py); the dry-run cells
# below run on DRYRUN_WORKERS host processes while the card works; the FLOP
# check trains FLOP_ARCH at published widths cut to FLOP_LAYERS
ICI_BYTES, ICI_RTOL, RING_ALLGATHER_REL = 4e9, 1e-5, 1e-6
ICI_KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")
RANK_SHAPE = {"data": 16, "model": 16}
DRYRUN_WORKERS = 7
# the cells (dryrun_tasks): every arch at decode_32k on 16x16 (and at
# long_500k where it runs, LONG_CONTEXT_ARCHS, on both meshes); train_4k
# on 16x16 for the archs whose trace fits the phase (falcon-mamba-7b,
# hymba-1.5b, llava-next-34b and nemotron-4-15b take 60-150 s of host
# each); qwen2.5-3b through every shape but
# prefill_32k on both meshes (its three counts, about 160 s of host, are
# the CLI's: python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape
# prefill_32k); each variant where it changes the step
DRYRUN_ARCH = "qwen2.5-3b"
DRYRUN_TRAIN = ("qwen2.5-3b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                "glm4-9b", "codeqwen1.5-7b", "whisper-medium")
FLOP_ARCH, FLOP_LAYERS = "qwen2.5-3b", 2
# long_500k's archs; falcon-mamba-7b's decode step there on 16 x 16 keeps
# each weight's data shard (16.0 x the ideal split where every data rank
# gathered the weights and ran the whole step)
LONG_CONTEXT_ARCHS = ("falcon-mamba-7b", "hymba-1.5b")
LONG_FALCON_MAX_RATIO = 2.0
# olmoe-1b-7b's decode_32k on 16 x 16 under DEFAULT_RULES: its MoE layer
# gathers the tokens over "data" and keeps each expert leaf's data shard
# (5.6783 x the ideal split and 1.748e9 bytes of all-gathers where every
# data rank gathered the experts whole; 1.0101 x and 1.370e8 bytes in the
# dry-run on the host)
MOE_DECODE_ARCH = "olmoe-1b-7b"
MOE_DECODE_MAX_RATIO = 1.5
MOE_DECODE_MAX_GATHER_BYTES = 1.748e9
# population sharding: shard lists ["cuda:0"] * k, the genome spaces
# (name, n_chiplets or None for the parametric space, population), the
# NSGA-II run and the service round, and the timed calls per shard count
SHARD_COUNTS = (2, 4)
SHARD_GENOMES = (("adjacency_12", 12, 10), ("adjacency_32", 32, 24),
                 ("adjacency_256", 256, 8), ("parametric", None, 10))
SHARD_OPT = {"n_chiplets": 16, "max_degree": 5, "pop_size": 16,
             "generations": 5, "seed": 7}
SHARD_JOBS = 4
SHARD_RATE_REPS = 5
# meshed training (phase 25): hymba-1.5b at published widths cut to
# MESH_LAYERS, MESH_STEPS AdamW steps at TRAIN_LR on TRAIN_BATCH x TRAIN_SEQ
# under a (1, 1) mesh against one device (bit-equal expected, gated at
# MESH_TOL), and on several cards against world 1 (MESH_CARDS_RTOL on the
# bf16 loss and gradient norm; on each leaf of AdamW's first moment, a sum
# of the leaf's clipped gradients, MESH_MOMENT_RTOL on the relative L2
# difference and MESH_MOMENT_NORM_RTOL on the relative difference of the
# norms, which a gradient off by a factor moves and bf16 noise barely
# does), B7 / B8 there held against their plain versions on a shard
MESH_ARCH, MESH_LAYERS, MESH_STEPS = "hymba-1.5b", 2, 2
MESH_TOL = dict(rtol=1e-6, atol=1e-7)
MESH_CARDS_RTOL = 5e-4
MESH_MOMENT_RTOL, MESH_MOMENT_NORM_RTOL = 5e-2, 3e-3
MESH_WORLD_TIMEOUT = 600
# meshed serving (phase 26): SERVE_MESH_LAYERS layers of each arch at its
# published widths (hymba-1.5b on the scan kernels), Model.prefill at
# PREFILL_BATCH x PREFILL_SEQ and generate's SERVE_BATCH prompts of
# SERVE_PROMPT tokens and SERVE_MESH_NEW new ones (batch 1 under
# LONG_CONTEXT_RULES); one device's runs (SERVE_REFERENCES: arch, dtype,
# batch 1) feed and hold the meshed ones: the (1, 1) mesh bit-equal, the
# (2, 2) world's SERVE_WORLD_RUNS (arch, rule set, dtype) within
# SERVE_MESH_TOL in float32, teacher-forced on one device's tokens, every
# decode step under SERVING_RULES and the first SERVE_FSDP_STEPS under the
# other two (DEFAULT_RULES gathers the weights over "data" every step;
# LONG_CONTEXT_RULES, whose steps move no weight, takes as many so that
# the phase does not grow); rank 0 counts one more decode step of each of
# SERVE_COUNTED (arch, rule set, dtype); every all-gather over "data" of
# MOE_ARCH's DEFAULT_RULES decode steps in its MoE layer is at most the
# tokens' activation (SERVE_BATCH x d_model)
# phases 25 and 26's MLA and MoE model: deepseek-v2-lite-16b at its
# published widths cut to MOE_LAYERS (its dense first layer and one layer
# of 64 routed experts top-6 and 2 shared experts), in float32 (bf16
# rounding that differs between worlds would flip top-6 choices); drawn
# once a run on the host and shared with the ranks through a mapped file
MOE_ARCH, MOE_LAYERS = "deepseek-v2-lite-16b", 2
# phase 25's query-split attention: GQA_ARCH at its published widths cut to
# GQA_LAYERS (bf16, remat "full"), GQA_STEPS AdamW steps on a (1, W) mesh of
# the W-rank world against world 1, held by the (2, 2) world's bf16 gates;
# at four ranks its 2 KV heads do not divide the model axis, so wq / wo
# are split and wk / wv whole (each rank projects K and V whole); drawn
# once a run on the host and shared with the ranks through a mapped file
GQA_ARCH, GQA_LAYERS, GQA_STEPS = "qwen2.5-3b", 2, 1
# whisper-medium (phase 26) at its published widths cut to ENCDEC_LAYERS
# encoder and as many decoder layers, 1500 frames
ENCDEC_LAYERS = 2
SERVE_MESH_LAYERS = {"hymba-1.5b": 4, "qwen2.5-3b": SERVE_LAYERS,
                     ENCDEC_ARCH: ENCDEC_LAYERS, MOE_ARCH: MOE_LAYERS}
SERVE_MESH_NEW = 16
SERVE_MESH_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_FSDP_STEPS = 2
SERVE_COUNTED = ((MOE_ARCH, "serving", "float32"),
                 (MOE_ARCH, "default", "float32"),
                 ("hymba-1.5b", "long", "float32"),
                 (ENCDEC_ARCH, "long", "float32"))
SERVE_REFERENCES = (("hymba-1.5b", "float32", False),
                    ("hymba-1.5b", "float32", True),
                    ("hymba-1.5b", "bfloat16", False),
                    ("qwen2.5-3b", "float32", False),
                    (ENCDEC_ARCH, "float32", False),
                    (ENCDEC_ARCH, "float32", True),
                    (MOE_ARCH, "float32", False))
SERVE_WORLD_RUNS = (("hymba-1.5b", "serving", "float32"),
                    ("hymba-1.5b", "default", "float32"),
                    ("hymba-1.5b", "long", "float32"),
                    ("hymba-1.5b", "serving", "bfloat16"),
                    ("qwen2.5-3b", "serving", "float32"),
                    ("qwen2.5-3b", "default", "float32"),
                    (ENCDEC_ARCH, "serving", "float32"),
                    (ENCDEC_ARCH, "default", "float32"),
                    (ENCDEC_ARCH, "long", "float32"),
                    (MOE_ARCH, "serving", "float32"),
                    (MOE_ARCH, "default", "float32"))
# the (1, 1) mesh's archs, each under every rule set against one device
SERVE_WORLD1_ARCHS = ("hymba-1.5b", ENCDEC_ARCH)
SWEEP_TOPOLOGIES = ("mesh", "torus", "folded_torus", "flattened_butterfly",
                    "hexamesh", "hexatorus", "sid_mesh", "octamesh", "kite",
                    "double_butterfly")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One progress line, with the seconds since the script started."""
    print(f"[chip_smoke {time.perf_counter() - _T0:.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_report(logs: dict) -> dict:
    """{kernel: {registers, stack_frame, spill_stores, spill_loads}} from the
    ``-Xptxas -v`` output of each source's build (kernel names demangled by
    c++filt where the toolkit's host has it)."""
    report, mangled = {}, []
    for source, text in logs.items():
        key = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                key = m.group(1)
                mangled.append(key)
                report[key] = {"source": source}
                continue
            if key is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                report[key].update(stack_frame=int(m.group(1)),
                                   spill_stores=int(m.group(2)),
                                   spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[key]["registers"] = int(m.group(1))
    try:
        out = subprocess.run(["c++filt"], input="\n".join(mangled),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
        names = {k: v.replace("(anonymous namespace)::", "").removeprefix(
            "void ").split("(")[0] for k, v in zip(mangled, out)}
    except (OSError, subprocess.SubprocessError):
        names = {k: k for k in mangled}
    return {names[k]: v for k, v in report.items()}


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
        # only the device's own events (kernels, copies): a CPU op's entry
        # repeats the time of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            kernel_us[ev.key] = us
    busy_s = sum(kernel_us.values()) / 1e6
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:n_top]
    return wall_s, busy_s, top


class ProfilerMiss(RuntimeError):
    """The profiler recorded none of a kernel's launches, or more than were
    made."""


def device_ms_by_kernel(torch, fn, launches: dict, reps: int = 10) -> dict:
    """The profiler's device time per launch of each kernel named in
    ``launches`` ({name part: launches per call of ``fn``}), over ``reps``
    calls of ``fn`` in one session: the summed device time of the kernels
    whose name holds that part over the events it recorded. CUPTI may drop
    one at the edge of a session, and now and then every record of one, so a
    session that saw none of a kernel's launches (or more than were made) is
    profiled again, up to ``PROFILER_SESSIONS`` sessions; raises
    ``ProfilerMiss`` if none of them saw every kernel."""
    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILER_SESSIONS + 1):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        out, miss = {}, None
        for kernel, per_call in launches.items():
            us, count = 0.0, 0
            for ev in events:
                if kernel in ev.key:
                    us += getattr(ev, "self_device_time_total",
                                  getattr(ev, "self_cuda_time_total", 0.0))
                    count += ev.count
            if not 0 < count <= reps * per_call:
                miss = (f"the profiler saw {count} {kernel} kernels of "
                        f"{reps * per_call} launched")
                break
            out[kernel] = us / 1e3 / count
        if miss is None:
            return out
        log(f"profiler session {session} of {PROFILER_SESSIONS}: {miss}")
    raise ProfilerMiss(f"{miss}, in each of {PROFILER_SESSIONS} sessions")


def kernel_device_ms(torch, fn, kernel: str, launches: int,
                     reps: int = 10) -> float:
    """Device time per launch of the kernels whose name holds ``kernel``
    (``device_ms_by_kernel`` for one name)."""
    return device_ms_by_kernel(torch, fn, {kernel: launches}, reps)[kernel]


def call_device_ms(torch, fn, launches: dict, reps: int = 10) -> dict:
    """Device time of one call of ``fn`` that launches several kernels
    ({name part: launches per call}): ``device_ms`` summed over them, and
    each kernel's time per launch under ``device_ms_per_launch``."""
    per = device_ms_by_kernel(torch, fn, launches, reps)
    return {"device_ms": sum(per[k] * c for k, c in launches.items()),
            "device_ms_per_launch": per}


def enqueue_ms(torch, fn, reps: int = 50) -> float:
    """Host milliseconds per call of ``fn`` with no synchronisation between
    calls: the wrapper's checks, allocation and launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / reps * 1e3


def random_costs(rng, batch: int, n: int, big: float):
    """Symmetric hop-cost stacks with about 4 edges per vertex (BIG = no
    edge, zero diagonal), so some vertices are cut off."""
    adj = rng.random((batch, n, n)) < 2.0 / n
    d = np.where(adj | adj.transpose(0, 2, 1), 1.0, big).astype(np.float32)
    d[:, np.arange(n), np.arange(n)] = 0.0
    return d


def minplus_paths(torch, dev, zero_counts, read_counts, apsp_first):
    """Phases 7-11. Returns the kernel records of apsp_fused, apsp_square
    and minplus (launch counts are filled in by the caller), and the
    load-propagation operands (next_hop, load0, max_hops) of one
    ``AdjacencySpace(32, 8)`` population, padded to its bucket.
    ``apsp_first(d, n_iters)`` runs the fused APSP's first design
    (``tools/apsp_steps.py``)."""
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

    def misaligned(x):
        """A contiguous copy of x whose data starts 4 bytes off 16."""
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out

    plans = []
    for B, M, K, N in MINPLUS_EDGES:
        a = rng.uniform(0, 50, (B, M, K)).astype(np.float32)
        b = rng.uniform(0, 50, (B, K, N)).astype(np.float32)
        a[rng.random(a.shape) < 0.2] = BIG
        b[rng.random(b.shape) < 0.2] = np.inf
        a_t, b_t = gpu(a), gpu(b)
        want = mp.minplus_plain(a_t, b_t)
        got = mp.minplus_cuda(a_t, b_t)
        if not (torch.equal(got, want) and torch.equal(
                mp.minplus_cuda(a_t, b_t), got)):
            fail(f"phase 7: min-plus kernel differs from plain (or from its "
                 f"own second run) at the edge B={B} M={M} K={K} N={N}")
        if not torch.equal(mp.minplus_cuda(misaligned(a_t), misaligned(b_t)),
                           want):
            fail(f"phase 7: min-plus kernel on operands 4 bytes off "
                 f"alignment differs from plain at B={B} M={M} K={K} N={N}")
        one = mp.minplus_cuda(a_t[B - 1:].contiguous(),
                              b_t[B - 1:].contiguous())
        if not torch.equal(one[0], got[B - 1]):
            fail(f"phase 7: min-plus design alone differs from it in the "
                 f"batch at B={B} M={M} K={K} N={N}")
        p = mp.minplus_plan(B, M, K, N)
        plans.append((B, M, K, N, p["tile"], p["split"], p["ctas"]))
    log(f"phase 7: min-plus kernel bit-equal to plain at the split and tile "
        f"edges (B, M, K, N, tile, split, CTAs) {plans}, on misaligned "
        f"operands too; two runs equal; the last design alone == in the "
        f"batch")
    for n in FUSED_NS:
        d = gpu(random_costs(rng, 8, n, BIG))
        it = apsp_iters(n)
        got = ap.apsp_fused_cuda(d, it)
        if not torch.equal(got, ap.apsp_plain(d, it)):
            fail(f"phase 7: fused APSP kernel differs from plain at n={n}")
        if not torch.equal(got, apsp_first(d, it)):
            fail(f"phase 7: fused APSP kernel differs from its first design "
                 f"at n={n}")
        if n in (64, max(FUSED_NS)):
            d64 = gpu(random_costs(rng, 64, n, BIG))
            all64 = ap.apsp_fused_cuda(d64, it)
            for i in (0, 63):
                if not torch.equal(ap.apsp_fused_cuda(
                        d64[i:i + 1].contiguous(), it)[0], all64[i]):
                    fail(f"phase 7: fused APSP design alone differs from it "
                         f"in a batch of 64 at n={n}")
    log("phase 7: fused APSP bit-equal to plain and to its first design at "
        "n in {16..160}; alone == in a batch of 64")
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
    gen_minplus = 0
    # one path per space, so the n = 256 space's load propagation can be
    # told apart (the reference's tiled tier, B2)
    for si, (key, (space, pop_size, rounds)) in enumerate(spaces.items()):
        rng_g = np.random.default_rng(90 + si)
        zero_counts()
        for r in range(rounds):
            pop = space.sample(rng_g, pop_size)
            syncs0 = rdev.host_syncs()
            res = eng.evaluate_genomes(space, pop)
            gen_syncs[key] = {k: v - syncs0[k]
                              for k, v in rdev.host_syncs().items()}
            check_genomes(key, res, eng_cpu.evaluate_genomes(space, pop))
        gen_minplus += read_counts(f"genomes_{key}",
                                   ("load_propagate",))["minplus"]
    if gen_minplus == 0:
        fail("the genome paths launched no minplus kernel")
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
    fused_call = lambda: ap.apsp_fused_cuda(d64, it64)
    fused = {"name": "apsp_fused", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/apsp.cu",
             "replaces": "src/repro/kernels/apsp.py:71",
             "shape": [B3, n64, n64], "n_iters": it64, "library_ms": None,
             **held("apsp_fused", fused_call,
                    lambda: ap.apsp_plain(d64, it64)),
             "device_ms": kernel_device_ms(torch, fused_call, "apsp_fused",
                                           1),
             "enqueue_ms": enqueue_ms(torch, fused_call),
             **bound(8.0 * B3 * n64 * n64, B3 * it64 * n64 ** 3)}
    n256 = LARGE_CHIPLETS
    d256 = apsp(gpu(costs[n256]), 0)
    d256 = torch.where(torch.isinf(d256), BIG, d256).contiguous()
    it256 = apsp_iters(n256)
    B4 = d256.shape[0]
    # B4's record is per squaring (one launch each), so that launches x
    # (ms - bound) is its gap: the call of it256 squarings is divided by it256
    square_call = lambda: ap.apsp_square_cuda(d256, it256)
    sq = held("apsp_square", square_call,
              lambda: ap.apsp_plain_blocked(d256, it256, pick_tile(n256, B4)),
              plain_reps=5)
    square = {"name": "apsp_square", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/minplus.cu",
              "replaces": "src/repro/kernels/apsp.py:167",
              "shape": [B4, n256, n256], "n_iters": it256,
              "per": "squaring: call_ms / n_iters", "library_ms": None,
              "max_abs_err": sq["max_abs_err"], "call_ms": sq["ms"],
              "ms": sq["ms"] / it256, "plain_ms": sq["plain_ms"] / it256,
              "device_ms": kernel_device_ms(torch, square_call,
                                            "minplus_tiled", it256),
              "enqueue_ms": enqueue_ms(torch, square_call) / it256,
              **bound(8.0 * B4 * n256 * n256, B4 * n256 ** 3)}

    def minplus_rec(a, b):
        B, M, K = a.shape
        N = b.shape[-1]
        call = lambda: mp.minplus_cuda(a, b)
        return {"shape": [B, M, K, N],
                **held(f"minplus {[B, M, K, N]}", call,
                       lambda: mp.minplus_plain(a, b)),
                "device_ms": kernel_device_ms(torch, call, "minplus_tiled",
                                              1),
                "enqueue_ms": enqueue_ms(torch, call),
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
        # the three stages of _adjacency_structure, each timed on its own
        bitsb, bits_pad, adj_d, deg, radix, pitch = gn._decode(
            bits, t, k_phys=pipe.k_phys)
        picks = gn._phy_scan(bits_pad, deg, radix, pitch, t, n=pipe.n,
                             k_phys=pipe.k_phys)
        decode_ms = time_cuda(torch, lambda: gn._decode(
            bits, t, k_phys=pipe.k_phys), reps=10)
        phy_ms = time_cuda(torch, lambda: gn._phy_scan(
            bits_pad, deg, radix, pitch, t, n=pipe.n, k_phys=pipe.k_phys),
            reps=10)
        geometry_ms = time_cuda(torch, lambda: gn._link_geometry(
            bitsb, adj_d, deg, radix, pitch, *picks, t, euclid=pipe._euclid),
            reps=10)
        host_t0 = time.perf_counter()
        pipe._report_arrays(pop, space.degrees(pop), np.zeros(len(pop)))
        reports_ms = (time.perf_counter() - host_t0) * 1e3
        wall_s, busy_s, top = profile_device(
            torch, lambda: eng.evaluate_genomes(space, pop), n_top=4)
        genome_layers[key] = {
            "population": P, "n": pipe.n, "k_phys": pipe.k_phys,
            "decode_ms": decode_ms, "link_geometry_ms": geometry_ms,
            "decode_geometry_ms": decode_ms + geometry_ms,
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
        if key == "adjacency_32":
            t32 = t["traffic"].to(torch.float32)
            genome_lp = (nh, t32.transpose(0, 1)[None].expand(nh.shape),
                         pipe.max_hops)
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
    return [fused, square, minplus], genome_lp


def scan_inputs(torch, rng, B, S, Di, N, dev):
    """Selective-scan operands as the training path makes them: dt a
    softplus output, a = -exp(a_log) with the S4D-real init (1..N), B, C and
    x of unit scale; plus a cotangent dy."""
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    a = -np.tile(np.arange(1, N + 1, dtype=np.float32), (Di, 1))
    a *= rng.uniform(0.5, 1.5, (Di, N)).astype(np.float32)
    return (f(rng.normal(0, 1, (B, S, Di))),
            f(np.log1p(np.exp(rng.normal(-4.6, 1.0, (B, S, Di))))),
            f(rng.normal(0, 1, (B, S, N))), f(rng.normal(0, 1, (B, S, N))),
            f(a), f(np.zeros((B, Di, N))), f(rng.normal(0, 1, (B, S, Di))))


def scan_bounds(B: int, S: int, Di: int, N: int, chunk: int,
                clock_hz: float) -> tuple[dict, dict]:
    """The least times of the scan forward (B7) and backward (B8) at one
    shape: the larger of their bytes over the memory rate and their exps
    (the SFU's rate) or flops over the float32 peak."""
    elems = B * S * Di * N
    f32 = 4.0
    exp_per_s = SMS * SFU_PER_SM * clock_hz

    def bound(nbytes, exps, flops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(exps / exp_per_s, flops / FP32_OPS_PER_S) * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "exps": exps, "flops": flops}

    seq_io = B * S * Di * f32
    small = (2 * B * S * N + Di * N + B * Di * N) * f32
    ckpt_bytes = B * (S // chunk) * Di * N * f32
    # forward: x, dt in; y out; B, C, a, h0, hT; the checkpoints. One exp
    # per state update; dt*a, dx*B, the update FMA and the y FMA: 6 flops.
    # backward: x, dt, dy in; dx, ddt out; B, C, a, dB, dC, dA, dh0; the
    # checkpoints. The states must be recomputed once (one exp each, reused
    # by the reverse walk); about 18 flops per state in the recomputation
    # and the adjoint step
    return (bound(3 * seq_io + small + B * Di * N * f32 + ckpt_bytes,
                  elems, 6 * elems),
            bound(5 * seq_io + 2 * small + B * Di * N * f32 + ckpt_bytes,
                  elems, 18 * elems))


def scan_launches(cfg, steps: int) -> dict:
    """The B7 and B8 launches of ``steps`` training steps of ``cfg``: each
    Mamba layer's scan runs once forward and once backward a step, and its
    forward once more under remat, "dots" as "full" (the policy sees the
    dispatched ops only, and B7 sits behind an autograd function that calls
    it through ctypes, so it is recomputed)."""
    layers = cfg.n_layers if cfg.uses_ssm else 0
    passes = 1 if cfg.remat == "none" else 2
    return {"selective_scan_fwd": passes * layers * steps,
            "selective_scan_bwd": layers * steps}


def scan_and_training_paths(torch, dev, zero_counts, read_counts,
                            clock_hz, one_thread_fwd) -> tuple[list[dict],
                                                              dict]:
    """Phases 12-13. ``one_thread_fwd`` runs the scan forward's first design
    (``tools/scan_fwd_steps.py``). Returns the records of selective_scan_fwd
    and selective_scan_bwd (launches filled in by the caller) and the
    training report."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.train import build_state, to_device, train
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import adamw_update, global_norm

    def close(got, want, tol):
        return all(torch.allclose(g, w, **tol) for g, w in zip(got, want))

    def max_err(got, want):
        return max((g - w).abs().max().item() for g, w in zip(got, want))

    # -- 12. selective scan kernels vs plain ---------------------------------
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS,
                                         ssm_kernel=True)
    Di, N, chunk = cfg.d_inner, cfg.ssm_state, cfg.ssm_chunk
    path_shape = (TRAIN_BATCH, TRAIN_SEQ, Di, N, chunk)
    rng = np.random.default_rng(12)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for shape in SCAN_SHAPES + (path_shape,):
        B, S, di, n, ch = shape
        xc, dt, bm, cm, a, h0, dy = scan_inputs(torch, rng, B, S, di, n, dev)
        fk = ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0, chunk=ch)
        fp = ss.selective_scan_fwd_plain(xc, dt, bm, cm, a, h0, chunk=ch)
        torch.cuda.synchronize()
        if not close(fk, fp, SCAN_FWD_TOL):
            fail(f"phase 12: scan forward kernel differs from plain at "
                 f"{shape}: max abs err {max_err(fk, fp)}")
        f0 = one_thread_fwd(xc, dt, bm, cm, a, h0, chunk=ch)
        if not (torch.equal(fk[1], f0[1]) and torch.equal(fk[2], f0[2])):
            fail(f"phase 12: scan forward checkpoints or final states differ "
                 f"from the one-thread design's at {shape}")
        ckpt = fk[1]
        bk = ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt, dy, chunk=ch)
        bp = ss.selective_scan_bwd_plain(xc, dt, bm, cm, a, ckpt, dy,
                                         chunk=ch)
        torch.cuda.synchronize()
        if not close(bk, bp, SCAN_BWD_TOL):
            fail(f"phase 12: scan backward kernel differs from plain at "
                 f"{shape}: max abs err {max_err(bk, bp)}")
        errs["fwd"] = max(errs["fwd"], max_err(fk, fp))
        errs["bwd"] = max(errs["bwd"], max_err(bk, bp))
        fk2 = ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0, chunk=ch)
        bk2 = ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt, dy,
                                         chunk=ch)
        if not all(torch.equal(p, q) for p, q in zip(fk + bk, fk2 + bk2)):
            fail(f"phase 12: two runs of the scan kernels differ at {shape}")
        b = B - 1
        one = [t[b:b + 1].contiguous() for t in (xc, dt, bm, cm)]
        f1 = ss.selective_scan_fwd_cuda(*one, a, h0[b:b + 1].contiguous(),
                                        chunk=ch)
        g1 = ss.selective_scan_bwd_cuda(*one, a, f1[1],
                                        dy[b:b + 1].contiguous(), chunk=ch)
        same = all(torch.equal(f1[i][0], fk[i][b]) for i in range(3)) and \
            all(torch.equal(g1[i][0], bk[i][b]) for i in (0, 1, 2, 3, 5))
        if not same:
            fail(f"phase 12: sequence {b} alone differs from it in the batch "
                 f"at {shape}")
    log(f"phase 12: scan kernels within {SCAN_FWD_TOL} (forward) and "
        f"{SCAN_BWD_TOL} (backward) of plain at {list(SCAN_SHAPES)} and the "
        f"path's {path_shape}, max abs err {errs}; forward checkpoints and "
        f"final states bit-equal to the one-thread design's; two runs "
        f"bit-equal; a sequence alone bit-equal to it in the batch")

    # timing at the path's shape; bounds from its bytes and its exps/flops
    fwd_bound, bwd_bound = scan_bounds(*path_shape, clock_hz)
    fwd_call = lambda: ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0,
                                                  chunk=chunk)
    fwd_ms = time_cuda(torch, fwd_call, reps=10)
    fwd_device_ms = kernel_device_ms(torch, fwd_call, "ssm_fwd", 1)
    bwd_call = lambda: ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt,
                                                  dy, chunk=chunk)
    bwd_ms = time_cuda(torch, bwd_call, reps=5)
    fwd_rec = {
        "name": "selective_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:38",
        "shape": list(path_shape), "max_abs_err": errs["fwd"], "ms": fwd_ms,
        "device_ms": fwd_device_ms,
        "enqueue_ms": enqueue_ms(torch, fwd_call, reps=10),
        "plain_ms": time_cuda(torch, lambda: ss.selective_scan_fwd_plain(
            xc, dt, bm, cm, a, h0, chunk=chunk), reps=2, warmup=1),
        "library_ms": None, **fwd_bound}
    bwd_rec = {
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:116",
        "shape": list(path_shape), "max_abs_err": errs["bwd"], "ms": bwd_ms,
        **call_device_ms(torch, bwd_call, SCAN_BWD_KERNELS, reps=5),
        "enqueue_ms": enqueue_ms(torch, bwd_call, reps=10),
        "plain_ms": time_cuda(torch, lambda: ss.selective_scan_bwd_plain(
            xc, dt, bm, cm, a, ckpt, dy, chunk=chunk), reps=1, warmup=1),
        "library_ms": None, **bwd_bound}
    del xc, dt, bm, cm, a, h0, dy, ckpt, fk, fp, f0, bk, bp, fk2, bk2
    log(f"phase 12: at {path_shape}: forward {fwd_ms:.4f} ms (bound "
        f"{fwd_rec['bound_ms']:.4f}, {fwd_rec['bound_by']}), backward "
        f"{bwd_ms:.4f} ms (bound {bwd_rec['bound_ms']:.4f}, "
        f"{bwd_rec['bound_by']})")

    # -- 13. training: falcon-mamba-7b at full width, 2 layers ---------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    _, losses = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                      seq_len=TRAIN_SEQ, lr=TRAIN_LR, log_every=1, seed=0,
                      device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated()
    counts = read_counts("training", ("selective_scan_fwd",
                                      "selective_scan_bwd"))
    counts = {k: counts[k] for k in ("selective_scan_fwd",
                                     "selective_scan_bwd")}
    expected = scan_launches(cfg, TRAIN_STEPS)
    if counts != expected:
        fail(f"phase 13: scan launches {counts}, remat predicts {expected}")
    if not (len(losses) == TRAIN_STEPS and np.all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        fail(f"phase 13: training losses {losses} are not finite and "
             f"falling")
    # the same run on the chunked-scan route (the model-level plain version)
    _, losses_chunked = train(cfg.replace(ssm_kernel=False),
                              steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, lr=TRAIN_LR,
                              log_every=TRAIN_STEPS, seed=0, device=dev)
    if not np.allclose(losses, losses_chunked, rtol=TRAIN_ROUTE_RTOL,
                       atol=0.0):
        fail(f"phase 13: kernel-route losses {losses} differ from the "
             f"chunked-scan route's {losses_chunked}")
    log(f"phase 13: {TRAIN_ARCH} (d_model {cfg.d_model}, d_inner {Di}, "
        f"N {N}, vocab {cfg.vocab_size}, {TRAIN_LAYERS} layers) trained "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{train_s:.3f} s: losses {losses} (chunked-scan route "
        f"{losses_chunked}, within rtol {TRAIN_ROUTE_RTOL}); scan launches "
        f"{counts}, as remat predicts; peak "
        f"{peak_train / 2**30:.3f} GiB")

    # one f32 step, kernel route vs chunked-scan route, same parameters
    batch = to_device(SyntheticTokens(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                      seed=1).batch_at(0), dev)
    f32_out = {}
    for kern in (True, False):
        model = Model(cfg.replace(dtype="float32", ssm_kernel=kern), seed=0,
                      device=dev)
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        f32_out[kern] = (loss.item(), global_norm(dict(enumerate(grads))
                                                  ).item())
        del model, loss, grads
        torch.cuda.empty_cache()
    (lk, gk), (lc, gc) = f32_out[True], f32_out[False]
    if not (abs(lk / lc - 1) <= 1e-4 and abs(gk / gc - 1) <= 1e-3):
        fail(f"phase 13: f32 kernel route loss {lk} / grad norm {gk} vs "
             f"chunked scan {lc} / {gc}")
    log(f"phase 13: f32 step, kernel route loss {lk} grad norm {gk}; "
        f"chunked-scan route {lc} / {gc} (loss within rtol 1e-4, grad norm "
        f"within 1e-3)")

    # step time, device idle share and the layers of one step (bf16)
    model = Model(cfg, seed=0, device=dev)
    ocfg = OptConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                     decay_steps=TRAIN_STEPS)
    state = build_state(model, "adamw")
    step = make_train_step(model, ocfg)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    step_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        step_s.append(time.perf_counter() - t0)
    wall_s, busy_s, top = profile_device(torch, lambda: step(state, batch),
                                         n_top=6)
    params = model.params()
    tokens = batch["tokens"]
    bf = cfg.compute_dtype
    M = TRAIN_BATCH * TRAIN_SEQ

    def fwd_bwd(fn, *leaves):
        def run():
            out = fn()
            torch.autograd.grad(out, leaves, torch.ones_like(out))
        return run

    table = params["embed"]["table"]
    emb = time_cuda(torch, fwd_bwd(lambda: L.embed(params["embed"], tokens,
                                                   bf), table), reps=5)
    mats = 0.0
    r2n = cfg.ssm_dt_rank + 2 * N
    for k_, n_ in ((cfg.d_model, 2 * Di), (Di, r2n), (cfg.ssm_dt_rank, Di),
                   (Di, cfg.d_model)):
        xa = torch.randn((M, k_), device=dev, dtype=bf, requires_grad=True)
        w = torch.randn((k_, n_), device=dev, requires_grad=True)
        fwd = time_cuda(torch, lambda: xa @ w.to(bf), reps=10)
        both = time_cuda(torch, fwd_bwd(lambda: xa @ w.to(bf), xa, w),
                         reps=10)
        mats += fwd + both              # remat: the forward runs twice
    x_fin = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), device=dev,
                        dtype=bf, requires_grad=True)
    ce_ms = time_cuda(torch, fwd_bwd(lambda: model.ce_loss(
        x_fin, batch["labels"], params)[0], x_fin, params["unembed"]["w"]),
        reps=3)
    grads = {k: torch.zeros_like(p) for k, p in state["params"].items()}
    plain = {k: p.detach() for k, p in state["params"].items()}
    opt_ms = time_cuda(torch, lambda: adamw_update(
        ocfg, plain, grads, state["opt"], state["step"]), reps=3)
    del grads, x_fin
    step_ms = statistics.median(step_s) * 1e3
    layers = {
        "embed_ms": emb, "mixer_matmuls_ms": TRAIN_LAYERS * mats,
        "scan_kernels_ms": TRAIN_LAYERS * (2 * fwd_ms + bwd_ms),
        "ce_chunks_ms": ce_ms, "optimizer_ms": opt_ms,
    }
    layers["rest_ms"] = step_ms - sum(layers.values())
    report = {
        "arch": TRAIN_ARCH, "layers_kept": TRAIN_LAYERS,
        "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "losses_chunked_route": losses_chunked,
        "train_wall_s": train_s,
        "peak_alloc_bytes_train": peak_train,
        "n_params": sum(p.numel() for p in model.parameters()),
        "step_ms": step_ms, "tokens_per_s": M / (step_ms / 1e3),
        "profiled_wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3,
        "device_idle_share": 1.0 - busy_s / wall_s,
        "top_device_us": dict(top), "layers_per_step": layers,
        "f32_kernel_vs_chunked": {"kernel": f32_out[True],
                                  "chunked": f32_out[False]},
    }
    del model, state, step, params, plain
    torch.cuda.empty_cache()
    log(f"phase 13: step {step_ms:.1f} ms ({M / (step_ms / 1e3):.0f} "
        f"tokens/s), device idle {report['device_idle_share']:.4f}; layers "
        f"{layers}")
    return [fwd_rec, bwd_rec], report


def flow_paths(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 14. Returns the flow_accumulate record (launches filled in by
    the caller)."""
    from repro_torch.core.latency import routed_diameter_batch
    from repro_torch.core.proxies import prepare_arrays
    from repro_torch.core.throughput import throughput_proxy
    from repro_torch.kernels import flow_accum as fa
    from repro_torch.topologies import TOPOLOGIES, make_design
    from repro_torch.traffic import make_traffic

    rng = np.random.default_rng(14)
    for B, n, P, kind in FLOW_CASES:
        cur, nxt = rng.integers(0, n, (2, B, P))
        if kind == "one_row":                   # one row holds every pair
            cur[:] = n // 2
        elif kind == "two_rows":                # duplicate cells
            cur, nxt = cur % 2, nxt % 2
        elif kind == "out_of_range":            # the kernel drops these
            cur, nxt = rng.integers(-3, n + 3, (2, B, P))
        live = (cur >= 0) & (cur < n) & (nxt >= 0) & (nxt < n)
        flow = rng.uniform(0, 5, (B, n, n)).astype(np.float32)
        amt = rng.uniform(0, 2, (B, P)).astype(np.float32)
        ops_ = [torch.from_numpy(x) for x in (
            flow, cur.astype(np.int32), nxt.astype(np.int32), amt)]
        kept = [torch.from_numpy(np.where(live, x, 0).astype(x.dtype))
                for x in (cur.astype(np.int32), nxt.astype(np.int32), amt)]
        on_card = [t.to(dev) for t in ops_]
        got = fa.flow_accum_cuda(*on_card)
        if not torch.equal(got.cpu(), fa.flow_accum_plain(ops_[0], *kept)):
            fail(f"phase 14: flow kernel differs from the CPU scatter "
                 f"(ascending p) at B={B} n={n} P={P} ({kind})")
        if kind != "out_of_range" and not torch.allclose(
                got, fa.flow_accum_plain(*on_card), rtol=1e-5, atol=1e-5):
            fail(f"phase 14: flow kernel differs from index_add_ on the card "
                 f"at B={B} n={n} P={P} ({kind})")
        one = fa.flow_accum_cuda(*(t[B - 1:B].contiguous() for t in on_card))
        if not torch.equal(one[0], got[B - 1]):
            fail(f"phase 14: design alone differs from it in a batch at n={n}")
    log("phase 14: flow kernel bit-equal to the CPU scatter, within rtol "
        "1e-5 of index_add_ on the card (atomics add in any order), alone == "
        "in a batch")

    groups: dict[tuple, list] = {}       # (n, chiplets) -> designs
    for topo, count in [(t, FLOW_CHIPLETS) for t in TOPOLOGIES
                        if t != "custom"] + [("mesh", FLOW_LARGE)]:
        arrays, _ = prepare_arrays(make_design(topo, count))
        groups.setdefault((arrays.next_hop.shape[0], count), []).append(
            (topo, arrays))
    results = {}
    zero_counts()
    for n, members in groups.items():
        nh = torch.from_numpy(np.stack([a.next_hop for _, a in members])
                              ).to(dev)
        bw = torch.from_numpy(np.stack([a.adj_bw for _, a in members])
                              ).to(dev)
        t = torch.from_numpy(make_traffic("random_uniform", n[1]).astype(
            np.float32)).to(dev)
        mh = int(routed_diameter_batch(nh).max())
        results[n] = (nh, bw, t, mh,
                      throughput_proxy(nh, bw, t, mh, True))
    read_counts("pair_walk", ("flow_accumulate",))
    for n, (nh, bw, t, mh, walk) in results.items():
        load = throughput_proxy(nh, bw, t.expand(nh.shape[0], *t.shape), mh)
        if not (torch.all(torch.isfinite(walk)) and torch.all(walk > 0)
                and torch.allclose(walk, load, rtol=RTOL, atol=0.0)):
            fail(f"phase 14: pair-walk throughput differs from the "
                 f"load-propagation route at n={n}: {walk} vs {load}")
    names = {n: [t for t, _ in m] for n, m in groups.items()}
    log(f"phase 14: pair-walk throughput within rtol {RTOL} of load "
        f"propagation for {names}")
    # the walks once more under the profiler: the flow kernels' device time
    # over every hop, and the walks' wall time
    wall_s, busy_s, top = profile_device(torch, lambda: [
        throughput_proxy(nh, bw, t, mh, True)
        for nh, bw, t, mh, _ in results.values()], n_top=1000)
    walk = {"hops": sum(r[3] for r in results.values()),
            "flow_kernels_ms": sum(us for k, us in top if "fa_" in k) / 1e3,
            "profiled_wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3}
    log(f"phase 14: the walks' {walk['hops']} hops spend "
        f"{walk['flow_kernels_ms']:.4f} ms of device time in the flow "
        f"kernels ({walk['profiled_wall_ms']:.1f} ms wall)")

    # the record: one hop of the 256-chiplet mesh walk (its first hop: every
    # pair at its source)
    nh, bw, t, mh, _ = results[(FLOW_LARGE, FLOW_LARGE)]
    n = nh.shape[-1]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    cur = ids.repeat_interleave(n)[None].contiguous()
    dest = ids.repeat(n)[None]
    nxt = torch.gather(nh.reshape(1, n * n), 1, (cur * n + dest).long())
    amount = torch.where(cur != dest, t.reshape(1, -1), 0.0).contiguous()
    flow = torch.zeros((1, n, n), device=dev)
    nxt = nxt.contiguous()
    got = fa.flow_accum_cuda(flow, cur, nxt, amount)
    want = fa.flow_accum_plain(flow.cpu(), cur.cpu(), nxt.cpu(),
                               amount.cpu())
    if not torch.equal(got.cpu(), want):
        fail("phase 14: the record's hop differs from the CPU scatter")
    # the record's hop beside two other hops of the walk, in one batch
    batch = [torch.cat([x, torch.roll(x, k, -1), torch.roll(x, 2 * k, -1)])
             for x, k in ((flow, 0), (cur, 1), (nxt, 7), (amount, 3))]
    if not torch.equal(fa.flow_accum_cuda(*batch)[0], got[0]):
        fail("phase 14: the record's hop alone differs from it in a batch")
    flat = (cur.long() * n + nxt.long()).reshape(-1)
    call = lambda: fa.flow_accum_cuda(flow, cur, nxt, amount)
    live = int((amount != 0).sum())
    nbytes = 2 * n * n * 4 + 3 * n * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = live / FP32_OPS_PER_S * 1e3
    return {
        "name": "flow_accumulate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flow_accum.cu",
        "replaces": "src/repro/kernels/flow_accum.py:28",
        "shape": [1, n, n * n],
        "max_abs_err": (got.cpu() - want).abs().max().item(),
        "ms": time_cuda(torch, call),
        **call_device_ms(torch, call, FLOW_KERNELS),
        "enqueue_ms": enqueue_ms(torch, call),
        "plain_ms": time_cuda(torch, lambda: fa.flow_accum_plain(
            flow, cur, nxt, amount)),
        "library_ms": time_cuda(torch, lambda: flow.reshape(-1).clone(
        ).index_put_((flat,), amount.reshape(-1), accumulate=True)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "adds": live, "walk_hops": mh, "pair_walk": walk}



def fault_grid_path(torch, dev, zero_counts, read_counts,
                    lp_first_equal) -> dict:
    """Phase 15: the [P, F] population x fault-scenario grid on the card
    (``DseEngine.evaluate_genomes_faults_async``) at the reference's
    fault-overhead shapes, held against the CPU run, the pristine
    evaluation and itself alone; its load propagation and routing tables
    held against their plain versions on the degraded (partly
    disconnected) graphs. Returns the phase's record."""
    from repro_torch.dse import DseEngine
    from repro_torch.dse import genomes as gn
    from repro_torch.faults.model import iid_link_faults, single_chiplet_faults
    from repro_torch.kernels import load_prop as lp
    from repro_torch.opt import AdjacencySpace
    from repro_torch.routing import device as rdev

    n, degree = FAULT_SPACE
    space = AdjacencySpace(n_chiplets=n, max_degree=degree)
    eng, eng_cpu = DseEngine(device=dev), DseEngine(device="cpu")
    pop = space.sample(np.random.default_rng(11), FAULT_POP)
    P = gn.bucket_population(len(pop))
    scen = {F: iid_link_faults(space, p=0.05, n_scenarios=F - 1, seed=0)
            for F in FAULT_FS}
    # dead chiplets: every scenario strands traffic, so the kernels see
    # disconnected graphs, self-looped rows and rows with no load
    scen["chiplets"] = single_chiplet_faults(space)

    def grid(engine, sc, genomes=pop):
        return engine.evaluate_genomes_faults_async(
            space, genomes, sc.link_fail, sc.node_fail).result()

    zero_counts()
    grids = {key: grid(eng, sc) for key, sc in scen.items()}
    read_counts("faults_grid", ("load_propagate", "minplus"))
    pristine = eng.evaluate_genomes(space, pop)
    fields = ("latency", "throughput", "reachable_fraction")
    for key, sc in scen.items():
        got, want = grids[key], grid(eng_cpu, sc)
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if g.shape != (len(pop), sc.n_scenarios) or not np.all(
                    np.isfinite(g)):
                fail(f"phase 15: F={key}: {f} has shape {g.shape} or "
                     f"non-finite values")
            if not np.allclose(g, w, rtol=RTOL, atol=0.0):
                fail(f"phase 15: F={key}: {f} differs from the CPU grid by "
                     f"{np.max(np.abs(g - w))}")
        if not (np.array_equal(got.latency[:, 0], pristine.latency)
                and np.array_equal(got.throughput[:, 0],
                                   pristine.throughput)
                and np.all(got.reachable_fraction[:, 0] == 1.0)):
            fail(f"phase 15: F={key}: the pristine column differs from "
                 f"evaluate_genomes on the card")
        for i in (0, len(pop) - 1):
            one = grid(eng, sc, pop[i:i + 1])
            if not all(np.array_equal(getattr(one, f)[0],
                                      getattr(got, f)[i]) for f in fields):
                fail(f"phase 15: F={key}: genome {i} alone differs from it "
                     f"in the grid")
    stranded = float((grids["chiplets"].reachable_fraction < 1.0).mean())
    if stranded == 0.0:
        fail("phase 15: the dead-chiplet grid strands no traffic")

    # the kernels on the dead-chiplet grid's own operands, captured from
    # its calls: routing tables equal the CPU's (B5 under the BIG-masked
    # edges of dead links), load propagation within rtol of plain and
    # bit-equal to its first design (B1 with its per-row stop)
    seen = {}
    hops_fn, lp_fn = gn.hops_next_hop_batch, gn.load_propagate

    def hops_spy(adj):
        seen["adj"] = adj
        return hops_fn(adj)

    def lp_spy(nh, load0, **kw):
        seen["lp"] = (nh, load0, kw["max_hops"])
        return lp_fn(nh, load0, **kw)

    gn.hops_next_hop_batch, gn.load_propagate = hops_spy, lp_spy
    try:
        grid(eng, scen["chiplets"])
    finally:
        gn.hops_next_hop_batch, gn.load_propagate = hops_fn, lp_fn
    if not torch.equal(rdev.hops_next_hop_batch(seen["adj"]).cpu(),
                       rdev.hops_next_hop_batch(seen["adj"].cpu())):
        fail("phase 15: degraded routing tables differ from the CPU's")
    nh, load0, hops = seen["lp"]
    nh = nh.to(torch.int32).contiguous()
    load0 = load0.contiguous()
    w_k, f_k = lp.load_prop_cuda(nh, load0, hops)
    w_p, f_p = lp.load_prop_plain(nh, load0, hops, adaptive=False)
    if not (torch.allclose(w_k, w_p, rtol=RTOL, atol=ATOL)
            and torch.allclose(f_k, f_p, rtol=RTOL, atol=ATOL)):
        fail("phase 15: load propagation differs from plain on the "
             "degraded tables")
    if not lp_first_equal(nh, load0, hops, (w_k, f_k)):
        fail("phase 15: load propagation differs from its first design on "
             "the degraded tables")
    log(f"phase 15: fault grid within rtol {RTOL} of the CPU for F in "
        f"{list(scen)}, pristine column bit-equal to evaluate_genomes, a "
        f"genome alone == in the grid; on the dead-chiplet grid "
        f"({stranded:.3f} of the cells strand traffic) routing tables == "
        f"CPU and load propagation == plain / first design")

    # rates per F: one call = one population under F scenarios
    reps = 5

    def rate(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    base_s = rate(lambda: eng.evaluate_genomes(space, pop))
    per_f = {"pristine": {"s_per_call": base_s,
                          "design_evals_per_s": len(pop) / base_s}}
    for F in FAULT_FS:
        med = rate(lambda sc=scen[F]: grid(eng, sc))
        per_f[f"F={F}"] = {
            "launch_shape": [P * F, n, n], "s_per_call": med,
            "design_evals_per_s": len(pop) / med,
            "scenario_evals_per_s": len(pop) * F / med,
            "overhead_vs_pristine": med / base_s}
    wall_s, busy_s, top = profile_device(
        torch, lambda: grid(eng, scen[FAULT_FS[-1]]), n_top=6)
    rec = {"space": [n, degree], "population": len(pop), "bucket": P,
           "per_f": per_f, "stranded_cell_share_chiplets": stranded,
           "profiled_F": FAULT_FS[-1], "profiled_wall_ms": wall_s * 1e3,
           "device_busy_ms": busy_s * 1e3,
           "device_idle_share": 1.0 - busy_s / wall_s,
           "top_device_us": dict(top)}
    log(f"phase 15: design-evals/s "
        f"{ {k: round(v['design_evals_per_s'], 1) for k, v in per_f.items()} }"
        f"; scenario-evals/s "
        f"{ {k: round(v['scenario_evals_per_s'], 1) for k, v in per_f.items() if k != 'pristine'} }"
        f"; launch shapes {[per_f[f'F={F}']['launch_shape'] for F in FAULT_FS]}"
        f"; device idle {rec['device_idle_share']:.4f} of one F="
        f"{FAULT_FS[-1]} call")
    return rec


def optimizer_path(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 16: the optimizer on the card through ``python -m
    repro_torch.opt``'s ``main`` at its CLI defaults, sync and async, fronts
    bit-equal and a resume from generation 10 equal to the uninterrupted
    run; then the reference's robust-versus-pristine experiment. Returns
    the phase's record."""
    import shutil

    from repro_torch.dse import DseEngine
    from repro_torch.faults.model import single_link_faults
    from repro_torch.faults.objectives import REACH_EPS, FaultSetup
    from repro_torch.kernels.ref import BIG
    from repro_torch.obs.trace import TRACER, disable_tracing
    from repro_torch.opt import (AdjacencySpace, Budgets, EvolutionarySearch,
                                 OptRunner, PopulationEvaluator)
    from repro_torch.opt.runner import main as opt_main

    work = os.path.join(ROOT, "build", "chip_smoke_opt")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gens, pop = OPT_CLI["generations"], OPT_CLI["pop_size"]
    argv = ["--device", torch.device(dev).type, "--quiet"] + [
        f"--{k.replace('_', '-')}={v}" for k, v in OPT_CLI.items()]

    def run(path, extra, name=None):
        if name is not None:
            zero_counts()
        t0 = time.perf_counter()
        if opt_main(argv + ["--out", os.path.join(work, path)] + extra):
            fail(f"phase 16: python -m repro_torch.opt {extra} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name is not None:
            read_counts(name, ("load_propagate", "minplus"))
        with open(os.path.join(work, path)) as f:
            return json.load(f), wall

    sync_front, sync_s = run("sync.json", [], "opt_sync")
    async_front, async_s = run("async.json", ["--async"], "opt_async")
    if not sync_front or async_front != sync_front:
        fail("phase 16: the async front differs from the sync front")
    ckpt = os.path.join(work, "resume.ckpt")
    opt_main(argv + ["--generations=10", "--checkpoint", ckpt])
    resumed, _ = run("resumed.json", ["--checkpoint", ckpt])
    if resumed != sync_front:
        fail("phase 16: the front resumed from generation 10 differs from "
             "the uninterrupted run")
    # the async run traced (spans and the overlap telemetry) and profiled
    try:
        _, traced_s = run("traced.json", ["--async", "--checkpoint",
                                          os.path.join(work, "t.ckpt"),
                                          "--trace",
                                          os.path.join(work, "trace")])
        with open(os.path.join(work, "trace.report.json")) as f:
            summary = json.load(f)
    finally:
        disable_tracing()
        TRACER.clear()
    wall_s, busy_s, top = profile_device(
        torch, lambda: run("profiled.json", ["--async"]), n_top=8)
    spans = {k: {"count": v["count"], "total_s": v["total_s"]}
             for k, v in summary["spans"].items()
             if k.startswith(("opt.", "genomes."))}
    tele = summary["telemetry"]
    cli = {"args": OPT_CLI, "front_size": len(sync_front),
           "sync_s": sync_s, "async_s": async_s, "traced_async_s": traced_s,
           "sync_generations_per_s": gens / sync_s,
           "async_generations_per_s": gens / async_s,
           "sync_evals_per_s": gens * pop / sync_s,
           "async_evals_per_s": gens * pop / async_s,
           "async_overlap_pct": tele["async_overlap_pct"],
           "async_host_hidden_s": tele["async_host_hidden_s"],
           "async_device_wait_s": tele["async_device_wait_s"],
           "spans": spans, "profiled_async_wall_ms": wall_s * 1e3,
           "device_busy_ms": busy_s * 1e3,
           "device_idle_share": 1.0 - busy_s / wall_s,
           "top_device_us": dict(top)}
    log(f"phase 16a: NSGA-II {OPT_CLI}: sync {cli['sync_generations_per_s']:.3f}"
        f" generations/s ({cli['sync_evals_per_s']:.1f} evals/s), async "
        f"{cli['async_generations_per_s']:.3f} ({cli['async_evals_per_s']:.1f}"
        f"); fronts bit-equal ({len(sync_front)} points), resume from "
        f"generation 10 == uninterrupted; async overlap "
        f"{tele['async_overlap_pct']}% of host work hidden; device idle "
        f"{cli['device_idle_share']:.4f} of the async run")

    # (b) robust versus pristine, benchmarks/opt_convergence.py's experiment
    n, degree, rpop, rgens = (ROBUST[k] for k in ("n", "degree", "pop",
                                                   "generations"))
    space = AdjacencySpace(n_chiplets=n, max_degree=degree)
    battery = single_link_faults(space)
    budgets = Budgets(max_interposer_area=ROBUST["area_budget"])

    def optimized_front(faults):
        evaluator = PopulationEvaluator(space, budgets=budgets,
                                        device_path=True, faults=faults,
                                        device=dev)
        opt = EvolutionarySearch(space, evaluator, seed=0, pop_size=rpop)
        OptRunner(opt).run(rgens)
        return [np.asarray(e.payload, np.int64) for e in opt.archive.front()]

    zero_counts()
    t0 = time.perf_counter()
    pristine_front = optimized_front(None)
    robust_front = optimized_front(FaultSetup(scenarios=battery))
    torch.cuda.synchronize()
    robust_s = time.perf_counter() - t0
    read_counts("opt_robust", ("load_propagate", "minplus"))
    if not pristine_front or not robust_front:
        fail(f"phase 16b: empty front (pristine {len(pristine_front)}, "
             f"robust {len(robust_front)})")
    engine, engine_cpu = DseEngine(device=dev), DseEngine(device="cpu")

    def best_worst_case(front):
        args = (space, np.stack(front), battery.link_fail, battery.node_fail)
        g = engine.evaluate_genomes_faults_async(*args).result()
        g_cpu = engine_cpu.evaluate_genomes_faults_async(*args).result()
        for f in ("latency", "throughput", "reachable_fraction"):
            if not np.allclose(getattr(g, f), getattr(g_cpu, f), rtol=RTOL,
                               atol=0.0):
                fail(f"phase 16b: the battery grid's {f} differs from the "
                     f"CPU's")
        lat = np.asarray(g.latency, np.float64)
        reach = np.asarray(g.reachable_fraction, np.float64)
        worst = np.where(reach < 1.0 - REACH_EPS, float(BIG),
                         lat).max(axis=1)
        best = int(np.argmin(worst))
        return {"front_size": len(front),
                "best_worst_case_latency": float(worst[best]),
                "its_delivered_worst_latency": float(lat[best].max()),
                "its_pristine_latency": float(lat[best, 0]),
                "its_min_reachable_fraction": float(reach[best].min()),
                "front_min_reachable_fraction": float(reach.min())}

    p_rec, r_rec = best_worst_case(pristine_front), best_worst_case(
        robust_front)
    # the robust search's disconnection constraint admits only designs
    # that stay connected under every scenario: fatal if its front strands
    # any traffic. Whether the pristine search's best design strands
    # traffic depends on its trajectory (ROADMAP Queue C: rank flips on
    # tied throughputs), so that is reported, not gated.
    if r_rec["front_min_reachable_fraction"] < 1.0 - REACH_EPS:
        fail(f"phase 16b: a design of the robust front reaches only "
             f"{r_rec['front_min_reachable_fraction']} of its traffic under "
             f"a single-link failure")
    record = None
    bench = os.path.join(ROOT, "BENCH_faults.json")
    if os.path.exists(bench):
        with open(bench) as f:
            record = json.load(f).get("robust_vs_pristine")
    robust = {"args": ROBUST, "battery_scenarios": battery.n_scenarios,
              "wall_s": robust_s, "pristine_optimized": p_rec,
              "robust_optimized": r_rec,
              "jax_package_tpu_era_record_BENCH_faults": record}
    log(f"phase 16b: robust versus pristine at n={n}, degree {degree}: the "
        f"pristine front's best design reaches "
        f"{p_rec['its_min_reachable_fraction']} of its traffic under the "
        f"worst of {battery.n_scenarios} single-link scenarios, the robust "
        f"front's {r_rec['its_min_reachable_fraction']} (the JAX package's "
        f"TPU-era record in BENCH_faults.json, not this card's: "
        f"{None if record is None else record['pristine_optimized']['its_min_reachable_fraction']}"
        f" / {None if record is None else record['robust_optimized']['its_min_reachable_fraction']})")
    shutil.rmtree(work, ignore_errors=True)
    return {"cli_defaults": cli, "robust_vs_pristine": robust}


def _serve_spec(JobSpec, i: int, space: dict, generations: int,
                pop_size: int | None = None, **kw):
    return JobSpec(job_id=f"job-{i:03d}", algo=SERVE_ALGOS[i % 3],
                   generations=generations,
                   pop_size=pop_size or SERVE_POPS[i % len(SERVE_POPS)],
                   seed=i, tenant=f"team-{i % 4}", space=dict(space), **kw)


def _solo_identical(run_spec_solo, front_json_bytes, job, dev) -> bool:
    """A served job against ``run_spec_solo`` on the same device: front
    bytes, eval count and the whole optimizer state (archive, RNG)."""
    opt, rows = run_spec_solo(job.spec, device=dev)
    return (job.status == "done"
            and front_json_bytes(job.result_rows) == front_json_bytes(rows)
            and job.n_evals == opt.evaluator.n_evals
            and job.optimizer.state() == opt.state())


def serve_path(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 17: the search service on the card (``SearchService(device=
    "cuda")``): serve_load's mix of 100 jobs, 8 jobs at the optimizer CLI's
    space, a chaos-armed job, and the daemon under SIGKILL and SIGTERM;
    every served job bit-identical to its solo run on the card. Returns the
    phase's record."""
    import shutil
    import signal

    from repro_torch.dse import DseEngine
    from repro_torch.kernels import load_prop as lp
    from repro_torch.kernels import minplus as mp
    from repro_torch.kernels.ref import BIG
    from repro_torch.obs import metrics
    from repro_torch.obs.log import configure
    from repro_torch.obs.report import span_stats
    from repro_torch.obs.trace import TRACER, disable_tracing, enable_tracing
    from repro_torch.serve import (JobSpec, SearchService, front_json_bytes,
                                   run_spec_solo)
    from repro_torch.serve.job import make_job_space

    def pct(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, max(0, round(q * (len(xs) - 1))))]

    # the service logs every job's end at info; keep the phase's own lines
    configure("warning", force=True)
    # (a) load: 100 jobs, one shared space, co-batched mega-dispatches
    n_jobs, gens = SERVE_LOAD["jobs"], SERVE_LOAD["generations"]
    specs = [_serve_spec(JobSpec, i, SERVE_SPACE, gens)
             for i in range(n_jobs)]
    submitted: dict[str, float] = {}     # job id -> time.monotonic()
    metrics.reset()
    enable_tracing()
    zero_counts()
    try:
        t0 = time.perf_counter()
        with SearchService(device=dev, max_jobs=SERVE_LOAD["max_jobs"],
                           max_queued=n_jobs + 1) as svc:
            for spec in specs:
                submitted[spec.job_id] = time.monotonic()
                svc.submit(spec)
            jobs = svc.wait_all(timeout_s=600.0)
        stats = svc.stats()         # after the drain: every round counted
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        spans = span_stats(TRACER.to_dicts())
    finally:
        disable_tracing()
        TRACER.clear()
    counts = read_counts("serve_load", ("load_propagate", "minplus"))
    done = [j for j in jobs if j.status == "done"]
    if len(done) != n_jobs:
        fail(f"phase 17a: {n_jobs - len(done)} load jobs did not finish")
    step = max(1, len(done) // SERVE_LOAD["sampled"])
    sampled = done[::step][:SERVE_LOAD["sampled"]]
    for job in sampled:
        if not _solo_identical(run_spec_solo, front_json_bytes, job, dev):
            fail(f"phase 17a: job {job.job_id} ({job.spec.algo}) differs "
                 f"from its solo run on the card")
    dispatches = metrics.histogram("serve.batch_occupancy").count
    # submit -> done: a job ends wall_s after it started (both monotonic)
    lat = [j.started_at + j.wall_s - submitted[j.job_id] for j in jobs]
    load = {"jobs": n_jobs, "generations": gens,
            "max_jobs": SERVE_LOAD["max_jobs"], "wall_s": load_s,
            "evals_total": stats["evals_total"],
            "evals_per_s": stats["evals_total"] / load_s,
            "latency_p50_s": pct(lat, 0.50), "latency_p99_s": pct(lat, 0.99),
            "rounds": stats["rounds"], "mega_dispatches": dispatches,
            "mean_batch_occupancy": stats["evals_total"] / max(1, dispatches),
            "batch_faults": metrics.counter("serve.batch_fault").value,
            "launches": {k: counts[k] for k in ("load_propagate", "minplus")},
            "sampled_solo_identical": [j.job_id for j in sampled],
            "spans": {k: {f: v[f] for f in ("count", "total_s", "mean_s",
                                             "p50_s", "p99_s")}
                      for k, v in spans.items()
                      if k.startswith(("serve.", "genomes.", "opt."))}}
    log(f"phase 17a: {n_jobs} jobs x {gens} generations: "
        f"{load['evals_per_s']:.1f} evals/s, latency p50 "
        f"{load['latency_p50_s']:.3f} s p99 {load['latency_p99_s']:.3f} s, "
        f"{stats['rounds']} rounds, {dispatches} mega-dispatches of "
        f"{load['mean_batch_occupancy']:.1f} evals; "
        f"{len(sampled)} sampled jobs bit-identical to solo")

    # one round profiled: 16 jobs of one generation, parked, then started
    metrics.reset()
    prof_svc = SearchService(device=dev, max_jobs=16)
    for i in range(16):
        prof_svc.submit(_serve_spec(JobSpec, 200 + i, SERVE_SPACE, 1, 8),
                        auto_start=False)
    wall_s, busy_s, top = profile_device(
        torch, lambda: (prof_svc.start(), prof_svc.wait_all(60.0)), n_top=8)
    prof_svc.drain()
    if metrics.histogram("serve.batch_occupancy").count != 1:
        fail("phase 17a: the profiled service ran more than one round")
    load.update(profiled_round_wall_ms=wall_s * 1e3,
                profiled_round_busy_ms=busy_s * 1e3,
                device_idle_share=1.0 - busy_s / wall_s,
                profiled_round_top_device_us=dict(top))

    # (b) full width: 8 jobs at AdjacencySpace(32, 8), population 24
    fw = SERVE_FULL
    full_specs = [_serve_spec(JobSpec, i, fw["space"], fw["generations"],
                              fw["pop_size"]) for i in range(fw["jobs"])]
    zero_counts()
    t0 = time.perf_counter()
    with SearchService(device=dev, max_jobs=fw["jobs"]) as svc:
        for spec in full_specs:
            svc.submit(spec)
        full_jobs = [svc.wait(s.job_id, 600.0) for s in full_specs]
    full_stats = svc.stats()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_counts = read_counts("serve_full", ("load_propagate", "minplus"))
    space = make_job_space(full_specs[0])
    engine_cpu = DseEngine(device="cpu")
    worst = 0.0
    for job in full_jobs:
        if not _solo_identical(run_spec_solo, front_json_bytes, job, dev):
            fail(f"phase 17b: job {job.job_id} ({job.spec.algo}) differs "
                 f"from its solo run on the card")
        front = job.optimizer.archive.front()
        genomes = np.stack([np.asarray(e.payload, np.int64) for e in front])
        cpu = engine_cpu.evaluate_genomes(space, genomes)
        for f in ("latency", "throughput"):
            got = np.asarray([getattr(e, f) for e in front], np.float64)
            want = np.asarray(getattr(cpu, f), np.float64)
            if not np.allclose(got, want, rtol=RTOL, atol=0.0):
                fail(f"phase 17b: job {job.job_id}'s front {f} differs from "
                     f"the CPU's")
            worst = max(worst, float(np.max(np.abs(got / want - 1.0))))
    full = {"space": fw["space"], "jobs": fw["jobs"],
            "pop_size": fw["pop_size"], "generations": fw["generations"],
            "wall_s": full_s, "evals_total": full_stats["evals_total"],
            "evals_per_s": full_stats["evals_total"] / full_s,
            "rounds": full_stats["rounds"],
            "launches": {k: full_counts[k]
                         for k in ("load_propagate", "minplus")},
            "front_max_rel_diff_vs_cpu": worst}
    log(f"phase 17b: {fw['jobs']} jobs at AdjacencySpace(32, 8), population "
        f"{fw['pop_size']}, {fw['generations']} generations: "
        f"{full['evals_per_s']:.1f} evals/s, every job bit-identical to its "
        f"solo run on the card, fronts within {worst:.3g} of the CPU")

    # the co-batching invariants on the card, on the operands of both
    # spaces' routing tables and proxies: a row's bits at the solo bucket
    # (8) and at a mega-batch bucket (256), where the min-plus kernel's k
    # split differs
    rng = np.random.default_rng(17)
    splits = {}
    for n in (16, 32):
        a = torch.as_tensor(rng.random((256, n, n)) * 8, dtype=torch.float32,
                            device=dev)
        a[a > 7.5] = float("inf")
        a[a > 6] = BIG
        small, big = mp.minplus_cuda(a[:8].contiguous(), a[:8].contiguous()), \
            mp.minplus_cuda(a, a)
        plans = (mp.minplus_plan(8, n, n, n)["split"],
                 mp.minplus_plan(256, n, n, n)["split"])
        if not torch.equal(small, big[:8]):
            fail(f"phase 17: min-plus rows differ between B=8 and B=256 at "
                 f"n={n} (k splits {plans})")
        nh, l0 = random_routing(rng, 256, n, n - 3)
        nh = torch.as_tensor(nh, dtype=torch.int32, device=dev)
        l0 = torch.as_tensor(l0, device=dev)
        w8, f8 = lp.load_prop_cuda(nh[:8].contiguous(), l0[:8].contiguous(),
                                   n - 1)
        w256, f256 = lp.load_prop_cuda(nh, l0, n - 1)
        if not (torch.equal(w8, w256[:8]) and torch.equal(f8, f256[:8])):
            fail(f"phase 17: load-propagation rows differ between B=8 and "
                 f"B=256 at n={n}")
        splits[n] = plans
    log(f"phase 17: min-plus rows (k splits at B=8 / B=256: {splits}) and "
        f"load-propagation rows bit-equal at B=8 and B=256, n in {{16, 32}}")

    # (c) chaos: a job that fails at generation 4, batch-mates intact
    chaos_specs = [
        JobSpec(job_id="ref1", algo="nsga2", generations=12, pop_size=8,
                seed=3, space=dict(SERVE_SPACE)),
        JobSpec(job_id="ref2", algo="sa", generations=12, pop_size=6,
                seed=4, space=dict(SERVE_SPACE)),
        JobSpec(job_id="victim", algo="random", generations=12, pop_size=6,
                seed=5, space=dict(SERVE_SPACE), chaos_fail_generation=4)]
    metrics.reset()
    with SearchService(device=dev) as svc:
        for spec in chaos_specs:
            svc.submit(spec)
        c_jobs = [svc.wait(s.job_id, 600.0) for s in chaos_specs]
    victim = c_jobs[2]
    if victim.status != "failed" or victim.generation != 4:
        fail(f"phase 17c: the chaos job ended {victim.status} at generation "
             f"{victim.generation}")
    for job in c_jobs[:2]:
        if not _solo_identical(run_spec_solo, front_json_bytes, job, dev):
            fail(f"phase 17c: batch-mate {job.job_id} differs from its solo "
                 f"run")
    chaos = {"victim_status": victim.status,
             "victim_generation": victim.generation,
             "batch_faults": metrics.counter("serve.batch_fault").value,
             "retries": metrics.counter("serve.retry").value}
    log(f"phase 17c: the chaos job failed at generation 4 "
        f"({chaos['batch_faults']} batch faults on serve.batch_fault); its "
        f"batch-mates bit-identical to solo")

    # (d) the daemon: SIGKILL mid-run and restart, then SIGTERM drain and
    # resume; survivors' front files byte-equal to their solo fronts
    work = os.path.join(ROOT, "build", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)
    state = os.path.join(work, "state")
    os.makedirs(work)
    daemon_specs = [JobSpec(**dict(s.to_dict(), generations=60))
                    for s in chaos_specs]
    jobs_file = os.path.join(work, "jobs.json")
    with open(jobs_file, "w") as f:
        json.dump([s.to_dict() for s in daemon_specs], f)
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.serve", "--device", "cuda",
           "--state-dir", state, "--jobs", jobs_file, "--exit-when-idle"]
    ckpt = os.path.join(state, "job-ref1.json")

    def ckpt_generation() -> int:
        try:
            with open(ckpt) as f:
                return int(json.load(f)["state"]["generation"])
        except (OSError, ValueError, KeyError):
            return -1

    def run_until(signum, past: int) -> tuple[bool, int, int]:
        """Start the daemon, wait until ref1's checkpoint is past
        generation ``past``, send ``signum``; (landed mid-run, exit code,
        generation at the signal)."""
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 180.0
            while (proc.poll() is None and ckpt_generation() <= past
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            gen = ckpt_generation()
            landed = proc.poll() is None
            if landed:
                proc.send_signal(signum)
            return landed, proc.wait(timeout=120), gen
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    t0 = time.perf_counter()
    killed, _, kill_gen = run_until(signal.SIGKILL, 0)
    # the restart on the same state dir, drained by SIGTERM mid-run
    termed, term_rc, term_gen = run_until(signal.SIGTERM, kill_gen + 2)
    with open(os.path.join(state, "jobs.json")) as f:
        after_term = {e["spec"]["job_id"]: e["status"]
                      for e in json.load(f)["jobs"]}
    if term_rc != 0:
        fail(f"phase 17d: the daemon exited {term_rc} after SIGTERM")
    if termed and after_term.get("ref1") != "suspended":
        fail(f"phase 17d: after the SIGTERM drain ref1 is "
             f"{after_term.get('ref1')}, not suspended")
    daemon_s = time.perf_counter() - t0
    # resume the drained jobs to the end: the daemon's service, in this
    # process (a third daemon would add only its start-up)
    with SearchService(device=dev, state_dir=state) as svc:
        svc.wait_all(timeout_s=300.0)
    with open(os.path.join(state, "jobs.json")) as f:
        final = {e["spec"]["job_id"]: e["status"]
                 for e in json.load(f)["jobs"]}
    if final != {"ref1": "done", "ref2": "done", "victim": "failed"}:
        fail(f"phase 17d: the daemon's jobs ended {final}")
    for spec in daemon_specs[:2]:
        with open(os.path.join(state, f"job-{spec.job_id}.front.json"),
                  "rb") as f:
            served = f.read()
        if served != front_json_bytes(run_spec_solo(spec, device=dev)[1]):
            fail(f"phase 17d: {spec.job_id}'s front file differs from its "
                 f"solo front")
    shutil.rmtree(work, ignore_errors=True)
    configure("info", force=True)
    daemon = {"sigkill_mid_run": killed, "killed_at_generation": kill_gen,
              "sigterm_mid_run": termed, "drained_at_generation": term_gen,
              "status_after_drain": after_term, "final_status": final,
              "two_daemons_s": daemon_s}
    log(f"phase 17d: python -m repro_torch.serve --device cuda: SIGKILL at "
        f"generation {kill_gen} (mid-run: {killed}), restarted and "
        f"SIGTERM-drained at {term_gen} (mid-run: {termed}, exit 0), "
        f"resumed to {final}; survivors' front files == solo fronts")
    return {"load": load, "full_width": full,
            "minplus_k_splits_b8_b256": splits, "chaos": chaos,
            "daemon": daemon}


def simulator_path(torch, dev) -> dict:
    """Phase 18: ``FastSim.run_batch(backend="torch")`` on the card against
    the numpy backend (every SimStats field equal) on the engine
    calibration's 64-chiplet mesh and a 16-chiplet mesh under transpose
    traffic, and the batched saturation search on the torch, numpy and C
    backends. Returns the phase's record."""
    from repro_torch.sim import (SimConfig, fast_sim_from_design,
                                 saturation_throughput_batched)
    from repro_torch.sim._ckernel import get_kernel
    from repro_torch.sim.simfast_torch import K_CYCLES
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    if get_kernel() is None:
        fail("phase 18: no C compiler for the C backend")

    def cfg_for(n):
        cyc = max(600, 40 * n)
        return SimConfig(packet_size_flits=2, warmup_cycles=cyc // 2,
                         measure_cycles=cyc, drain_cycles=cyc, seed=0)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    rec = {"k_cycles_per_graph": K_CYCLES}
    n = SIM_CHIPLETS
    cfg = cfg_for(n)
    fast = fast_sim_from_design(make_design("mesh", n),
                                make_traffic("random_uniform", n), cfg)
    rates = []
    r = 0.1
    for _ in range(5):          # the search's first chunk, accumulated
        rates.append(r)
        r += 0.1
    # the first call at a shape captures its CUDA graphs, included here
    got, torch_s = timed(lambda: fast.run_batch(rates, cfg, "torch",
                                                device=dev))
    want, numpy_s = timed(lambda: fast.run_batch(rates, cfg, "numpy"))
    c_out, c_s = timed(lambda: fast.run_batch(rates, cfg, "c"))
    if got != want or c_out != want:
        fail(f"phase 18: torch/C SimStats differ from numpy on the "
             f"{n}-chiplet mesh at rates {rates}")
    rec["calibration_chunk"] = {
        "n": n, "rates": rates, "horizon_cycles": cfg.warmup_cycles
        + cfg.measure_cycles + cfg.drain_cycles,
        "torch_s_with_capture": torch_s, "numpy_s": numpy_s, "c_s": c_s,
        "stats": [dataclasses.asdict(s) for s in got]}

    m = SIM_SMALL
    cfg_m = cfg_for(m)
    small = fast_sim_from_design(make_design("mesh", m),
                                 make_traffic("transpose", m), cfg_m)
    m_rates = [0.1, 0.3, 0.5]
    got_m, t_m = timed(lambda: small.run_batch(m_rates, cfg_m, "torch",
                                               device=dev))
    want_m = small.run_batch(m_rates, cfg_m, "numpy")
    if got_m != want_m:
        fail(f"phase 18: torch SimStats differ from numpy on the "
             f"{m}-chiplet transpose mesh")
    rec["transpose_16"] = {"rates": m_rates, "torch_s_with_capture": t_m,
                           "stats": [dataclasses.asdict(s) for s in got_m]}
    # one launch per op against the graphs, over a shorter window (the
    # eager loop is launch-bound: 3-5 ms a cycle)
    from repro_torch.sim.simfast_torch import run_batch_torch
    cfg_e = SimConfig(packet_size_flits=2, warmup_cycles=100,
                      measure_cycles=300, drain_cycles=300, seed=0)
    want_e = small.run_batch(m_rates, cfg_e, "numpy")
    graph_e, t_graph = timed(lambda: run_batch_torch(small, m_rates, cfg_e,
                                                     device=dev))
    graph_e, t_graph = timed(lambda: run_batch_torch(small, m_rates, cfg_e,
                                                     device=dev))
    eager_e, t_eager = timed(lambda: run_batch_torch(
        small, m_rates, cfg_e, device=dev, cuda_graph=False))
    if graph_e != want_e or eager_e != want_e:
        fail("phase 18: the torch loop (graphs or eager) differs from numpy "
             "on the 700-cycle window")
    rec["graphs_vs_eager"] = {"cycles": 700, "rates": m_rates,
                              "graphs_warm_s": t_graph, "eager_s": t_eager}

    # the torch backend probes 10 rungs a call (a replica costs the card
    # little); rate and probe count do not depend on the chunk
    sat_t, sat_torch_s = timed(lambda: saturation_throughput_batched(
        fast, cfg, chunk=10, backend="torch", device=dev))
    sat_n, sat_numpy_s = timed(lambda: saturation_throughput_batched(
        fast, cfg, backend="numpy"))
    sat_c, sat_c_s = timed(lambda: saturation_throughput_batched(
        fast, cfg, backend="c"))
    if tuple(sat_t) != tuple(sat_n) or tuple(sat_c) != tuple(sat_n):
        fail(f"phase 18: saturation search torch {tuple(sat_t)} / C "
             f"{tuple(sat_c)} differs from numpy {tuple(sat_n)}")
    rec["saturation"] = {"rate": sat_t.rate, "probes": sat_t.probes,
                         "zero_load_runs": sat_t.zero_load_runs,
                         "torch_chunk": 10, "torch_s": sat_torch_s,
                         "numpy_chunk": 5, "numpy_s": sat_numpy_s,
                         "c_chunk": 5, "c_s": sat_c_s}
    log(f"phase 18: FastSim torch == numpy == C on the {n}-chiplet mesh "
        f"(5 rates: torch {torch_s:.3f} s with graph capture, numpy "
        f"{numpy_s:.3f} s, C {c_s:.3f} s) and the {m}-chiplet transpose "
        f"mesh; 700 cycles in graphs {t_graph:.3f} s, eager {t_eager:.3f} "
        f"s; saturation {sat_t.rate:.4f} after {sat_t.probes} probes on "
        f"every backend (torch {sat_torch_s:.3f} s, numpy "
        f"{sat_numpy_s:.3f} s, C {sat_c_s:.3f} s)")
    return rec


def resume_trace_paths(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 19: checkpointed training with resume on the card, trace
    import into ``evaluate_design`` against the f64 oracle, and the SVG and
    latency-vs-load pictures. Returns the phase's record."""
    import shutil
    import signal
    import tempfile

    from repro_torch.ckpt import latest_step
    from repro_torch.configs import get_config
    from repro_torch.core import evaluate_design
    from repro_torch.core.graph import build_graph
    from repro_torch.core.reference import (latency_reference,
                                            throughput_reference)
    from repro_torch.core.visualize import design_to_svg, latency_vs_load
    from repro_torch.launch import train as T
    from repro_torch.obs import trace as tr
    from repro_torch.routing.tables import build_routing_table
    from repro_torch.topologies import make_design
    from repro_torch.traffic import (aggregate_trace, parse_trace_file,
                                     write_trace_file)
    from repro_torch.traffic.trace import synthetic_trace

    rec = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        # -- 19a. training: uninterrupted against preempted + resumed --------
        cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS,
                                             ssm_kernel=True)
        kw = dict(steps=RESUME_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                  lr=TRAIN_LR, log_every=RESUME_STEPS, seed=0, device=dev)
        torch.cuda.empty_cache()
        zero_counts()
        full_state, full_losses = T.train(cfg, **kw)
        state_bytes = sum(
            t.numel() * t.element_size() for t in
            list(full_state["params"].values())
            + [v for m in full_state["opt"].values() for v in m.values()])
        free = shutil.disk_usage(tmp).free
        if free < 2 * state_bytes:
            fail(f"phase 19: {tmp} has {free} bytes free, the checkpoint "
                 f"needs {state_bytes}")
        real_step = T.make_train_step

        def preempted(*args, **kwargs):
            step_fn = real_step(*args, **kwargs)
            calls = {"n": 0}

            def step(state, batch):
                out = step_fn(state, batch)
                calls["n"] += 1
                if calls["n"] == RESUME_AT:
                    signal.raise_signal(signal.SIGTERM)
                return out
            return step

        ckpt = os.path.join(tmp, "ckpt")
        was_tracing = tr.tracing_enabled()
        tr.enable_tracing(clear=True)
        try:
            T.make_train_step = preempted
            try:
                part_state, first = T.train(cfg, ckpt_dir=ckpt, **kw)
            finally:
                T.make_train_step = real_step
            del part_state
            torch.cuda.empty_cache()
            step_dir = os.path.join(ckpt, f"step_{latest_step(ckpt)}")
            files = os.listdir(step_dir)
            ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                             for f in files)
            state, rest = T.train(cfg, ckpt_dir=ckpt, **kw)
            torch.cuda.synchronize()
            read_counts("resume", ("selective_scan_fwd",
                                   "selective_scan_bwd"))
            spans = {e["name"]: e["dur_us"] / 1e6
                     for e in tr.TRACER.to_dicts()
                     if e["name"] in ("ckpt.save", "ckpt.restore")}
        finally:
            if not was_tracing:
                tr.disable_tracing()
        if latest_step(ckpt) != RESUME_AT - 1 or len(first) != RESUME_AT:
            fail(f"phase 19a: the SIGTERM checkpoint is at step "
                 f"{latest_step(ckpt)} after {len(first)} steps")
        if first + rest != full_losses:
            fail(f"phase 19a: resumed losses {first} + {rest} differ from "
                 f"the uninterrupted run's {full_losses}")
        differ = [k for k in full_state["params"]
                  if not torch.equal(full_state["params"][k],
                                     state["params"][k])]
        differ += [f"{m}.{k}" for m in full_state["opt"]
                   for k in full_state["opt"][m]
                   if not torch.equal(full_state["opt"][m][k],
                                      state["opt"][m][k])]
        if differ or state["step"] != full_state["step"]:
            fail(f"phase 19a: the resumed state differs from the "
                 f"uninterrupted one in {differ[:6]} (step "
                 f"{state['step']} vs {full_state['step']})")
        rec["resume"] = {
            "arch": TRAIN_ARCH, "layers_kept": TRAIN_LAYERS,
            "steps": RESUME_STEPS, "preempted_after": RESUME_AT,
            "losses": full_losses, "bit_equal": True,
            "ckpt_bytes": ckpt_bytes, "state_bytes": state_bytes,
            "shards": sum(f.startswith("shard_") for f in files),
            "save_s": spans.get("ckpt.save"),
            "restore_s": spans.get("ckpt.restore")}
        del full_state, state
        torch.cuda.empty_cache()
        log(f"phase 19a: {TRAIN_ARCH} ({TRAIN_LAYERS} layers) {RESUME_STEPS} "
            f"steps uninterrupted == {RESUME_AT} steps, SIGTERM, checkpoint "
            f"and resume, bit for bit (losses {full_losses}); checkpoint "
            f"{ckpt_bytes} bytes in {rec['resume']['shards']} shards, save "
            f"{spans.get('ckpt.save'):.3f} s, restore "
            f"{spans.get('ckpt.restore'):.3f} s")

        # -- 19b. a trace -> evaluate_design -> the f64 oracle ----------------
        n = TRACE_CHIPLETS
        events = synthetic_trace(n, TRACE_EVENTS, seed=0)
        path = os.path.join(tmp, "mesh.trace")
        write_trace_file(path, events)
        parsed = parse_trace_file(path)
        if parsed != sorted(events, key=lambda e: e[0]):
            fail("phase 19b: the parsed trace differs from the written one")
        traffic = aggregate_trace(parsed, n)
        design = make_design("mesh", n)
        zero_counts()
        got = evaluate_design(design, traffic, device=dev)
        read_counts("trace_design", ("load_propagate",))
        cpu = evaluate_design(design, traffic, device="cpu")
        g = build_graph(design)
        nh = build_routing_table(g, design.routing, design.routing_metric,
                                 design.seed)
        t0 = time.perf_counter()
        oracle = {"latency": latency_reference(g, nh, traffic),
                  "throughput": throughput_reference(g, nh, traffic)}
        oracle_s = time.perf_counter() - t0
        rel = {}
        for what in ("latency", "throughput"):
            v, c, o = (getattr(got, what), getattr(cpu, what), oracle[what])
            rel[what] = {"cpu": abs(v / c - 1), "oracle": abs(v / o - 1)}
            if not (np.isfinite(v) and abs(v / c - 1) <= RTOL):
                fail(f"phase 19b: {what} {v} vs CPU {c}")
            if abs(v / o - 1) > ORACLE_RTOL:
                fail(f"phase 19b: {what} {v} vs the f64 oracle {o}")
        rec["trace"] = {"chiplets": n, "events": TRACE_EVENTS,
                        "latency": got.latency, "throughput": got.throughput,
                        "oracle": oracle, "relative_error": rel,
                        "oracle_s": oracle_s}
        log(f"phase 19b: {TRACE_EVENTS}-event trace on a {n}-chiplet mesh: "
            f"latency {got.latency} throughput {got.throughput}; relative "
            f"error to the CPU {rel['latency']['cpu']:.3g} / "
            f"{rel['throughput']['cpu']:.3g}, to the f64 oracle "
            f"{rel['latency']['oracle']:.3g} / "
            f"{rel['throughput']['oracle']:.3g}")

        # -- 19c. the pictures ------------------------------------------------
        svg = design_to_svg(design, os.path.join(tmp, "mesh.svg"))
        if not (svg.startswith("<svg") and svg.endswith("</svg>")
                and svg.count("<rect") > n):
            fail("phase 19c: the SVG lacks the mesh's chiplets")
        curves = {}
        for backend in ("torch", "numpy", "c"):
            t0 = time.perf_counter()
            rows = latency_vs_load(design, traffic, backend=backend,
                                   device=dev if backend == "torch" else None)
            curves[backend] = (rows, time.perf_counter() - t0)
        if not (curves["torch"][0] == curves["numpy"][0]
                == curves["c"][0]):
            fail("phase 19c: latency_vs_load rows differ between the torch, "
                 "numpy and C backends")
        rows = curves["torch"][0]
        rec["latency_vs_load"] = {
            "rows": rows, "svg_chars": len(svg),
            **{f"{b}_s": curves[b][1] for b in curves}}
        log(f"phase 19c: SVG {len(svg)} characters; latency_vs_load "
            f"{len(rows)} rows equal on torch ({curves['torch'][1]:.3f} s), "
            f"numpy ({curves['numpy'][1]:.3f} s) and C "
            f"({curves['c'][1]:.3f} s): "
            f"{[(r['rate'], round(r['latency'], 3)) for r in rows]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def analysis_path(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 20: ``python -m repro_torch.analysis --check`` in-process with
    the audit on the card: the lint, and every registry contract recorded
    on ``cuda`` with its kernels' launch counters advancing and every run's
    outputs held against the CPU's plain forms on the same seeded inputs
    (the contract's ``parity``: bits for min-plus and APSP, RTOL/ATOL for
    the float sums). Returns the phase's record (findings per check,
    seconds, launches and largest CPU difference per contract)."""
    from repro_torch.analysis.findings import apply_baseline, load_baseline
    from repro_torch.analysis.graph_audit import audit_contract, launch_counts
    from repro_torch.analysis.lint import lint_paths
    from repro_torch.analysis.registry import contracts

    t0 = time.perf_counter()
    lint = lint_paths()
    lint_s = time.perf_counter() - t0
    zero_counts()
    per, audit = {}, []
    for c in contracts():
        before = launch_counts()
        info: dict = {}
        t0 = time.perf_counter()
        found = audit_contract(c, dev, info)
        torch.cuda.synchronize()
        after = launch_counts()
        per[c.name] = {"checks": c.checks(), "findings": len(found),
                       "s": time.perf_counter() - t0,
                       "runs": len(info.get("runs", ())),
                       "cpu_max_abs_err": info.get("cpu_max_abs_err"),
                       "launches": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}}
        if c.parity is not None and "cpu_max_abs_err" not in info:
            fail(f"phase 20: {c.name} was not held against the CPU")
        audit += found
    read_counts("analysis", ("load_propagate", "apsp_fused", "apsp_square",
                             "minplus"))
    findings = apply_baseline(lint + audit, load_baseline())
    if findings:
        fail("phase 20: the analysis gate found "
             + "; ".join(f.format() for f in findings))
    contracts_by_name = {c.name: c for c in contracts()}
    by_check: dict[str, int] = {}
    for c in contracts():
        for check in c.checks():
            key = check.split("=")[0].split("<")[0].split(">")[0]
            by_check[key] = by_check.get(key, 0) + 1
    rec = {"lint_findings": len(lint), "lint_s": lint_s,
           "audit_findings": len(audit),
           "audit_s": sum(r["s"] for r in per.values()),
           "contracts_per_check": by_check, "contracts": per}
    log(f"phase 20: lint {len(lint)} findings in {lint_s:.3f} s; "
        f"{len(per)} contracts audited on the card in "
        f"{rec['audit_s']:.3f} s (CPU parity runs included), "
        f"{len(audit)} findings; contracts per check {by_check}")
    for name, r in per.items():
        if r["cpu_max_abs_err"] is not None:
            log(f"phase 20: {name}: {r['runs']} runs equal the CPU's within "
                f"{contracts_by_name[name].parity}, largest |difference| "
                f"{r['cpu_max_abs_err']!r}, launches {r['launches']}")
    return rec


def _drawn_ahead(cfgs: list):
    """Each of ``cfgs``' models drawn on the host from seed 0 (the weights
    ``Model(cfg, seed=0, device=...)`` draws on any device), in order, the
    next ``DRAW_AHEAD`` drawn at once in threads while the caller works
    with the current one on the card: each draw is one CPU generator's,
    single-threaded and releasing the GIL, so phase 21's host drawing runs
    on several cores and overlaps its card work. Yields (the model on the
    host, the seconds the caller waited for it)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.models import Model
    with ThreadPoolExecutor(DRAW_AHEAD) as pool:
        ahead = [pool.submit(Model, cfg, 0, "cpu")
                 for cfg in cfgs[:DRAW_AHEAD]]
        for i in range(len(cfgs)):
            t0 = time.perf_counter()
            model = ahead[i].result()
            ahead[i] = None
            waited_s = time.perf_counter() - t0
            if i + DRAW_AHEAD < len(cfgs):
                ahead.append(pool.submit(Model, cfgs[i + DRAW_AHEAD], 0,
                                         "cpu"))
            yield model, waited_s


def serve_models_path(torch, dev, zero_counts, read_counts,
                      kept: dict) -> dict:
    """Phase 21: ``repro_torch.launch.serve`` for every decoder-only config
    at its published widths, one model at a time. Per config: B7 held at
    the prefill (Mamba configs, float32: each launch within
    ``SCAN_FWD_TOL`` of the plain scan on the layer's own inputs, one
    launch per Mamba layer, and the logits within ``ROUTE_LOGITS_TOL`` of
    the chunked-scan route's); then the serve
    path with the launch counts zeroed: ``generate`` twice (every logit
    finite, both runs' tokens equal; the second timed), ``Model.prefill``
    at 2 x 2048 twice (the second timed) and the decode step's logits at
    the first 64 positions against the forward pass's, within
    ``DECODE_TOL`` in float32 and measured in the config's dtype; hymba's
    ring buffer at ``RING_WINDOW`` (float32); then every
    config at ``reduced(cfg, dtype="float32")`` on the card against the
    CPU. The models are drawn on the host ahead of the card,
    ``DRAW_AHEAD`` at a time (``_drawn_ahead``); a model's ``build_s`` is
    the wait for it and its move to the card. The models of the configs that phase 22 trains at the
    same cut (``FAMILY_ARCHS``) stay on the card in ``kept``. Returns the
    phase's record."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model, reduced
    from repro_torch.models import layers as L

    def max_err(a, b) -> float:
        return (a.float() - b.float()).abs().max().item()

    def decode_logits(model, tokens, n, params, max_len=None):
        cache = model.init_cache(tokens.shape[0], max_len or n)
        out = []
        for t in range(n):
            lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t,
                                          params)
            out.append(lg[:, 0].float())
        return torch.stack(out, 1), cache

    def forward_logits(model, tokens, n, params, extra=None):
        with torch.no_grad():
            x, _ = model(tokens, params, extra=extra)
            return L.unembed(params["unembed"], x[:, :n],
                             model.cfg.logit_softcap).float()

    archs = [a for a in ARCH_IDS if get_config(a).family != "encdec"]
    cuts = {}
    for arch in archs:
        published = get_config(arch)
        cfg, cut = published, {}
        if arch not in SERVE_FULL_DEPTH:
            layers = TRAIN_LAYERS if arch == TRAIN_ARCH else SERVE_LAYERS
            cut["n_layers"] = [published.n_layers, layers]
            cfg = cfg.replace(n_layers=layers)
        if cfg.uses_ssm:
            cfg = cfg.replace(ssm_kernel=True)
        cuts[arch] = (cfg, cut)
    per: dict[str, dict] = {}
    drawn = _drawn_ahead([cfg for cfg, _ in cuts.values()])
    for arch, (host_model, waited_s) in zip(archs, drawn):
        cfg, cut = cuts[arch]
        vlm = cfg.family == "vlm"
        n_img = cfg.n_image_tokens if vlm else 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = host_model.to(dev)
        del host_model
        torch.cuda.synchronize()
        build_s = waited_s + time.perf_counter() - t0
        params = model.params()
        rec = {"layers": len(model.dense_blocks) + len(model.blocks),
               "first_dense_layers": len(model.dense_blocks),
               "reduced": cut, "dtype": cfg.dtype,
               "n_params": sum(p.numel() for p in model.parameters()),
               "build_s": build_s}
        rng = np.random.default_rng(21)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        pre_tok = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ - n_img))).to(dev)
        extra = ({"patches": f32(rng.normal(0, 1, (PREFILL_BATCH, n_img,
                                                   cfg.d_model)))}
                 if vlm else None)

        # B7 at this prefill, float32: each launch held against the plain
        # scan on the inputs the layer gave it, and the logits against the
        # chunked-scan route's
        if cfg.uses_ssm:
            kernel, route = ss.selective_scan_fwd_cuda, ops.selective_scan_fwd
            scan_errs = []

            last = {}

            def held(*args, chunk):
                got = route(*args, chunk=chunk)
                last.update(args=[t.contiguous() for t in args], chunk=chunk)
                want = ss.selective_scan_fwd_plain(*last["args"], chunk=chunk)
                scan_errs.append(max(max_err(g, w)
                                     for g, w in zip(got, want)))
                if not all(torch.allclose(g, w, **SCAN_FWD_TOL)
                           for g, w in zip(got, want)):
                    fail(f"phase 21: {arch} B7 differs from the plain scan "
                         f"by {scan_errs[-1]} at layer {len(scan_errs) - 1}, "
                         f"{tuple(args[0].shape)}")
                return got

            f32_logits = {}
            for kern in (True, False):
                model.cfg = cfg.replace(dtype="float32", ssm_kernel=kern)
                before = kernel.launches
                ops.selective_scan_fwd = held
                try:
                    f32_logits[kern] = model.prefill(pre_tok, params,
                                                     extra=extra)
                finally:
                    ops.selective_scan_fwd = route
                torch.cuda.synchronize()
                launched = kernel.launches - before
                if launched != (cfg.n_layers if kern else 0):
                    fail(f"phase 21: {arch} float32 prefill with ssm_kernel="
                         f"{kern} launched B7 {launched} times, not once per "
                         f"Mamba layer ({cfg.n_layers})")
            model.cfg = cfg
            err = max_err(f32_logits[True], f32_logits[False])
            if not torch.allclose(f32_logits[True], f32_logits[False],
                                  **ROUTE_LOGITS_TOL):
                fail(f"phase 21: {arch} prefill logits through B7 differ "
                     f"from the chunked scan's by {err}")
            rec["b7_prefill_f32"] = {
                "launches_per_prefill": cfg.n_layers,
                "shape": [PREFILL_BATCH, PREFILL_SEQ, cfg.d_inner,
                          cfg.ssm_state],
                "scan_max_abs_err": max(scan_errs),
                "logits_max_abs_err_vs_chunked_scan": err,
                # the last layer's inputs, timed (launches not counted)
                "ms": time_cuda(torch, lambda: kernel(
                    *last["args"], chunk=last["chunk"]), reps=10)}
            del f32_logits, last

        # the serve path: generate, prefill, decode against the forward
        zero_counts()
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
        finite = []
        step = model.decode_step

        def checked(cache, tokens, pos, params=None):
            lg, cache = step(cache, tokens, pos, params)
            finite.append(torch.isfinite(lg).all())
            return lg, cache

        model.decode_step = checked
        tokens = generate(model, prompts, SERVE_NEW, params=params)
        del model.decode_step
        if not torch.stack(finite).all().item():
            fail(f"phase 21: {arch} generate gave non-finite logits")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = generate(model, prompts, SERVE_NEW, params=params)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        if not np.array_equal(tokens, again):
            fail(f"phase 21: {arch} two greedy runs gave other tokens")
        n_steps = SERVE_PROMPT + SERVE_NEW
        lg = model.prefill(pre_tok, params, extra=extra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = model.prefill(pre_tok, params, extra=extra)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        if not (lg.shape == (PREFILL_BATCH, 1, cfg.vocab_size)
                and torch.isfinite(lg).all().item()):
            fail(f"phase 21: {arch} prefill logits {tuple(lg.shape)} are "
                 f"not finite or not [B, 1, V]")
        # the decode step against the forward at 2048 positions (flash; the
        # VLM's forward gets an empty patch prefix, as decode carries none).
        # Held in float32; in bf16 it is measured only: there flash and the
        # plain scores round apart and near-tied MoE routing flips
        gate_tok = (torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))).to(dev)
            if vlm else pre_tok)
        gate_extra = ({"patches": torch.zeros((PREFILL_BATCH, 0,
                                               cfg.d_model), device=dev)}
                      if vlm else None)
        gate_err = {}
        for dtype in dict.fromkeys(("float32", cfg.dtype)):
            model.cfg = cfg.replace(dtype=dtype)
            full = forward_logits(model, gate_tok, DECODE_POSITIONS, params,
                                  gate_extra)
            dec, cache = decode_logits(model, gate_tok, DECODE_POSITIONS,
                                       params)
            gate_err[dtype] = err = max_err(dec, full)
            if dtype == "float32" and not torch.allclose(dec, full,
                                                         **DECODE_TOL):
                fail(f"phase 21: {arch} float32 decode logits differ from "
                     f"the forward's by {err} over the first "
                     f"{DECODE_POSITIONS} positions")
            del dec, full
        model.cfg = cfg
        torch.cuda.synchronize()
        counts = read_counts(f"serve_{arch}", ("selective_scan_fwd",)
                             if cfg.uses_ssm else ())
        n_forward = 2 + len(gate_err)
        want_b7 = n_forward * cfg.n_layers if cfg.uses_ssm else 0
        if counts["selective_scan_fwd"] != want_b7 or any(
                n for k, n in counts.items() if k != "selective_scan_fwd"):
            fail(f"phase 21: {arch} serve path launches {counts}; B7 should "
                 f"run once per Mamba layer in each of {n_forward} forward "
                 f"passes")
        one = torch.from_numpy(prompts[:PREFILL_BATCH, :1]).to(dev)
        wall_s, busy_s, top = profile_device(
            torch, lambda: model.decode_step(cache, one, DECODE_POSITIONS - 1,
                                             params), n_top=5)
        rec.update({
            "generate_s": gen_s, "decode_steps": n_steps,
            "decode_ms_per_step": gen_s / n_steps * 1e3,
            "decode_tokens_per_s": SERVE_BATCH * n_steps / gen_s,
            "prefill_shape": [PREFILL_BATCH, PREFILL_SEQ],
            "prefill_s": prefill_s,
            "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_SEQ / prefill_s,
            "decode_vs_forward_max_abs_err": gate_err,
            "decode_step_profiled_ms": wall_s * 1e3,
            "decode_step_device_idle_share": 1.0 - busy_s / wall_s,
            "decode_step_top_device_us": dict(top),
            "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
            "launches": counts["selective_scan_fwd"],
            "sample_tokens": tokens[0, :8].tolist()})
        del cache

        if arch == RING_ARCH:       # the ring buffer, window cut to 64
            model.cfg = cfg.replace(window=RING_WINDOW, dtype="float32")
            full = forward_logits(model, gate_tok, RING_STEPS, params)
            dec, cache = decode_logits(model, gate_tok, RING_STEPS, params)
            if cache["scan"]["k"].shape[2] != RING_WINDOW:
                fail(f"phase 21: the ring cache holds "
                     f"{cache['scan']['k'].shape[2]} slots")
            ring_err = max_err(dec, full)
            if not torch.allclose(dec, full, **RING_TOL):
                fail(f"phase 21: {arch} ring-buffer decode differs from the "
                     f"windowed forward by {ring_err}")
            model.cfg = cfg
            rec["ring"] = {"window": RING_WINDOW, "steps": RING_STEPS,
                           "reduced": {"window": [get_config(arch).window,
                                                  RING_WINDOW]},
                           "max_abs_err": ring_err}
            del dec, full, cache
        per[arch] = rec
        log(f"phase 21: {arch} ({rec['layers']} layers, {rec['n_params']} "
            f"parameters, built in {build_s:.1f} s): decode "
            f"{rec['decode_ms_per_step']:.2f} ms/step "
            f"({rec['decode_tokens_per_s']:.1f} tokens/s), prefill "
            f"{rec['prefill_tokens_per_s']:.0f} tokens/s; decode vs forward "
            f"{gate_err}; B7 launches {counts['selective_scan_fwd']}"
            + (f"; ring {rec['ring']['max_abs_err']:.4g}" if "ring" in rec
               else ""))
        if arch in FAMILY_ARCHS and arch not in SERVE_FULL_DEPTH:
            kept[arch] = (model, build_s)
        del model, step, checked, params, lg, pre_tok, gate_tok, extra
        torch.cuda.empty_cache()

    # the card against the CPU, every config at reduced(cfg, float32); the
    # Mamba configs through B7 on the card and its plain version on the CPU
    card_cpu = {}
    for arch in archs:
        rc = reduced(get_config(arch), dtype="float32")
        if rc.uses_ssm:
            rc = rc.replace(ssm_kernel=True)
        cpu = Model(rc, seed=0, device="cpu")
        gpu = Model(rc, seed=0, device=dev)
        prompts = np.random.default_rng(1).integers(
            0, rc.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
        t_cpu = generate(cpu, prompts, SERVE_NEW)
        t_gpu = generate(gpu, prompts, SERVE_NEW)
        if not np.array_equal(t_cpu, t_gpu):
            fail(f"phase 21: {arch} greedy tokens on the card differ from "
                 f"the CPU's")
        seq = torch.from_numpy(np.concatenate([prompts, t_cpu], 1))
        n = SERVE_PROMPT + SERVE_NEW
        lc, _ = decode_logits(cpu, seq, n, cpu.params())
        lg_, _ = decode_logits(gpu, seq.to(dev), n, gpu.params())
        rng = np.random.default_rng(2)
        n_img = rc.n_image_tokens if rc.family == "vlm" else 0
        tok = rng.integers(0, rc.vocab_size, (2, 64 - n_img))
        patches = rng.normal(0, 1, (2, n_img, rc.d_model)).astype(np.float32)
        ex = lambda d: ({"patches": torch.from_numpy(patches).to(d)}
                        if n_img else None)
        pc = cpu.prefill(torch.from_numpy(tok), extra=ex("cpu"))
        pg = gpu.prefill(torch.from_numpy(tok).to(dev), extra=ex(dev))
        errs = {"decode": max_err(lg_.cpu(), lc),
                "prefill": max_err(pg.cpu(), pc)}
        if not (torch.allclose(lg_.cpu(), lc, **CARD_CPU_TOL)
                and torch.allclose(pg.cpu(), pc, **CARD_CPU_TOL)):
            fail(f"phase 21: {arch} reduced float32 logits on the card "
                 f"differ from the CPU's by {errs}")
        card_cpu[arch] = errs
        del cpu, gpu
    log(f"phase 21: every config at reduced(cfg, float32): greedy tokens on "
        f"the card equal the CPU's, logits within {CARD_CPU_TOL} "
        f"(largest {max(max(e.values()) for e in card_cpu.values()):.3g})")
    return {"configs": per, "card_vs_cpu_max_abs_err": card_cpu}


def train_families_path(torch, dev, zero_counts, read_counts, clock_hz,
                        kept: dict) -> dict:
    """Phase 22: training every family on the card. (a) whisper-medium at
    its published widths and depth: forward and loss at 2 x 2048 tokens
    over 1500 frames, the cross-KV cache filled from the encoder, the
    decode step against the forward over ``DECODE_POSITIONS`` (float32
    within ``DECODE_TOL``; bf16 measured), ``launch.serve.generate`` with
    the filled cache (two greedy runs equal), ``FAMILY_STEPS`` AdamW steps.
    (b) The other families at published widths cut to ``SERVE_LAYERS``,
    ``FAMILY_STEPS`` steps each (the models phase 21 drew at that cut taken
    from ``kept``); hymba's B7 and B8 held on each launch of its first step
    against the plain scans on the layer's own inputs, and B8 timed at that
    shape beside its bound. Every family's scan launches as its remat
    predicts, its losses finite; step ms, tokens/s, peak memory and the
    device idle share of one step. (c) Each family at ``reduced(cfg,
    float32)``: loss and gradient norm on the card against the CPU. (d)
    hymba at reduced widths under remat "dots", "full" and "none": equal
    losses and gradients, launches as each policy predicts. Returns the
    phase's record."""
    import contextlib

    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import build_state, to_device
    from repro_torch.models import Model, reduced
    from repro_torch.models import layers as L
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import global_norm

    card = card_line()
    ocfg = OptConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                     decay_steps=FAMILY_STEPS)
    n_tok = TRAIN_BATCH * TRAIN_SEQ

    def max_err(a, b) -> float:
        return (a.float() - b.float()).abs().max().item()

    @contextlib.contextmanager
    def scans_held(errs: dict, last: dict):
        """Each B7 / B8 launch inside held against its plain version on the
        same inputs (those comparisons launch nothing)."""
        route = {"fwd": ops.selective_scan_fwd, "bwd": ops.selective_scan_bwd}
        plain = {"fwd": ss.selective_scan_fwd_plain,
                 "bwd": ss.selective_scan_bwd_plain}
        tol = {"fwd": SCAN_FWD_TOL, "bwd": SCAN_BWD_TOL}

        def held(which):
            def call(*args, chunk):
                got = route[which](*args, chunk=chunk)
                args = [t.contiguous() for t in args]
                want = plain[which](*args, chunk=chunk)
                errs[which].append(max(max_err(g, w)
                                       for g, w in zip(got, want)))
                if not all(torch.allclose(g, w, **tol[which])
                           for g, w in zip(got, want)):
                    fail(f"phase 22: B{7 if which == 'fwd' else 8} differs "
                         f"from its plain version by {errs[which][-1]} at "
                         f"{tuple(args[0].shape)}")
                last[which] = (args, chunk)
                return got
            return call

        ops.selective_scan_fwd = held("fwd")
        ops.selective_scan_bwd = held("bwd")
        try:
            yield
        finally:
            ops.selective_scan_fwd = route["fwd"]
            ops.selective_scan_bwd = route["bwd"]

    def train_steps(model, path: str, holds=None) -> dict:
        """FAMILY_STEPS AdamW steps on the data pipeline's batches (the
        first under ``holds``), the launch counts zeroed before and read
        after; then one step under the profiler. The peak is the process's
        less what the models kept for later families hold."""
        cfg = model.cfg
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        others = torch.cuda.memory_allocated() - sum(
            p.numel() * p.element_size() for p in model.parameters())
        source = make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
        state = build_state(model, "adamw")
        step = make_train_step(model, ocfg)
        losses, step_s = [], []
        zero_counts()
        for i in range(FAMILY_STEPS):
            batch = to_device(source.batch_at(i), dev)
            ctx = holds if (holds is not None and i == 0) else \
                contextlib.nullcontext()
            t0 = time.perf_counter()
            with ctx:
                state, m = step(state, batch)
            losses.append(m["loss"].item())
            step_s.append(time.perf_counter() - t0)
        counts = read_counts(path, ("selective_scan_fwd",
                                    "selective_scan_bwd")
                             if cfg.uses_ssm else ())
        want = scan_launches(cfg, FAMILY_STEPS)
        scans = {k: counts[k] for k in want}
        if scans != want or any(n for k, n in counts.items()
                                if k not in scans):
            fail(f"phase 22: {path} launched {counts}; remat "
                 f"{cfg.remat!r} predicts {want}")
        if not np.all(np.isfinite(losses)):
            fail(f"phase 22: {path} losses {losses} are not finite")
        peak = torch.cuda.max_memory_allocated() - others
        wall_s, busy_s, top = profile_device(
            torch, lambda: step(state, batch), n_top=5)
        step_ms = statistics.median(step_s[1:]) * 1e3
        del state, step, batch
        return {"losses": losses, "step_ms": step_ms,
                "first_step_ms": step_s[0] * 1e3,
                "tokens_per_s": n_tok / (step_ms / 1e3),
                "peak_alloc_bytes": peak, "other_models_bytes": others,
                "profiled_step_ms": wall_s * 1e3,
                "device_busy_ms": busy_s * 1e3,
                "device_idle_share": 1.0 - busy_s / wall_s,
                "top_device_us": dict(top), "launches": scans}

    def family_line(arch, rec) -> str:
        return (f"phase 22: {arch} ({rec['layers']} layers, "
                f"{rec['n_params']} parameters): build_s "
                f"{rec['build_s']:.1f}, step {rec['step_ms']:.1f} ms, "
                f"{rec['tokens_per_s']:.0f} tokens/s, peak "
                f"{rec['peak_alloc_bytes'] / 1e9:.2f} GB, device idle "
                f"{rec['device_idle_share']:.4f}; losses {rec['losses']}; "
                f"scan launches {rec['launches']} ({card})")

    per: dict[str, dict] = {}
    rng = np.random.default_rng(22)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # -- (a) whisper-medium at its published widths and depth --------------
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = model.params()
    T, D, V = cfg.n_audio_frames, cfg.d_model, cfg.vocab_size
    tok = torch.from_numpy(rng.integers(0, V, (TRAIN_BATCH,
                                               TRAIN_SEQ + 1))).to(dev)
    frames = f32(rng.normal(0, 1, (TRAIN_BATCH, T, D)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:], "frames": frames}
    zero_counts()
    with torch.no_grad():
        x, _ = model(batch["tokens"], params, extra={"frames": frames})
        loss, metrics = model.loss(batch, params=params)
    if not (x.shape == (TRAIN_BATCH, TRAIN_SEQ, D)
            and torch.isfinite(x).all().item()
            and np.isfinite(loss.item())
            and metrics["ce"].item() < 2 * np.log(V)):
        fail(f"phase 22: whisper forward {tuple(x.shape)} / loss "
             f"{loss.item()} not finite or not near log(vocab)")
    wrec = {"layers": len(model.blocks),
            "encoder_layers": len(model.enc_blocks), "frames": T,
            "n_params": sum(p.numel() for p in model.parameters()),
            "build_s": build_s, "forward_loss": loss.item()}
    del x, loss, metrics

    def decode_vs_forward(dtype) -> float:
        model.cfg = cfg.replace(dtype=dtype)
        dt = model.cfg.compute_dtype
        n = DECODE_POSITIONS
        with torch.no_grad():
            x, _ = model(batch["tokens"][:, :n], params,
                         extra={"frames": frames})
            full = L.unembed(params["unembed"], x, cfg.logit_softcap).float()
            enc, _ = model._encode(frames.to(dt), params)
        cache = model.init_cache(TRAIN_BATCH, n)
        cache["cross_k"], cache["cross_v"] = model.cross_kv(enc, params)
        dec = torch.stack([model.decode_step(
            cache, batch["tokens"][:, t:t + 1], t, params)[0][:, 0].float()
            for t in range(n)], 1)
        err = max_err(dec, full)
        if dtype == "float32" and not torch.allclose(dec, full,
                                                     **DECODE_TOL):
            fail(f"phase 22: whisper float32 decode logits differ from the "
                 f"forward's by {err} over the first {n} positions")
        return err

    gate_err = {d: decode_vs_forward(d)
                for d in dict.fromkeys(("float32", cfg.dtype))}
    model.cfg = cfg
    # greedy decode through launch.serve.generate, its cache's cross keys
    # and values filled from the encoder
    frames4 = f32(rng.normal(0, 1, (SERVE_BATCH, T, D)))
    with torch.no_grad():
        enc4, _ = model._encode(frames4.to(cfg.compute_dtype), params)
    cross = model.cross_kv(enc4, params)
    init_cache, decode_step = model.init_cache, model.decode_step
    finite = []

    def filled(b, max_len):
        cache = init_cache(b, max_len)
        cache["cross_k"], cache["cross_v"] = cross
        return cache

    def checked(cache, tokens, pos, params=None):
        lg, cache = decode_step(cache, tokens, pos, params)
        finite.append(torch.isfinite(lg).all())
        return lg, cache

    model.init_cache, model.decode_step = filled, checked
    prompts = np.random.default_rng(0).integers(0, V, (SERVE_BATCH,
                                                       SERVE_PROMPT))
    tokens = generate(model, prompts, SERVE_NEW, params=params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = generate(model, prompts, SERVE_NEW, params=params)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del model.init_cache, model.decode_step
    if not torch.stack(finite).all().item():
        fail("phase 22: whisper generate gave non-finite logits")
    if not np.array_equal(tokens, again):
        fail("phase 22: whisper's two greedy runs gave other tokens")
    read_counts("whisper_serve", ())
    n_steps = SERVE_PROMPT + SERVE_NEW
    wrec.update({"decode_vs_forward_max_abs_err": gate_err,
                 "generate_s": gen_s,
                 "decode_ms_per_step": gen_s / n_steps * 1e3,
                 "decode_tokens_per_s": SERVE_BATCH * n_steps / gen_s,
                 "sample_tokens": tokens[0, :8].tolist()})
    del cross, enc4, frames4, params, batch, frames, tok
    torch.cuda.empty_cache()
    wrec.update(train_steps(model, f"train_{ENCDEC_ARCH}"))
    per[ENCDEC_ARCH] = wrec
    log(family_line(ENCDEC_ARCH, wrec))
    log(f"phase 22: whisper decode vs forward {gate_err} over "
        f"{DECODE_POSITIONS} positions; generate "
        f"{wrec['decode_ms_per_step']:.2f} ms/step "
        f"({wrec['decode_tokens_per_s']:.1f} tokens/s) ({card})")
    del model
    torch.cuda.empty_cache()

    # -- (b) the other families, cut to SERVE_LAYERS ------------------------
    b8 = None
    for arch in FAMILY_ARCHS:
        published = get_config(arch)
        cfg = published.replace(n_layers=SERVE_LAYERS)
        if cfg.uses_ssm:
            cfg = cfg.replace(ssm_kernel=True)
        model, build_s = kept.pop(arch, (None, None))
        reused = model is not None and model.cfg == cfg
        if not reused:
            model = None
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            model = Model(cfg, seed=0, device=dev)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        rec = {"layers": len(model.dense_blocks) + len(model.blocks),
               "first_dense_layers": len(model.dense_blocks),
               "reduced": {"n_layers": [published.n_layers, SERVE_LAYERS]},
               "n_params": sum(p.numel() for p in model.parameters()),
               "build_s": build_s, "drawn_in_phase_21": reused}
        errs, last = {"fwd": [], "bwd": []}, {}
        holds = scans_held(errs, last) if cfg.uses_ssm else None
        rec.update(train_steps(model, f"train_{arch}", holds))
        if cfg.uses_ssm:
            args, chunk = last["bwd"]
            shape = [*args[0].shape, args[2].shape[-1]]
            want = scan_launches(cfg, 1)
            if (len(errs["fwd"]), len(errs["bwd"])) != (
                    want["selective_scan_fwd"], want["selective_scan_bwd"]):
                fail(f"phase 22: {arch}'s first step held "
                     f"{len(errs['fwd'])} B7 and {len(errs['bwd'])} B8 "
                     f"launches, not {want}")

            def call():
                return ss.selective_scan_bwd_cuda(*args, chunk=chunk)

            _, bwd_bound = scan_bounds(*shape, chunk, clock_hz)
            b8 = {"arch": arch, "shape": shape, "chunk": chunk,
                  "ms": time_cuda(torch, call, reps=5),
                  **call_device_ms(torch, call, SCAN_BWD_KERNELS, reps=5),
                  "plain_ms": time_cuda(
                      torch, lambda: ss.selective_scan_bwd_plain(
                          *args, chunk=chunk), reps=1, warmup=1),
                  **bwd_bound, "max_abs_err": max(errs["bwd"]),
                  "b7_max_abs_err": max(errs["fwd"]),
                  "held_launches": {"fwd": len(errs["fwd"]),
                                    "bwd": len(errs["bwd"])}}
            rec["scans_held"] = b8
            log(f"phase 22: {arch} B7 / B8 on each launch of a step within "
                f"{SCAN_FWD_TOL} / {SCAN_BWD_TOL} of plain at {shape} "
                f"(max abs err {b8['b7_max_abs_err']:.3g} / "
                f"{b8['max_abs_err']:.3g}); B8 {b8['ms']:.4f} ms (device "
                f"{b8['device_ms']:.4f}, bound {b8['bound_ms']:.4f} "
                f"{b8['bound_by']}, plain {b8['plain_ms']:.1f}) ({card})")
            del args, last, call
        per[arch] = rec
        log(family_line(arch, rec))
        del model
        torch.cuda.empty_cache()
    if b8 is None:
        fail("phase 22: no trained family ran the scan kernels")

    # -- (c) the card against the CPU at reduced(cfg, float32) --------------
    card_cpu = {}
    for arch in (ENCDEC_ARCH,) + FAMILY_ARCHS:
        rc = reduced(get_config(arch), dtype="float32")
        if rc.uses_ssm:
            rc = rc.replace(ssm_kernel=True)
        host = make_pipeline(rc, 2, 64, seed=1).batch_at(0)

        def loss_and_norm(d):
            m = Model(rc, seed=0, device=d)
            loss, _ = m.loss(to_device(host, torch.device(d)))
            grads = torch.autograd.grad(loss, list(m.parameters()))
            return loss.item(), global_norm(dict(enumerate(grads))).item()

        (lc, gc), (lg, gg) = loss_and_norm("cpu"), loss_and_norm(dev)
        card_cpu[arch] = {"loss_rel": abs(lg / lc - 1),
                          "grad_norm_rel": abs(gg / gc - 1)}
        if not (card_cpu[arch]["loss_rel"] <= CARD_CPU_TOL["rtol"]
                and card_cpu[arch]["grad_norm_rel"] <= CARD_CPU_GRAD_RTOL):
            fail(f"phase 22: {arch} reduced float32 loss {lg} / gradient "
                 f"norm {gg} on the card vs {lc} / {gc} on the CPU")
    log(f"phase 22: every family at reduced(cfg, float32): loss within rtol "
        f"{CARD_CPU_TOL['rtol']} and gradient norm within "
        f"{CARD_CPU_GRAD_RTOL} of the CPU's ({card_cpu}) ({card})")

    # -- (d) remat "dots" against "full" and "none" on the card ------------
    rc = reduced(get_config(REMAT_ARCH), ssm_kernel=True)
    host = make_pipeline(rc, 2, 128, seed=2).batch_at(0)
    remat = {}
    for policy in ("dots", "full", "none"):
        m = Model(rc.replace(remat=policy), seed=0, device=dev)
        zero_counts()
        loss, _ = m.loss(to_device(host, dev))
        grads = torch.autograd.grad(loss, list(m.parameters()))
        torch.cuda.synchronize()
        counts = read_counts(f"remat_{policy}", ("selective_scan_fwd",
                                                 "selective_scan_bwd"))
        want = scan_launches(m.cfg, 1)
        if {k: counts[k] for k in want} != want:
            fail(f"phase 22: remat {policy!r} launched {counts}, it "
                 f"predicts {want}")
        remat[policy] = (loss.detach(), grads, want)
        del m
    for policy in ("full", "none"):
        if not (torch.equal(remat["dots"][0], remat[policy][0])
                and all(torch.equal(a, b) for a, b in
                        zip(remat["dots"][1], remat[policy][1]))):
            fail(f"phase 22: remat 'dots' and {policy!r} give other losses "
                 f"or gradients")
    launches = {k: v[2] for k, v in remat.items()}
    log(f"phase 22: {REMAT_ARCH} (reduced, {rc.n_layers} layers) remat "
        f"'dots' == 'full' == 'none' bit for bit; scan launches {launches} "
        f"({card})")
    return {"card": card, "families": per, "b8_hybrid": b8,
            "card_vs_cpu": card_cpu, "remat_launches": launches,
            "remat_loss": remat["dots"][0].item()}


def dryrun_tasks() -> list:
    """Phase 23's host work, longest first: dry-run cells as ("dryrun",
    arch, shape, variant, multi_pod), rank 0 of the production mesh each;
    the one-device count of each cell's step as ("ideal", arch, shape,
    variant), once for every variant that changes the step's products
    (``ideal_variant``); and the CPU side of the card's interconnect
    checks."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.dryrun import VARIANTS

    both, single = (False, True), (False,)
    cells = [(a, "train_4k", "baseline",
              both if a == DRYRUN_ARCH else single) for a in DRYRUN_TRAIN]
    # each variant where it changes the step: the accumulation buffer's
    # layout and the bf16 gather at train_4k, the fused scan on the SSM
    # arch's train step; every variant at decode_32k (serve_tp's rules)
    cells += [(DRYRUN_ARCH, "train_4k", v, single)
              for v in ("accum_rs", "bf16_gather")]
    cells += [("falcon-mamba-7b", "train_4k", "ssm_fused", single)]
    cells += [(DRYRUN_ARCH, "decode_32k", v, both) for v in VARIANTS]
    cells += [(DRYRUN_ARCH, "long_500k", "baseline", both)]
    cells += [(a, s, "baseline",
               both if s == "long_500k" and a in LONG_CONTEXT_ARCHS
               else single) for a in ARCH_IDS
              if a != DRYRUN_ARCH for s in ("decode_32k", "long_500k")]
    order = {"train_4k": 0}
    work = [("dryrun", a, s, v, multi) for a, s, v, meshes in cells
            for multi in meshes]
    work += sorted({("ideal", a, s, ideal_variant(a, v))
                    for a, s, v, _ in cells})
    # the pool takes the tasks in this order, so the last to start are
    # short: a shape's rank counts before its one-device count (a train
    # step's is traced as one microbatch)
    tasks = sorted(work, key=lambda t: (order.get(t[2], 2), t[0] == "ideal"))
    tasks += [("rank", a) for a in ARCH_IDS]
    tasks += [("estimates", rows, wrap) for rows in (16, 4)
              for wrap in (True, False)]
    return tasks


def ideal_variant(arch: str, variant: str) -> str:
    """The variant whose one-device step has ``variant``'s products: the
    baseline's, but for the fused scan of an SSM arch (the rules, the
    accumulation buffer's layout and a bf16 cast change no product)."""
    from repro_torch.configs import get_config
    if variant == "ssm_fused" and get_config(arch).uses_ssm:
        return variant
    return "baseline"


def host_task(task):
    """One unit of phase 23's host work, in a worker process (one thread):
    a dry-run cell's record with its wall seconds, the one-device FLOPs of
    a cell's step (None where the shape does not apply), or the CPU's
    ``rank_layouts`` / ``estimate_collective`` results."""
    if os.path.join(ROOT, "src") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(1)
    import repro_torch.core  # noqa: F401  (the routing package's order)
    from repro_torch.configs import get_config
    from repro_torch.core.ici_model import estimate_collective
    from repro_torch.launch import dryrun as D
    from repro_torch.models import SHAPES_BY_NAME, shape_applicable
    from repro_torch.sharding.autoshard import rank_layouts

    t0 = time.perf_counter()
    if task[0] == "dryrun":
        _, arch, shape, variant, multi = task
        out = D.lower_cell(arch, shape, multi, variant=variant)
    elif task[0] == "ideal":
        _, arch, shape, variant = task
        cfg = D.variant_config(get_config(arch), variant)
        spec = SHAPES_BY_NAME[shape]
        out = None
        if shape_applicable(cfg, spec)[0]:
            # one device's products do not depend on the microbatch count
            # (the same FLOPs at every train_4k cell; a single microbatch
            # is traced in a quarter to an eighth of the time)
            out = D.count_step(cfg, spec)["flops"]
    elif task[0] == "rank":
        out = rank_layouts(get_config(task[1]), 256, 4096, RANK_SHAPE,
                           device="cpu")
    else:
        _, rows, wrap = task
        out = {f"{k}/{ax}": dataclasses.asdict(estimate_collective(
            k, ax, ICI_BYTES, rows=rows, cols=rows, wrap=wrap, device="cpu"))
            for k in ICI_KINDS for ax in ("data", "model")}
    return task, out, time.perf_counter() - t0


def _long_context_held(r: dict, cell: dict) -> None:
    """Phase 23(e)'s gates on a long_500k record ``r`` (its ``cell``): its
    decode step gathers no parameter, each all-gather at most one token's
    largest activation (4 bytes x the larger of d_model and the
    vocabulary; a parameter's shard is thousands of times that), and
    falcon-mamba-7b's on 16 x 16 is under ``LONG_FALCON_MAX_RATIO`` x the
    ideal split."""
    from repro_torch.configs import get_config
    cfg = get_config(r["arch"])
    ops = cell["collective_op_counts"]["all-gather"]
    nbytes = cell["collective_breakdown"]["all-gather"]
    most = 4 * max(cfg.d_model, cfg.vocab_size)
    if nbytes > ops * most:
        fail(f"phase 23: {r['arch']} long_500k {r['mesh']} all-gathers "
             f"{nbytes} bytes in {ops} ops, more than one token's "
             f"activation ({most} bytes) each: a parameter is gathered")
    if r["arch"] == "falcon-mamba-7b" and r["mesh"] == "16x16" and \
            cell["ideal_ratio"] >= LONG_FALCON_MAX_RATIO:
        fail(f"phase 23: falcon-mamba-7b long_500k on 16x16 is "
             f"{cell['ideal_ratio']:.4f} x the ideal split, not under "
             f"{LONG_FALCON_MAX_RATIO}")


def _moe_decode_held(cell: dict) -> None:
    """Phase 23(e)'s gate on ``MOE_DECODE_ARCH``'s decode_32k record on 16
    x 16 (its ``cell``): its MoE layer keeps each expert leaf's data shard,
    so rank 0 is under ``MOE_DECODE_MAX_RATIO`` x the ideal split and
    all-gathers fewer than ``MOE_DECODE_MAX_GATHER_BYTES``."""
    nbytes = cell["collective_breakdown"]["all-gather"]
    if cell["ideal_ratio"] >= MOE_DECODE_MAX_RATIO or \
            nbytes >= MOE_DECODE_MAX_GATHER_BYTES:
        fail(f"phase 23: {MOE_DECODE_ARCH} decode_32k on 16x16 is "
             f"{cell['ideal_ratio']:.4f} x the ideal split (gate "
             f"{MOE_DECODE_MAX_RATIO}) and all-gathers {nbytes:.6g} bytes "
             f"(gate {MOE_DECODE_MAX_GATHER_BYTES:.6g}): its experts are "
             f"gathered over \"data\"")


def dryrun_sharding_path(torch, dev, zero_counts, read_counts,
                         kernel_record) -> dict:
    """Phase 23: the dry-run and sharding stack. The host work of
    ``dryrun_tasks`` runs on ``DRYRUN_WORKERS`` spawned processes while the
    card (a) prices every collective kind over both axes of the 16 x 16
    pod, torus and mesh (B2), and the 4 x 4 ones (B1), (b) ranks every
    arch's layouts at train_4k, (c) quantizes and all-reduces over an NCCL
    world of 1 and runs a 1-stage pipeline, and (d) trains ``FLOP_ARCH``
    cut to ``FLOP_LAYERS`` at 2 x 2048 under FlopCounterMode, whose count
    must equal the meta trace's. Then every estimate and ranking is held
    against the CPU's, and the dry-run records are checked. Returns the
    phase's record."""
    import multiprocessing

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.ici_model import (NVLINK4_LINK_BW, _pod_structure,
                                            collective_traffic,
                                            estimate_collective)
    from repro_torch.core.throughput import _dest_major_load0
    from repro_torch.kernels import load_prop as lp
    from repro_torch.launch import dryrun as D
    from repro_torch.models import Model, ShapeSpec, make_inputs
    from repro_torch.sharding import MeshShape
    from repro_torch.sharding.autoshard import rank_layouts
    from repro_torch.sharding.compression import (make_compressed_allreduce,
                                                  quantize_int8)
    from repro_torch.sharding.pipeline import pipeline_apply
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.state import init_train_state

    card = card_line()
    rec: dict = {"card": card}
    tasks = dryrun_tasks()
    pool = multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS)
    try:
        pending = pool.map_async(host_task, tasks, chunksize=1)

        # (a) the pod's interconnect on the card
        estimates, calls = {}, {}
        for rows, path in ((16, "ici_model_16x16"), (4, "ici_model_4x4")):
            zero_counts()
            n_calls = 0
            for wrap in (True, False):
                for k in ICI_KINDS:
                    for ax in ("data", "model"):
                        est = estimate_collective(k, ax, ICI_BYTES, rows=rows,
                                                  cols=rows, wrap=wrap,
                                                  device=dev)
                        estimates[(rows, wrap, f"{k}/{ax}")] = \
                            dataclasses.asdict(est)
                        n_calls += 1
            counts = read_counts(path, ("load_propagate",))
            if counts["load_propagate"] != n_calls:
                fail(f"phase 23: {n_calls} estimates at {rows}x{rows} "
                     f"launched load propagation "
                     f"{counts['load_propagate']} times")
            calls[path] = n_calls
            ring = estimates[(rows, True, "all_gather/data")]
            if abs(ring["proxy_s"] / ring["analytic_s"] - 1) > \
                    RING_ALLGATHER_REL:
                fail(f"phase 23: the {rows}x{rows} torus ring all-gather's "
                     f"proxy {ring['proxy_s']} is not its analytic time "
                     f"{ring['analytic_s']}")
        one = lambda: estimate_collective("all_reduce", "model", ICI_BYTES,
                                          device=dev)
        t0 = time.perf_counter()
        for _ in range(10):
            one()
        rec["estimate_ms_card"] = (time.perf_counter() - t0) / 10 * 1e3
        t0 = time.perf_counter()
        for _ in range(3):
            estimate_collective("all_reduce", "model", ICI_BYTES,
                                device="cpu")
        rec["estimate_ms_host"] = (time.perf_counter() - t0) / 3 * 1e3
        _, hops, on_dev = _pod_structure(16, 16, True, NVLINK4_LINK_BW, dev)
        nh = on_dev["next_hop"][None].contiguous()
        traffic = torch.from_numpy(collective_traffic(
            "all_to_all", 16, 16, "data", ICI_BYTES).astype(np.float32)).to(dev)
        rec["b2_at_pod"] = kernel_record(
            nh, _dest_major_load0(nh, traffic[None]).contiguous(), hops)
        rec["pod_routed_diameter"] = hops
        log(f"phase 23: 16x16 pod routed diameter {hops} hops; "
            f"estimate_collective {rec['estimate_ms_card']:.3f} ms on the "
            f"card, {rec['estimate_ms_host']:.3f} ms on the host; B2 at "
            f"[1,256,256] {rec['b2_at_pod']['ms']:.5f} ms (bound "
            f"{rec['b2_at_pod']['bound_ms']:.5f}) ({card})")

        # (b) layout ranking on the card
        zero_counts()
        ranked = {a: rank_layouts(get_config(a), 256, 4096, RANK_SHAPE,
                                  device=dev) for a in ARCH_IDS}
        calls["autoshard"] = read_counts("autoshard", ("load_propagate",))[
            "load_propagate"]

        # (c) compression and the pipeline over an NCCL world of 1
        gen = torch.Generator(device=dev)
        gen.manual_seed(23)
        for shape in ((57, 33), (4096, 4096)):
            x = torch.randn(shape, generator=gen, device=dev)
            qc, sc = quantize_int8(x)
            qh, sh = quantize_int8(x.cpu())
            if not (torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh)):
                fail(f"phase 23: quantize_int8 on the card differs from the "
                     f"host's at {shape}")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
            grads = {"w": torch.randn((4096, 4096), generator=gen,
                                      device=dev),
                     "b": torch.randn((1000,), generator=gen, device=dev)}
            out = make_compressed_allreduce(mesh, axes=("data",))(grads)
            rec["compressed_allreduce_max_err"] = 0.0
            for k, g in grads.items():
                _, scale = quantize_int8(g)
                err = (out[k] - g).abs().max().item()
                step = scale.max().item()
                if not err <= 0.5 * step * (1 + 1e-6):
                    fail(f"phase 23: the compressed all-reduce of {k} is "
                         f"{err} from its input, past half the quantisation "
                         f"step {step}")
                rec["compressed_allreduce_max_err"] = max(
                    err, rec["compressed_allreduce_max_err"])
            stages = init_device_mesh("cuda", (1,),
                                      mesh_dim_names=("stage",))
            w = torch.randn((1, 256, 256), generator=gen, device=dev) * 0.05
            xs = torch.randn((6, 8, 256), generator=gen, device=dev)
            piped = pipeline_apply(lambda p, x: torch.tanh(x @ p),
                                   stages)(w, xs)
            direct = torch.stack([torch.tanh(x @ w[0]) for x in xs])
            if not torch.equal(piped, direct):
                fail("phase 23: the 1-stage pipeline differs from the "
                     "direct stack")
        finally:
            dist.destroy_process_group()

        # (d) the meta trace's FLOPs against a real step on the card
        full = get_config(FLOP_ARCH)
        cfg = D.cut_depth(full, FLOP_LAYERS)
        spec = ShapeSpec("flop_check", TRAIN_SEQ, TRAIN_BATCH, "train")
        meta = D.count_step(cfg, spec)
        one_dev = D.dry_run_cell(cfg, spec, MeshShape(("data", "model"),
                                                      (1, 1)))
        model = Model(cfg, device="meta").to_empty(device=dev)
        torch.manual_seed(0)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("scale"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02)
        state = init_train_state(model, adamw_init)
        step = make_train_step(model, OptConfig(learning_rate=TRAIN_LR))
        batch = make_inputs(cfg, spec, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        card_flops = fc.get_total_flops()
        if card_flops != meta["flops"]:
            fail(f"phase 23: a {FLOP_ARCH} step on the card counts "
                 f"{card_flops} FLOPs, its meta trace {meta['flops']}")
        step_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(metrics["loss"])):
            fail(f"phase 23: {FLOP_ARCH}'s loss is {float(metrics['loss'])}")
        ms = statistics.median(step_ms)
        rec["flop_check"] = {
            "arch": FLOP_ARCH, "layers": FLOP_LAYERS,
            "shape": [TRAIN_BATCH, TRAIN_SEQ], "flops": card_flops,
            "meta_flops": meta["flops"], "step_ms": ms,
            "tflops_per_s": card_flops / (ms / 1e3) / 1e12,
            "max_memory_allocated": peak,
            "dryrun_argument_bytes": one_dev["memory"]["argument_bytes"],
            "dryrun_temp_bytes": one_dev["memory"]["temp_bytes"],
            "meta_trace_s": meta["trace_s"]}
        log(f"phase 23: {FLOP_ARCH} x{FLOP_LAYERS} layers at "
            f"{TRAIN_BATCH}x{TRAIN_SEQ}: {card_flops:.6g} FLOPs on the card "
            f"= the meta trace's; step {ms:.2f} ms, "
            f"{rec['flop_check']['tflops_per_s']:.2f} TFLOP/s; peak "
            f"{peak / 2**30:.3f} GiB against the dry-run's arguments "
            f"{one_dev['memory']['argument_bytes'] / 2**30:.3f} GiB + temp "
            f"{one_dev['memory']['temp_bytes'] / 2**30:.3f} GiB ({card})")
        del model, state, batch

        # the host's results, and the CPU's side of (a) and (b)
        t0 = time.perf_counter()
        results = pending.get(timeout=600)
        rec["host_wait_s"] = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()

    worst = 0.0
    records, ideal, task_s = [], {}, {}
    for task, out, secs in results:
        task_s["/".join(str(t) for t in task)] = secs
        if task[0] == "estimates":
            _, rows, wrap = task
            for key, want in out.items():
                got = estimates[(rows, wrap, key)]
                for f, w in want.items():
                    if isinstance(w, str):
                        ok = got[f] == w
                    else:
                        ok = abs(got[f] - w) <= ICI_RTOL * abs(w)
                        if w:
                            worst = max(worst, abs(got[f] / w - 1))
                    if not ok:
                        fail(f"phase 23: {rows}x{rows} wrap={wrap} {key} "
                             f"{f} is {got[f]} on the card, {w} on the host")
        elif task[0] == "rank":
            got = ranked[task[1]]
            if [r["rules"] for r in got] != [r["rules"] for r in out]:
                fail(f"phase 23: {task[1]}'s layouts rank "
                     f"{[r['rules'] for r in got]} on the card, "
                     f"{[r['rules'] for r in out]} on the host")
            for g, w in zip(got, out):
                if abs(g["total_s"] / w["total_s"] - 1) > ICI_RTOL:
                    fail(f"phase 23: {task[1]} {g['rules']} totals "
                         f"{g['total_s']} on the card, {w['total_s']} on "
                         f"the host")
                worst = max(worst, abs(g["total_s"] / w["total_s"] - 1))
        elif task[0] == "ideal":
            ideal[task[1:]] = out
        else:
            records.append(dict(out, cell_s=secs))
    cells = {}
    for r in records:
        name = f"{r['arch']}/{r['shape']}/{r['mesh']}/" \
               f"{r.get('variant', 'baseline')}"
        if r["skipped"]:
            if "full-attention" not in r["reason"]:
                fail(f"phase 23: {r['arch']} {r['shape']} skipped: "
                     f"{r['reason']}")
            cells[name] = None
            continue
        vals = [r["flops_per_device"], r["bytes_per_device"],
                r["collective_bytes_per_device"],
                r["memory"]["argument_bytes"], r["memory"]["temp_bytes"]]
        if not all(np.isfinite(v) and v > 0 for v in vals):
            fail(f"phase 23: the dry-run record of {r['arch']} {r['shape']} "
                 f"{r['mesh']} {r['variant']} is not sane: {vals}")
        # the rank's FLOPs against an ideal split of one device's
        whole = ideal[(r["arch"], r["shape"],
                       ideal_variant(r["arch"], r["variant"]))]
        cells[name] = {
            "cell_s": r["cell_s"], "lower_s": r["lower_s"],
            "flops_per_device": r["flops_per_device"],
            "ideal_ratio": r["flops_per_device"] / (whole / r["n_devices"]),
            "temp_bytes": r["memory"]["temp_bytes"],
            "collective_op_counts": r["collective_op_counts"],
            "collective_breakdown": r["collective_breakdown"]}
        if r["shape"] == "long_500k":
            _long_context_held(r, cells[name])
        if (r["arch"], r["shape"], r["mesh"], r["variant"]) == (
                MOE_DECODE_ARCH, "decode_32k", "16x16", "baseline"):
            _moe_decode_held(cells[name])
    for name, c in sorted(cells.items()):
        if c is None:
            continue
        log(f"phase 23: rank 0 of {name}: {c['flops_per_device']:.4g} "
            f"FLOPs, {c['ideal_ratio']:.4f} x the ideal split, temp "
            f"{c['temp_bytes'] / 2**30:.3f} GiB, collectives " + ", ".join(
                f"{k} {n} ({c['collective_breakdown'][k] / 2**30:.4g} GiB)"
                for k, n in c["collective_op_counts"].items() if n) +
            f" ({c['cell_s']:.1f} s)")
    rec.update(
        estimates_on_card=calls, max_rel_err_vs_host=worst,
        rankings={a: [r["rules"] for r in v] for a, v in ranked.items()},
        dryrun_cells=cells, host_task_s=task_s)
    log(f"phase 23: {len(records)} dry-run records (rank 0 of each mesh) on "
        f"{DRYRUN_WORKERS} host workers ({sum(task_s.values()):.1f} s of "
        f"host work, {rec['host_wait_s']:.1f} s waited after the card's "
        f"part); every estimate and ranking within {worst:.3g} of the "
        f"host's; rankings {rec['rankings']} ({card})")
    return rec


def population_sharding_path(torch, dev, zero_counts, read_counts,
                             points) -> dict:
    """Phase 24: population sharding. Engines over ``[dev] * k`` (and over
    every visible card where there are several) run every genome path,
    the fault grid, the sweep, NSGA-II and a co-batched service round, each
    held bit-equal to the one-shard engine on the card and, for the genome
    metrics, within rtol 1e-5 of the CPU. Returns the phase's record."""
    from repro_torch.dse import DseEngine
    from repro_torch.faults.model import iid_link_faults, single_chiplet_faults
    from repro_torch.opt import (AdjacencySpace, Budgets, ParametricSpace,
                                 PopulationEvaluator)
    from repro_torch.opt.runner import make_optimizer
    from repro_torch.serve import (JobSpec, SearchService, front_json_bytes,
                                   run_spec_solo)

    lists = {f"{k}x{dev}": [dev] * k for k in SHARD_COUNTS}
    if torch.cuda.device_count() > 1:
        lists["every_card"] = [torch.device("cuda", i)
                               for i in range(torch.cuda.device_count())]
    one, cpu = DseEngine(devices=[dev]), DseEngine(device="cpu")
    engines = {key: DseEngine(devices=ds) for key, ds in lists.items()}
    reports = ("total_chiplet_area", "interposer_area", "power", "cost",
               "reachable_fraction")

    def same(what, got, want, fields):
        for f in fields:
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                fail(f"phase 24: {what}: {f} differs from one shard")
        for f in reports:
            if not np.array_equal(getattr(got.reports, f),
                                  getattr(want.reports, f)):
                fail(f"phase 24: {what}: report {f} differs from one shard")

    def near_cpu(what, got, want, fields):
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if not np.all(np.isfinite(g)):
                fail(f"phase 24: {what}: non-finite {f}")
            if not np.allclose(g, w, rtol=RTOL, atol=0.0):
                fail(f"phase 24: {what}: {f} differs from the CPU run by "
                     f"{np.max(np.abs(g - w))}")

    # the inputs, and the one-shard and CPU runs they are held against
    genome_runs = {}
    for key, n, size in SHARD_GENOMES:
        if n is None:
            space = ParametricSpace(topologies=("mesh", "torus"),
                                    chiplet_counts=(9, 16))
            pop = space.repair(np.random.default_rng(1).integers(
                0, 8, (size, 4)))
        else:
            space = AdjacencySpace(n_chiplets=n,
                                   max_degree=4 if n == 12 else 8)
            pop = space.sample(np.random.default_rng(n), size)
        want = one.evaluate_genomes(space, pop)
        near_cpu(key, want, cpu.evaluate_genomes(space, pop),
                 ("latency", "throughput"))
        genome_runs[key] = (space, pop, want)
    n, degree = FAULT_SPACE
    fspace = AdjacencySpace(n_chiplets=n, max_degree=degree)
    fpop = fspace.sample(np.random.default_rng(11), FAULT_POP)
    scen = {"F=8": iid_link_faults(fspace, p=0.05, n_scenarios=7, seed=0),
            "chiplets": single_chiplet_faults(fspace)}

    def grid(engine, sc):
        return engine.evaluate_genomes_faults_async(
            fspace, fpop, sc.link_fail, sc.node_fail).result()

    grid_fields = ("latency", "throughput", "reachable_fraction")
    fault_runs = {}
    for key, sc in scen.items():
        fault_runs[key] = grid(one, sc)
        near_cpu(f"faults {key}", fault_runs[key], grid(cpu, sc),
                 grid_fields)
    sweep_one = DseEngine(devices=[dev], chunk_size=60).run(points)

    ospace = AdjacencySpace(n_chiplets=SHARD_OPT["n_chiplets"],
                            max_degree=SHARD_OPT["max_degree"])

    def nsga(engine):
        ev = PopulationEvaluator(ospace, engine=engine,
                                 budgets=Budgets(max_interposer_area=2500.0))
        opt = make_optimizer("nsga2", ospace, ev, seed=SHARD_OPT["seed"],
                             pop_size=SHARD_OPT["pop_size"])
        for _ in range(SHARD_OPT["generations"]):
            opt.step()
        return opt.archive.to_dicts(), opt.state(), ev.n_evals

    nsga_one = nsga(one)
    specs = [_serve_spec(JobSpec, 500 + i, SERVE_SPACE, 4)
             for i in range(SHARD_JOBS)]
    solos = [run_spec_solo(spec, devices=[dev]) for spec in specs]

    # the main path, counted: n = 256 on its own (B2's tier), the rest
    sharded = {}
    zero_counts()
    for key, engine in engines.items():
        space, pop, _ = genome_runs["adjacency_256"]
        sharded[(key, "adjacency_256")] = engine.evaluate_genomes(space, pop)
    counts_256 = read_counts("sharding_adjacency_256",
                             ("load_propagate", "minplus"))
    zero_counts()
    t0 = time.perf_counter()
    for key, engine in engines.items():
        for gkey, (space, pop, _) in genome_runs.items():
            if gkey != "adjacency_256":
                sharded[(key, gkey)] = engine.evaluate_genomes(space, pop)
        for skey, sc in scen.items():
            sharded[(key, f"faults {skey}")] = grid(engine, sc)
    sweep_four = DseEngine(devices=[dev] * 4, chunk_size=60).run(points)
    nsga_four = nsga(engines[f"4x{dev}"])
    with SearchService(devices=[dev] * 4) as svc:
        for spec in specs:
            svc.submit(spec)
        jobs = [svc.wait(spec.job_id, 600) for spec in specs]
    counts = read_counts("sharding", ("load_propagate", "minplus"))
    main_s = time.perf_counter() - t0

    for (key, what), got in sharded.items():
        if what.startswith("faults"):
            same(f"{key} {what}", got, fault_runs[what.split()[1]],
                 grid_fields)
        else:
            same(f"{key} {what}", got, genome_runs[what][2],
                 ("latency", "throughput"))
    if not (np.array_equal(sweep_four.latency, sweep_one.latency)
            and np.array_equal(sweep_four.throughput, sweep_one.throughput)):
        fail("phase 24: the sweep on 4 shards differs from one shard")
    if nsga_four != nsga_one:
        fail("phase 24: NSGA-II on 4 shards differs from one shard")
    for job, (opt, rows) in zip(jobs, solos):
        if not (job.status == "done"
                and front_json_bytes(job.result_rows)
                == front_json_bytes(rows)
                and job.n_evals == opt.evaluator.n_evals
                and job.optimizer.state() == opt.state()):
            fail(f"phase 24: {job.job_id} co-batched over 4 shards differs "
                 f"from its solo run")

    # evals/s and the device idle share at 1, 2 and 4 shards
    space, pop, _ = genome_runs["adjacency_32"]
    rates = {}
    for k, engine in ((1, one), *((k, engines[f"{k}x{dev}"])
                                  for k in SHARD_COUNTS)):
        engine.evaluate_genomes(space, pop)
        torch.cuda.synchronize()
        times = []
        for _ in range(SHARD_RATE_REPS):
            t1 = time.perf_counter()
            engine.evaluate_genomes(space, pop)
            times.append(time.perf_counter() - t1)
        wall_s, busy_s, _ = profile_device(
            torch, lambda e=engine: e.evaluate_genomes(space, pop))
        rates[k] = {"s_per_call": statistics.median(times),
                    "evals_per_s": len(pop) / statistics.median(times),
                    "profiled_wall_s": wall_s, "device_busy_s": busy_s,
                    "device_idle_share": 1.0 - busy_s / wall_s}
    b1 = counts["load_propagate"]
    log(f"phase 24: shard lists {list(lists)}: every genome path, the fault "
        f"grid, the sweep, NSGA-II and a 4-job service round bit-equal to "
        f"one shard, genome metrics within rtol {RTOL} of the CPU; launches "
        f"B1 {b1}, B2 {counts_256['load_propagate']}, B5 "
        f"{counts['minplus'] + counts_256['minplus']}; AdjacencySpace(32, 8) "
        f"at 24: " + ", ".join(f"k={k} {r['evals_per_s']:.1f} evals/s idle "
                               f"{r['device_idle_share']:.4f}"
                               for k, r in rates.items()))
    return {"shard_lists": {k: [str(d) for d in v] for k, v in lists.items()},
            "launches": {"B1": b1, "B2": counts_256["load_propagate"],
                         "B5": counts["minplus"] + counts_256["minplus"]},
            "main_path_s": main_s, "adjacency_32_pop_24": rates}


def _mesh_model(torch, dev, mesh, seed: int = 0):
    """Phase 25's hymba at published widths cut to ``MESH_LAYERS`` (remat
    "full", the scan kernels), its parameters placed on ``mesh`` (None: one
    device), its AdamW state and its step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_state
    from repro_torch.models import Model
    from repro_torch.sharding.rules import distribute_params
    from repro_torch.train import OptConfig, make_train_step, place_train_state

    cfg = get_config(MESH_ARCH).replace(n_layers=MESH_LAYERS, remat="full",
                                        ssm_kernel=True)
    # under a mesh drawn on the host, as the launcher does: each rank moves
    # only its shards to the card
    model = Model(cfg, seed=seed, device=dev if mesh is None else "cpu")
    if mesh is not None:
        distribute_params(model, mesh)
    state = build_state(model, "adamw")
    if mesh is not None:
        state = place_train_state(state, mesh)
    ocfg = OptConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                     decay_steps=MESH_STEPS)
    return model, state, make_train_step(model, ocfg, "adamw")


def _mesh_batches(torch, dev, cfg, steps: int = MESH_STEPS) -> list:
    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import to_device
    source = make_pipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    return [to_device(source.batch_at(i), dev) for i in range(steps)]


def _mesh_steps(torch, state, step, batches, mesh, comm_on_last=False,
                count_first=None):
    """``MESH_STEPS`` steps; returns (state, [(loss, grad_norm)], step
    seconds, the collectives of the last step by kind or None). With
    ``count_first`` (a dict) the first step, whose time no rate uses, runs
    under the dry-run's counters (``launch.dryrun.trace_counts``) and its
    FLOPs and collectives go into ``count_first``."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.dryrun import trace_counts
    from repro_torch.sharding.rules import distribute_batch
    metrics, secs, comms = [], [], None
    for i, b in enumerate(batches):
        if mesh is not None:
            b = distribute_batch(b, mesh)
        counting = comm_on_last and i == len(batches) - 1
        mode = CommDebugMode() if counting else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode is not None:
            with mode:
                state, m = step(state, b)
            comms = {str(k).rsplit(".", 1)[-1]: v
                     for k, v in mode.get_comm_counts().items()}
        elif count_first is not None and i == 0:
            out = {}
            count_first.update(_count_summary(trace_counts(
                lambda: out.update(zip(("state", "m"), step(state, b))),
                (state, b))))
            state, m = out["state"], out["m"]
        else:
            state, m = step(state, b)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return state, metrics, secs, comms


def _local_bytes(tree) -> int:
    """This rank's bytes of a tree of tensors (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


def _against_world1(torch, dist, state, ref_path: str, mesh, dev,
                    world: int, extra: dict) -> tuple:
    """A meshed run's state against world 1's after the same steps (its
    file mapped, not read whole), each rank on its own shards: the largest
    parameter difference over every rank, each first-moment leaf's
    [relative L2 difference, relative difference of the norms] (from each
    rank's sums of squares, a replicated shard counted once), and every
    rank's record (``extra`` with its bytes of parameters and optimizer
    state added). Returns (worst, moment, per_rank)."""
    from repro_torch.sharding.spmd import local_shard, replicas
    ref = torch.load(ref_path, map_location="cpu", mmap=True)
    worst, sums = 0.0, {}
    for k, p in state["params"].items():
        m = state["opt"]["m"][k]
        want = local_shard(ref["params"][k], mesh, p.placements)
        worst = max(worst, (p.to_local().float() - want.to(dev).float())
                    .abs().max().item())
        want = local_shard(ref["m"][k], mesh, m.placements).to(dev).double()
        got = m.to_local().double()
        sums[k] = [(((got - want) ** 2).sum() / replicas(m)).item(),
                   ((want ** 2).sum() / replicas(m)).item(),
                   ((got ** 2).sum() / replicas(m)).item()]
    del ref
    per_rank = [None] * world
    dist.all_gather_object(per_rank, dict(
        extra, param_bytes=_local_bytes(dict(state["params"])),
        opt_bytes=_local_bytes(state["opt"]), device=str(dev),
        max_param_diff=worst, moment_sums=sums))
    worst = max(r["max_param_diff"] for r in per_rank)
    moment = {}
    for k in sums:
        d2, r2, g2 = (sum(r["moment_sums"][k][i] for r in per_rank)
                      for i in range(3))
        scale = max(r2, 1e-60) ** 0.5
        moment[k] = [d2 ** 0.5 / scale, abs(g2 ** 0.5 / scale - 1)]
    for r in per_rank:
        del r["moment_sums"]
    return worst, moment, per_rank


def _gqa_cfg():
    """``GQA_ARCH`` at its published widths cut to ``GQA_LAYERS`` (its own
    dtype and remat: bf16, "full")."""
    from repro_torch.configs import get_config
    return get_config(GQA_ARCH).replace(n_layers=GQA_LAYERS)


def _mapped_mesh_model(torch, dev, mesh, path: str, cfg):
    """Phase 25's model of ``cfg`` (``_moe_cfg``, ``_gqa_cfg``) from the
    shared host file: placed on ``mesh`` (each rank reading only its
    shards), its AdamW state placed like it, and its step."""
    from repro_torch.launch.train import build_state
    from repro_torch.sharding.rules import distribute_params
    from repro_torch.train import OptConfig, make_train_step, place_train_state
    model = distribute_params(_model_from_host_file(torch, cfg, path), mesh)
    state = place_train_state(build_state(model, "adamw"), mesh)
    ocfg = OptConfig(learning_rate=TRAIN_LR, warmup_steps=0,
                     decay_steps=MESH_STEPS)
    return model, state, make_train_step(model, ocfg, "adamw")


def mesh_rank_main(rank: int, world: int, port: int, workdir: str,
                   backend: str) -> None:
    """One rank of phase 25's meshed world (``python3 chip_smoke.py
    --mesh-rank R --mesh-world W --mesh-port P --mesh-dir D --mesh-backend
    B``): with NCCL a card each, with gloo every rank on ``cuda:0``; the
    (2, 2) mesh at four ranks and (1, 2) at two; the world-1 run's steps
    on its shards once world 1's results are in ``workdir``, the
    context-parallel branch and the scan once a shard counted, the
    parameters and first moments held against world 1's shard by shard,
    B7 / B8 held against their plain versions and timed at the shard's
    shape; rank 0 writes ``result.json`` under ``workdir``."""
    import faulthandler

    import torch
    import torch.distributed as dist
    faulthandler.enable()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.models.layers as L
    import repro_torch.models.ssm as S
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.mesh import make_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    try:
        sizes = _world_mesh(world)
        mesh = make_device_mesh(sizes)
        seen = {"cp": 0, "scan": []}
        real_cp, real_scan = L._context_parallel_flash, S.selective_scan

        def cp(*a, **k):
            seen["cp"] += 1
            return real_cp(*a, **k)

        def scan(*a):
            seen["scan"].append([list(t.shape) for t in a[:5]])
            seen["args"] = a
            return real_scan(*a)

        L._context_parallel_flash, S.selective_scan = cp, scan
        t0 = time.perf_counter()
        model, state, step = _mesh_model(torch, dev, mesh)
        build_s = time.perf_counter() - t0
        batches = _mesh_batches(torch, dev, model.cfg)
        # built while the parent runs world 1; the steps wait for its
        # results, so the two runs do not share the card's time
        go = os.path.join(workdir, "go")
        deadline = time.monotonic() + MESH_WORLD_TIMEOUT
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise TimeoutError("world 1's results never came")
            time.sleep(0.05)
        ss.selective_scan_fwd_cuda.launches = 0
        ss.selective_scan_bwd_cuda.launches = 0
        state, metrics, secs, comms = _mesh_steps(
            torch, state, step, batches, mesh, comm_on_last=True)
        launches = {"selective_scan_fwd": ss.selective_scan_fwd_cuda.launches,
                    "selective_scan_bwd": ss.selective_scan_bwd_cuda.launches}
        t0 = time.perf_counter()
        worst, moment, per_rank = _against_world1(
            torch, dist, state, os.path.join(workdir, "world1.pt"), mesh,
            dev, world, {"launches": launches, "cp_calls": seen["cp"],
                         "scan_shapes": seen["scan"][:1]})
        compare_s = time.perf_counter() - t0
        if rank == 0:
            t0 = time.perf_counter()
            # B7 and B8 at this rank's shard of one layer's scan
            *ops_, chunk = seen["args"]
            xc, dt, bm, cm, a, h0 = (t.detach().contiguous() for t in ops_)
            dy = torch.randn_like(xc)
            fwd = lambda: ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0,
                                                     chunk=chunk)
            _, ckpt, _ = fwd()
            bwd = lambda: ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt,
                                                     dy, chunk=chunk)
            # the kernels against their plain versions on the shard (each
            # plain version timed in the one call that gives its result)
            plain = {}
            plain_ms = {
                "fwd": time_cuda(torch, lambda: plain.__setitem__(
                    "fwd", ss.selective_scan_fwd_plain(
                        xc, dt, bm, cm, a, h0, chunk=chunk)),
                    reps=1, warmup=0),
                "bwd": time_cuda(torch, lambda: plain.__setitem__(
                    "bwd", ss.selective_scan_bwd_plain(
                        xc, dt, bm, cm, a, ckpt, dy, chunk=chunk)),
                    reps=1, warmup=0)}
            held = {w: (max((g.float() - e.float()).abs().max().item()
                            for g, e in zip(got, plain[w])),
                        all(torch.allclose(g, e, **tol)
                            for g, e in zip(got, plain[w])))
                    for w, got, tol in (("fwd", fwd(), SCAN_FWD_TOL),
                                        ("bwd", bwd(), SCAN_BWD_TOL))}
            del plain
            B, S_, Di = xc.shape
            fb, bb = scan_bounds(B, S_, Di, a.shape[1], chunk,
                                 max_sm_clock_hz())
            shard = {"shape": [B, S_, Di, a.shape[1]], "chunk": chunk,
                     "fwd_ms": time_cuda(torch, fwd),
                     "fwd_device_ms": kernel_device_ms(torch, fwd, "ssm_fwd",
                                                       1),
                     "fwd_bound_ms": fb["bound_ms"],
                     "fwd_bound_by": fb["bound_by"],
                     "bwd_ms": time_cuda(torch, bwd),
                     "bwd_device_ms": call_device_ms(
                         torch, bwd, SCAN_BWD_KERNELS)["device_ms"],
                     "bwd_bound_ms": bb["bound_ms"],
                     "bwd_bound_by": bb["bound_by"],
                     "fwd_plain_ms": plain_ms["fwd"],
                     "bwd_plain_ms": plain_ms["bwd"],
                     "fwd_max_abs_err": held["fwd"][0],
                     "bwd_max_abs_err": held["bwd"][0],
                     "held": held["fwd"][1] and held["bwd"][1]}
            step_s = statistics.median(secs[1:]) if len(secs) > 1 \
                else secs[0]
            rec = {"world": world, "mesh": list(sizes), "backend": backend,
                   "cards": len({r["device"] for r in per_rank}),
                   "card": card_line(),
                   "build_s": build_s, "metrics": metrics,
                   "step_ms": [s * 1e3 for s in secs],
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
                   "comms_last_step": comms, "max_param_diff": worst,
                   "moment_rel_diff": moment, "compare_s": compare_s,
                   "scan_shard_s": time.perf_counter() - t0,
                   "per_rank": per_rank, "scan_shard": shard}
        # every rank waits for rank 0's timings (a collective on the card:
        # gloo's barrier picks a device by rank)
        dist.all_reduce(torch.zeros(1, device=dev))
        del model, state, step, batches
        torch.cuda.empty_cache()
        # MOE_ARCH: MLA's heads, the experts and the vocabulary split over
        # "model", from the parent's host file, against its world 1
        t0 = time.perf_counter()
        with open(os.path.join(workdir, "host_files.json")) as f:
            path = json.load(f)[MOE_ARCH]
        model, state, step = _mapped_mesh_model(torch, dev, mesh, path,
                                                _moe_cfg())
        batches = _mesh_batches(torch, dev, model.cfg)
        moe_build_s = time.perf_counter() - t0
        # rank 0 counts its first step as the dry-run does (its FLOPs and
        # collectives; the parent holds them to the meta count)
        card_count = {} if rank == 0 else None
        state, metrics, secs, comms = _mesh_steps(
            torch, state, step, batches, mesh, comm_on_last=True,
            count_first=card_count)
        t0 = time.perf_counter()
        worst, moment, per_rank = _against_world1(
            torch, dist, state, os.path.join(workdir,
                                             f"world1_{MOE_ARCH}.pt"),
            mesh, dev, world, {"experts_a_rank": model.blocks[-1].mlp.wi
                               .to_local().shape[0]})
        compare_s = time.perf_counter() - t0
        if rank == 0:
            step_s = statistics.median(secs[1:]) if len(secs) > 1 \
                else secs[0]
            rec["moe"] = {"arch": MOE_ARCH, "build_s": moe_build_s,
                          "metrics": metrics,
                          "step_ms": [s * 1e3 for s in secs],
                          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
                          "comms_last_step": comms, "max_param_diff": worst,
                          "moment_rel_diff": moment,
                          "compare_s": compare_s, "per_rank": per_rank,
                          "card_count": card_count}
        dist.all_reduce(torch.zeros(1, device=dev))
        del model, state, step, batches
        torch.cuda.empty_cache()
        # the card is free of the ranks' models: the parent runs GQA_ARCH's
        # world 1 now
        dist.all_reduce(torch.zeros(1, device=dev))
        if rank == 0:
            open(os.path.join(workdir, "moe_done"), "w").close()
        # GQA_ARCH on (1, world): at four ranks the query heads split, K and
        # V projected whole on each rank, against world 1 (its file comes
        # once the parent's world-1 run is done)
        go = os.path.join(workdir, "gqa_go")
        deadline = time.monotonic() + MESH_WORLD_TIMEOUT
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise TimeoutError("world 1's GQA_ARCH results never came")
            time.sleep(0.05)
        with open(go) as f:
            path = json.load(f)[GQA_ARCH]
        t0 = time.perf_counter()
        gqa_mesh = make_device_mesh((1, world))
        model, state, step = _mapped_mesh_model(torch, dev, gqa_mesh, path,
                                                _gqa_cfg())
        batches = _mesh_batches(torch, dev, model.cfg, GQA_STEPS)
        gqa_build_s = time.perf_counter() - t0
        seen["queries"] = 0
        real_queries = L.split_queries

        def queries(*a, **k):
            seen["queries"] += 1
            return real_queries(*a, **k)

        L.split_queries = queries
        state, metrics, secs, comms = _mesh_steps(
            torch, state, step, batches, gqa_mesh, comm_on_last=True)
        L.split_queries = real_queries
        t0 = time.perf_counter()
        worst, moment, per_rank = _against_world1(
            torch, dist, state, os.path.join(workdir,
                                             f"world1_{GQA_ARCH}.pt"),
            gqa_mesh, dev, world, {"queries_calls": seen["queries"]})
        compare_s = time.perf_counter() - t0
        if rank == 0:
            rec["gqa"] = {"arch": GQA_ARCH, "mesh": [1, world],
                          "build_s": gqa_build_s, "metrics": metrics,
                          "step_ms": [s * 1e3 for s in secs],
                          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ /
                          statistics.median(secs),
                          "comms_last_step": comms, "max_param_diff": worst,
                          "moment_rel_diff": moment,
                          "compare_s": compare_s, "per_rank": per_rank}
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump(rec, f)
        dist.all_reduce(torch.zeros(1, device=dev))
    finally:
        dist.destroy_process_group()


def _count_summary(counts: dict) -> dict:
    """A rank's FLOPs and collectives of ``launch.dryrun.trace_counts``'
    counts: "flops", and "ops/<kind>/<group size>" and
    "coll/<kind>/<group size>" (result bytes)."""
    return {k: v for k, v in counts.items()
            if k == "flops" or k.startswith(("ops/", "coll/"))}


def meta_rank_count(sizes, kind: str) -> dict:
    """The dry-run's meta count of rank 0 of a ``sizes`` ("data", "model")
    mesh (``launch.mesh.counting_world``) running a step as phases 25 and
    26 run it on the card: ``MOE_ARCH``'s train step of ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` under ``DEFAULT_RULES`` (``_moe_cfg``), ("<rule
    set>:<arch>") the decode step of ``arch`` (float32, ``_serve_cfg``)
    under that rule set of ``SERVE_BATCH`` rows (1 under
    ``LONG_CONTEXT_RULES``) at the last position of a cache of
    ``SERVE_PROMPT + SERVE_MESH_NEW`` slots, ("longprefill:<arch>") the
    prefill
    of 1 x ``PREFILL_SEQ`` there (the sequence split over "data"), or
    ("prefill") qwen2.5-3b's ``SERVING_RULES`` prefill of
    ``PREFILL_BATCH`` x ``PREFILL_SEQ`` (``_serve_cfg``, float32; its
    query heads split, K and V whole). Runs
    in a spawned host process: a rank of a meshed world has its process
    group, and a count needs a process without one."""
    if os.path.join(ROOT, "src") not in sys.path:
        sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import counting_world
    from repro_torch.models import ShapeSpec
    from repro_torch.sharding import MeshShape
    t0 = time.perf_counter()
    if kind == "train":
        cfg, rules = _moe_cfg(), _serve_rule_sets()["default"]
        spec = ShapeSpec("card_count", TRAIN_SEQ, TRAIN_BATCH, "train")
    elif kind == "prefill":
        cfg = _serve_cfg("qwen2.5-3b", "float32")
        rules = _serve_rule_sets()["serving"]
        spec = ShapeSpec("card_count", PREFILL_SEQ, PREFILL_BATCH, "prefill")
    elif kind.startswith("longprefill:"):
        cfg = _serve_cfg(kind[len("longprefill:"):], "float32")
        rules = _serve_rule_sets()["long"]
        spec = ShapeSpec("card_count", PREFILL_SEQ, 1, "prefill")
    else:
        rules_name, arch = kind.split(":")
        cfg = _serve_cfg(arch, "float32")
        rules = _serve_rule_sets()[rules_name]
        spec = ShapeSpec("card_count", SERVE_PROMPT + SERVE_MESH_NEW,
                         1 if rules_name == "long" else SERVE_BATCH,
                         "decode")
    with counting_world(MeshShape(("data", "model"), tuple(sizes))) as mesh:
        counts = D.trace_counts(*D.step_program(cfg, spec, mesh=mesh,
                                                rules=rules))
    return dict(_count_summary(counts), count_s=time.perf_counter() - t0)


def _start_meta_count(sizes, *kinds: str):
    """(pool, [pending result of each kind]) of ``meta_rank_count`` in one
    spawned host process, which runs while the meshed world does."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(1)
    return pool, [pool.apply_async(meta_rank_count, (tuple(sizes), kind))
                  for kind in kinds]


def _hold_count(phase: int, what: str, card: dict, pending) -> dict:
    """Rank 0's count of ``what`` on the card against the dry-run's meta
    count of the same rank, step and mesh: the FLOPs and each collective's
    count and result bytes by kind and group size exactly, or the run
    fails. Returns both and the meta count's seconds."""
    meta = dict(pending.get(timeout=MESH_WORLD_TIMEOUT))
    secs = meta.pop("count_s")
    diff = {k: (card.get(k), meta.get(k)) for k in sorted(set(card) |
                                                           set(meta))
            if card.get(k) != meta.get(k)}
    if diff:
        fail(f"phase {phase}: rank 0's count of {what} on the card differs "
             f"from the dry-run's meta count (card, meta): {diff}")
    log(f"phase {phase}: rank 0's count of {what} on the card equals the "
        f"dry-run's meta count: {card['flops']:.6g} FLOPs, " + ", ".join(
            f"{k[4:]} {v} ({card['coll/' + k[4:]]} bytes)"
            for k, v in card.items() if k.startswith("ops/")) +
        f" (meta count {secs:.1f} s on the host)")
    return {"card": card, "meta_count_s": secs}


def _in_scratch_world(phase, torch, dev, zero_counts, read_counts) -> dict:
    """A meshed phase (``_mesh_training``, ``_mesh_serving``) in a scratch
    directory under ``build/``; every rank process it starts is stopped and
    the directory removed however it ends."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    procs: list = []
    try:
        return phase(torch, dev, zero_counts, read_counts, work, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def mesh_training_path(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 25 (``_mesh_training``)."""
    return _in_scratch_world(_mesh_training, torch, dev, zero_counts,
                             read_counts)


def _mesh_training(torch, dev, zero_counts, read_counts, work: str,
                   procs: list) -> dict:
    """Phase 25: sharded training over a ``torch.distributed`` device mesh.
    (a) An NCCL world of 1 and a (1, 1) ("data", "model") ``DeviceMesh`` on
    the card: hymba-1.5b at its published widths cut to ``MESH_LAYERS``,
    ``MESH_STEPS`` AdamW steps at 2 x 2048 under the mesh (parameters by
    ``distribute_params``, the state by ``place_train_state``, each batch
    by ``distribute_batch``, the meshed step) against the same steps
    without one: losses, gradient norms and every parameter within
    ``MESH_TOL``; B7 / B8 launched exactly as remat predicts in each. (b)
    The meshed state saved and restored with ``shardings`` into a fresh
    meshed state, bit-equal. (c) A meshed world: on one card four gloo
    ranks on ``cuda:0`` in a (2, 2) mesh (gloo takes CUDA tensors in every
    collective the step uses; NCCL takes one rank a card), on several
    cards NCCL ranks, a card each ((2, 2) at four, (1, 2) at two or
    three), started with the phase to build while (a) runs and stepping
    once (a) is done; the same steps against world 1 (the loss and
    gradient norm within ``MESH_CARDS_RTOL``, each leaf of AdamW's first
    moment within ``MESH_MOMENT_RTOL`` / ``MESH_MOMENT_NORM_RTOL``), the
    context-parallel branch taken, the scan launched once a shard, and B7 /
    B8 on a shard held against their plain versions. (d) ``MOE_ARCH`` in
    world 1 and in the same world, held by (c)'s gates, rank 0's count of
    its first step held to the dry-run's meta count. (e) ``GQA_ARCH`` in
    world 1 and on a (1, W) mesh of the same W ranks (at four, the
    query-split attention on every rank), held by (c)'s gates. Returns the
    phase's record."""
    import torch.distributed as dist
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding.spmd import full_value
    from repro_torch.train import train_state_shardings

    rec = {"card": card_line()}
    torch.cuda.set_device(dev)
    # the earlier phases' cached blocks go back to the card, which the
    # meshed world's ranks share
    torch.cuda.empty_cache()
    # (c)'s ranks start now and build their models while (a) runs; they
    # take their steps once (a)'s results are written
    world, backend = _start_mesh_world(torch, work, procs)
    # the dry-run's count of the step rank 0 counts on the card
    count_pool, (meta_count,) = _start_meta_count(_world_mesh(world),
                                                  "train")
    procs.append(_PoolStopper(count_pool))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_device_mesh((1, 1))
        runs = {}
        for path, on in (("mesh_train_one_device", None),
                         ("mesh_train_world1", mesh)):
            t0 = time.perf_counter()
            model, state, step = _mesh_model(torch, dev, on)
            batches = _mesh_batches(torch, dev, model.cfg)
            zero_counts()
            state, metrics, secs, _ = _mesh_steps(torch, state, step,
                                                  batches, on)
            counts = read_counts(path, ("selective_scan_fwd",
                                        "selective_scan_bwd"))
            want = scan_launches(model.cfg, MESH_STEPS)
            if {k: counts[k] for k in want} != want:
                fail(f"phase 25: {path} launched {counts}; remat predicts "
                     f"{want}")
            runs[path] = (state, metrics, secs, time.perf_counter() - t0)
        (s1, m1, t1, w1), (s2, m2, t2, w2) = runs.values()
        worst = max((full_value(s2["params"][k]).float() - p.detach().float())
                    .abs().max().item() for k, p in s1["params"].items())
        close = all(torch.allclose(full_value(s2["params"][k]), p.detach(),
                                   **MESH_TOL)
                    for k, p in s1["params"].items())
        metric_ok = all(abs(a - b) <= MESH_TOL["atol"] +
                        MESH_TOL["rtol"] * abs(b)
                        for x, y in zip(m2, m1) for a, b in zip(x, y))
        rec.update(world1_param_bytes=_local_bytes(dict(s2["params"])),
                   one_device=m1, world1=m2, max_param_diff=worst,
                   bit_equal=worst == 0.0 and m1 == m2,
                   step_ms_one_device=[s * 1e3 for s in t1],
                   step_ms_world1=[s * 1e3 for s in t2],
                   launches=scan_launches(model.cfg, MESH_STEPS))
        log(f"phase 25: world 1 against one device: losses / grad norms "
            f"{m2} vs {m1}, largest parameter difference {worst}, step ms "
            f"{[round(s * 1e3, 1) for s in t2]} vs "
            f"{[round(s * 1e3, 1) for s in t1]}")
        if not (close and metric_ok):
            fail(f"phase 25: the (1, 1) mesh's steps differ from one "
                 f"device's past {MESH_TOL} (largest parameter difference "
                 f"{worst}; {m2} vs {m1})")
        torch.save({"params": {k: full_value(p).cpu()
                               for k, p in s2["params"].items()},
                    "m": {k: full_value(m).cpu()
                          for k, m in s2["opt"]["m"].items()}},
                   os.path.join(work, "world1.pt"))
        rec["moe_world1"] = _mapped_world1(
            torch, dev, mesh, work, MOE_ARCH, _moe_cfg(), MESH_STEPS,
            _drawn_for_ranks(torch, MOE_ARCH, _moe_cfg()))
        with open(os.path.join(work, "host_files.json"), "w") as f:
            json.dump({MOE_ARCH: rec["moe_world1"]["host_file"]}, f)
        # (c) takes its steps while (b) saves and restores (host I/O)
        open(os.path.join(work, "go"), "w").close()
        # (b) the checkpoint under the mesh
        t0 = time.perf_counter()
        save_checkpoint(work, MESH_STEPS, s2)
        save_s = time.perf_counter() - t0
        _, fresh, _ = _mesh_model(torch, dev, mesh, seed=1)
        t0 = time.perf_counter()
        back, _ = restore_checkpoint(work, fresh, shardings=
                                     train_state_shardings(fresh, mesh))
        restore_s = time.perf_counter() - t0
        leaves = [(s2["params"], back["params"]),
                  (s2["opt"]["m"], back["opt"]["m"]),
                  (s2["opt"]["v"], back["opt"]["v"])]
        if not all(torch.equal(full_value(a[k]), full_value(b[k]))
                   for a, b in leaves for k in a) or \
                back["step"] != s2["step"]:
            fail("phase 25: the state restored onto the mesh differs from "
                 "the one saved under it")
        rec.update(ckpt_save_s=save_s, ckpt_restore_s=restore_s)
        log(f"phase 25: checkpoint under the mesh saved in {save_s:.1f} s, "
            f"restored with shardings bit-equal in {restore_s:.1f} s")
        del runs, s1, s2, back, fresh
        torch.cuda.empty_cache()
        # (e) GQA_ARCH's weights drawn on the host while the ranks run (c)
        # and (d), its world-1 step once they have let go of the card (the
        # card holds one run at a time); they take theirs once its file is
        # named
        drawn = _drawn_for_ranks(torch, GQA_ARCH, _gqa_cfg())
        _await_ranks(os.path.join(work, "moe_done"), procs,
                     f"the end of its {MOE_ARCH} steps")
        rec["gqa_world1"] = _mapped_world1(torch, dev, mesh, work, GQA_ARCH,
                                           _gqa_cfg(), GQA_STEPS, drawn)
        with open(os.path.join(work, "gqa_go.tmp"), "w") as f:
            json.dump({GQA_ARCH: rec["gqa_world1"]["host_file"]}, f)
        os.replace(os.path.join(work, "gqa_go.tmp"),
                   os.path.join(work, "gqa_go"))
    finally:
        dist.destroy_process_group()

    # (c) the meshed world's results
    ranks = [p for p in procs if isinstance(p, subprocess.Popen)]
    outs = [p.communicate(timeout=MESH_WORLD_TIMEOUT)[0] for p in ranks]
    codes = [p.returncode for p in ranks]
    if any(codes):
        fail(f"phase 25: the {world}-rank {backend} world failed (exit "
             f"codes {codes}): " + " | ".join(
                 f"rank {r}: {out[-1500:]}" for r, out in enumerate(outs)))
    with open(os.path.join(work, "result.json")) as f:
        cards = json.load(f)
    for (l_w, g_w), (l_1, g_1) in zip(cards["metrics"], m2):
        if not (abs(l_w - l_1) <= MESH_CARDS_RTOL * abs(l_1) and
                abs(g_w - g_1) <= MESH_CARDS_RTOL * abs(g_1)):
            fail(f"phase 25: {world} ranks' losses / grad norms "
                 f"{cards['metrics']} differ from world 1's {m2} past "
                 f"rtol {MESH_CARDS_RTOL}")
    moment = cards["moment_rel_diff"]
    worst = {w: sorted(moment, key=lambda k: -moment[k][i])[:5]
             for i, w in enumerate(("l2", "norm"))}
    log(f"phase 25: {world} ranks' first moments against world 1's, the "
        f"largest relative L2 differences " + ", ".join(
            f"{k} {moment[k][0]:.3g}" for k in worst["l2"]) +
        "; the largest relative norm differences " + ", ".join(
            f"{k} {moment[k][1]:.3g}" for k in worst["norm"]))
    for i, (w, tol) in enumerate((("relative L2", MESH_MOMENT_RTOL),
                                  ("relative norm", MESH_MOMENT_NORM_RTOL))):
        leaf = worst["l2" if i == 0 else "norm"][0]
        if moment[leaf][i] > tol:
            fail(f"phase 25: {world} ranks' first moment of {leaf} differs "
                 f"from world 1's by {moment[leaf][i]} ({w}), past {tol}")
    leaf, rel = worst["l2"][0], moment[worst["l2"][0]][0]
    if cards["per_rank"][0]["cp_calls"] == 0 or any(
            r["launches"] != rec["launches"] for r in cards["per_rank"]):
        fail(f"phase 25: {world} ranks: context-parallel calls or scan "
             f"launches off: {cards['per_rank']}")
    shard = cards["scan_shard"]
    if not shard["held"]:
        fail(f"phase 25: B7 / B8 on the shard {shard['shape']} differ from "
             f"their plain versions past {SCAN_FWD_TOL} / {SCAN_BWD_TOL}: "
             f"max abs err {shard['fwd_max_abs_err']} / "
             f"{shard['bwd_max_abs_err']}")
    moe, moe1 = cards["moe"], rec["moe_world1"]
    for (l_w, g_w), (l_1, g_1) in zip(moe["metrics"], moe1["metrics"]):
        if not (abs(l_w - l_1) <= MESH_CARDS_RTOL * abs(l_1) and
                abs(g_w - g_1) <= MESH_CARDS_RTOL * abs(g_1)):
            fail(f"phase 25: {world} ranks' {MOE_ARCH} losses / grad norms "
                 f"{moe['metrics']} differ from world 1's {moe1['metrics']} "
                 f"past rtol {MESH_CARDS_RTOL}")
    mm = moe["moment_rel_diff"]
    for i, (w, tol) in enumerate((("relative L2", MESH_MOMENT_RTOL),
                                  ("relative norm", MESH_MOMENT_NORM_RTOL))):
        top = max(mm, key=lambda k: mm[k][i])
        if mm[top][i] > tol:
            fail(f"phase 25: {world} ranks' {MOE_ARCH} first moment of {top} "
                 f"differs from world 1's by {mm[top][i]} ({w}), past {tol}")
    experts = _moe_cfg().n_experts // cards["mesh"][1]
    if any(r["experts_a_rank"] != experts for r in moe["per_rank"]):
        fail(f"phase 25: {MOE_ARCH}'s ranks hold "
             f"{[r['experts_a_rank'] for r in moe['per_rank']]} routed "
             f"experts, not {experts}")
    moe["card_count"] = _hold_count(
        25, f"a {MOE_ARCH} train step on {cards['mesh']}",
        moe["card_count"], meta_count)
    whole = moe1["param_bytes"] + moe1["opt_bytes"]
    for r in moe["per_rank"]:
        r["state_share"] = (r["param_bytes"] + r["opt_bytes"]) / whole
    gqa, gqa1 = cards["gqa"], rec["gqa_world1"]
    for (l_w, g_w), (l_1, g_1) in zip(gqa["metrics"], gqa1["metrics"]):
        if not (abs(l_w - l_1) <= MESH_CARDS_RTOL * abs(l_1) and
                abs(g_w - g_1) <= MESH_CARDS_RTOL * abs(g_1)):
            fail(f"phase 25: {world} ranks' {GQA_ARCH} losses / grad norms "
                 f"{gqa['metrics']} differ from world 1's {gqa1['metrics']} "
                 f"past rtol {MESH_CARDS_RTOL}")
    gm = gqa["moment_rel_diff"]
    for i, (w, tol) in enumerate((("relative L2", MESH_MOMENT_RTOL),
                                  ("relative norm", MESH_MOMENT_NORM_RTOL))):
        top = max(gm, key=lambda k: gm[k][i])
        if gm[top][i] > tol:
            fail(f"phase 25: {world} ranks' {GQA_ARCH} first moment of {top} "
                 f"differs from world 1's by {gm[top][i]} ({w}), past {tol}")
    # the query-split attention wherever the KV heads do not divide the
    # model axis (each layer's forward and its recomputation in backward)
    split_kv = _gqa_cfg().n_kv_heads % gqa["mesh"][1] != 0
    calls = [r["queries_calls"] for r in gqa["per_rank"]]
    if split_kv and any(c < 2 * GQA_LAYERS * GQA_STEPS for c in calls):
        fail(f"phase 25: {GQA_ARCH} on {gqa['mesh']}: the query-split "
             f"attention ran {calls} times a rank")
    for r in cards["per_rank"]:
        r["param_share"] = r["param_bytes"] / rec["world1_param_bytes"]
    rec["world"] = cards
    log(f"phase 25: {world} ranks' {MOE_ARCH}: step ms "
        f"{[round(x, 1) for x in moe['step_ms']]}, {moe['tokens_per_s']:.0f} "
        f"tokens/s, losses / grad norms {moe['metrics']} (world 1 "
        f"{moe1['metrics']}), largest parameter difference "
        f"{moe['max_param_diff']}, largest first-moment differences "
        f"{max(v[0] for v in mm.values()):.3g} (L2) / "
        f"{max(v[1] for v in mm.values()):.3g} (norm), collectives of a step "
        f"{moe['comms_last_step']}, {experts} experts a rank, bytes a rank "
        f"(parameters, AdamW state) "
        f"{[(r['param_bytes'], r['opt_bytes']) for r in moe['per_rank']]}"
        f" ({[round(r['state_share'], 4) for r in moe['per_rank']]} of world "
        f"1's {whole}); built from the mapped file in {moe['build_s']:.1f} s,"
        f" compared in {moe['compare_s']:.1f} s")
    log(f"phase 25: {world} ranks' {GQA_ARCH} on {gqa['mesh']} (query heads "
        f"split, K / V whole: {split_kv}; the query-split attention "
        f"{calls} times a rank): step ms "
        f"{[round(x, 1) for x in gqa['step_ms']]}, {gqa['tokens_per_s']:.0f} "
        f"tokens/s, losses / grad norms {gqa['metrics']} (world 1 "
        f"{gqa1['metrics']}), largest parameter difference "
        f"{gqa['max_param_diff']}, largest first-moment differences "
        f"{max(v[0] for v in gm.values()):.3g} (L2) / "
        f"{max(v[1] for v in gm.values()):.3g} (norm), collectives of a step "
        f"{gqa['comms_last_step']}, bytes a rank (parameters, AdamW state) "
        f"{[(r['param_bytes'], r['opt_bytes']) for r in gqa['per_rank']]};"
        f" built from the mapped file in {gqa['build_s']:.1f} s, compared in "
        f"{gqa['compare_s']:.1f} s")
    log(f"phase 25: {world} ranks ({backend}, {cards['cards']} cards) "
        f"{cards['mesh']}: step ms "
        f"{[round(s, 1) for s in cards['step_ms']]}, "
        f"{cards['tokens_per_s']:.0f} tokens/s, losses / grad norms "
        f"{cards['metrics']}, largest parameter difference "
        f"{cards['max_param_diff']}, largest first-moment difference "
        f"{rel} ({leaf}), B7 / B8 on the shard {shard['shape']} within "
        f"{shard['fwd_max_abs_err']} / {shard['bwd_max_abs_err']} of plain "
        f"({shard['fwd_plain_ms']:.1f} / {shard['bwd_plain_ms']:.1f} ms "
        f"plain), collectives of a step "
        f"{cards['comms_last_step']}, bytes a rank "
        f"{[(r['param_bytes'], r['opt_bytes']) for r in cards['per_rank']]}"
        f" ({[round(r['param_share'], 4) for r in cards['per_rank']]} of "
        f"the parameters)"
        f"; a rank's build {cards['build_s']:.1f} s, comparison "
        f"{cards['compare_s']:.1f} s, rank 0's shard checks and timings "
        f"{cards['scan_shard_s']:.1f} s")
    return rec


def _drawn_for_ranks(torch, arch: str, cfg) -> tuple[str, float]:
    """(path, seconds) of ``arch``'s weights (``cfg``) drawn once on the
    host into the file the ranks map (``_shared_host_weights``)."""
    t0 = time.perf_counter()
    return _shared_host_weights(torch, arch, cfg), time.perf_counter() - t0


def _mapped_world1(torch, dev, mesh, work: str, arch: str, cfg,
                   steps: int, drawn: tuple[str, float]) -> dict:
    """Phase 25's ``arch`` (``cfg``: ``_moe_cfg``, ``_gqa_cfg``) in world 1
    (the (1, 1) mesh) from the file of its weights (``drawn``:
    ``_drawn_for_ranks``), ``steps`` AdamW steps, and the parameters and
    first moments after them saved for the ranks (``world1_<arch>.pt``).
    Returns its record, the file's path under "host_file"."""
    from repro_torch.sharding.spmd import full_value
    path, draw_s = drawn
    t0 = time.perf_counter()
    model, state, step = _mapped_mesh_model(torch, dev, mesh, path, cfg)
    batches = _mesh_batches(torch, dev, model.cfg, steps)
    place_s = time.perf_counter() - t0
    state, metrics, secs, comms = _mesh_steps(torch, state, step, batches,
                                              mesh, comm_on_last=True)
    t0 = time.perf_counter()
    torch.save({"params": {k: full_value(p).cpu()
                           for k, p in state["params"].items()},
                "m": {k: full_value(m).cpu()
                      for k, m in state["opt"]["m"].items()}},
               os.path.join(work, f"world1_{arch}.pt"))
    n_params = sum(p.numel() for p in model.parameters())
    out = {"arch": arch, "layers": cfg.n_layers, "n_params": n_params,
           "dtype": cfg.dtype, "host_file": path,
           "draw_s": draw_s, "place_s": place_s,
           "save_s": time.perf_counter() - t0, "metrics": metrics,
           "step_ms": [x * 1e3 for x in secs],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / secs[-1],
           "comms_last_step": comms,
           "param_bytes": _local_bytes(dict(state["params"])),
           "opt_bytes": _local_bytes(state["opt"]),
           "peak_alloc_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"phase 25: {arch} ({cfg.n_layers} layers, {n_params} parameters, "
        f"{cfg.dtype}) in world 1: losses / grad norms {metrics}, step ms "
        f"{[round(x, 1) for x in out['step_ms']]}, "
        f"{out['tokens_per_s']:.0f} tokens/s, parameters / AdamW state "
        f"{out['param_bytes']} / {out['opt_bytes']} bytes; drawn on the "
        f"host and saved in {draw_s:.1f} s, placed in {place_s:.1f} s, "
        f"its results saved in {out['save_s']:.1f} s")
    del model, state, step, batches
    torch.cuda.empty_cache()
    return out


def _await_ranks(path: str, procs: list, what: str) -> None:
    """Wait for the file ``path`` that a meshed world's rank 0 writes at
    ``what``; the run fails if a rank exits first or
    ``MESH_WORLD_TIMEOUT`` passes."""
    deadline = time.monotonic() + MESH_WORLD_TIMEOUT
    while not os.path.exists(path):
        ended = [p for p in procs if isinstance(p, subprocess.Popen) and
                 p.poll() is not None]
        if ended or time.monotonic() > deadline:
            fail(f"the meshed world never reached {what}: " + " | ".join(
                f"exit {p.returncode}: {p.stdout.read()[-1500:]}"
                for p in ended))
        time.sleep(0.05)


def _start_mesh_world(torch, work: str, procs: list,
                      entry: str = "--mesh-rank"):
    """Start a meshed world (phase 25's ranks, or with ``entry``
    "--serve-rank" phase 26's): four gloo ranks on ``cuda:0`` where one
    card is visible (gloo takes CUDA tensors in every collective the ranks
    use; NCCL takes one rank a card), else NCCL ranks a card each (4 at four
    cards or more, else 2), appended to ``procs``. Returns (world,
    backend)."""
    count = torch.cuda.device_count()
    backend = "nccl" if count >= 2 else "gloo"
    world = 4 if count >= 4 or count == 1 else 2
    if count == 1:
        log("one card: the (2, 2) world is four gloo ranks on cuda:0 (NCCL "
            "takes one rank a card)")
    port = _free_port()
    procs.extend(subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), entry, str(r),
         "--mesh-world", str(world), "--mesh-port", str(port),
         "--mesh-dir", work, "--mesh-backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world))
    return world, backend


def _world_mesh(world: int) -> tuple:
    """The ("data", "model") sizes of a meshed world of ``world`` ranks:
    (2, 2) at four, (1, 2) at two."""
    return (2, 2) if world == 4 else (1, world)


class _PoolStopper:
    """A process pool in ``_in_scratch_world``'s list of processes,
    stopped as they are however the phase ends."""

    def __init__(self, pool):
        self.pool, self.done = pool, False

    def poll(self):
        return 0 if self.done else None

    def kill(self):
        self.pool.terminate()

    def wait(self):
        self.pool.join()
        self.done = True


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_phase_only(phase: int) -> None:
    """``python3 chip_smoke.py --phase 25`` (or ``26``): that phase alone
    (the sources built first), its record, the card line and the result
    line; on several cards its world is NCCL ranks a card each."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs the GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import selective_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    scans = {"selective_scan_fwd": ss.selective_scan_fwd_cuda,
             "selective_scan_bwd": ss.selective_scan_bwd_cuda}

    def zero_counts() -> None:
        for fn in scans.values():
            fn.launches = 0

    def read_counts(path: str, needs: tuple) -> dict:
        counts = {name: fn.launches for name, fn in scans.items()}
        if any(counts[name] == 0 for name in needs):
            fail(f"the {path} path launched no {needs} kernel")
        return counts

    t0 = time.perf_counter()
    path, name = ((mesh_training_path, "mesh_training") if phase == 25 else
                  (mesh_serving_path, "mesh_serving"))
    rec = path(torch, torch.device("cuda", 0), zero_counts, read_counts)
    rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({name: rec}), flush=True)
    log(f"phase {phase}: {rec['phase_s']:.1f} s ({rec['card']})")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _serve_rule_sets() -> dict:
    from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                      SERVING_RULES)
    return {"default": DEFAULT_RULES, "serving": SERVING_RULES,
            "long": LONG_CONTEXT_RULES}


def _serve_cfg(arch: str, dtype: str):
    """Phase 26's config of ``arch``: published widths cut to
    ``SERVE_MESH_LAYERS`` (whisper's encoder too), in ``dtype``, on the
    scan kernels."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(n_layers=SERVE_MESH_LAYERS[arch],
                                   dtype=dtype)
    if cfg.family == "encdec":
        cfg = cfg.replace(n_encoder_layers=SERVE_MESH_LAYERS[arch])
    return cfg.replace(ssm_kernel=True) if cfg.uses_ssm else cfg


def _moe_cfg():
    """``MOE_ARCH`` at its published widths cut to ``MOE_LAYERS``, float32
    (phase 25 trains it with remat "full", phase 26 serves it)."""
    from repro_torch.configs import get_config
    return get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS,
                                        dtype="float32", remat="full")


_HOST_FILES: dict = {}


def _shared_host_weights(torch, arch: str, cfg) -> str:
    """A file of ``arch``'s weights (``cfg``), drawn on the host from seed 0
    once in this process and saved under ``build/`` (removed when the
    process ends): the parent and every rank of a meshed world map it
    instead of drawing the weights each."""
    if arch not in _HOST_FILES:
        import atexit
        from repro_torch.models import Model
        model = Model(cfg, seed=0, device="cpu")
        path = os.path.join(ROOT, "build", f"host_weights_{arch}.pt")
        torch.save({k: p.detach() for k, p in model.named_parameters()},
                   path)
        atexit.register(lambda: os.path.exists(path) and os.remove(path))
        _HOST_FILES[arch] = path
    return _HOST_FILES[arch]


def _model_from_host_file(torch, cfg, path: str):
    """A ``Model`` of ``cfg`` whose parameters are the tensors of ``path``
    (``_shared_host_weights``), mapped rather than read: placing it on a
    mesh reads only this rank's shards, moving it to a card reads all."""
    from repro_torch.models import Model
    model = Model(cfg, device="meta")
    for name, t in torch.load(path, map_location="cpu", mmap=True).items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner).register_parameter(
            leaf, torch.nn.Parameter(t))
    return model


def _serve_host_models() -> dict:
    """Each phase-26 arch's weights, drawn on the host from seed 0 (float32
    parameters; a bfloat16 run computes in bfloat16 from them), but
    ``MOE_ARCH``'s: its caller adds the path of the shared file
    (``_shared_host_weights``)."""
    from repro_torch.models import Model
    return {arch: Model(_serve_cfg(arch, "float32"), seed=0, device="cpu")
            for arch in SERVE_MESH_LAYERS if arch != MOE_ARCH}


def _serve_model(torch, host, cfg, dev, mesh, rules):
    """A copy of the host model (or of the shared file's, ``host`` its
    path) computing in ``cfg``'s dtype: on ``dev`` (mesh None), else placed
    on ``mesh`` by ``param_specs(rules)``, each rank moving only its shards
    to its card."""
    import copy
    from repro_torch.sharding.rules import distribute_params
    if isinstance(host, str):
        model = _model_from_host_file(torch, cfg, host)
    else:
        model = copy.deepcopy(host)
    model.cfg = cfg
    if mesh is None:
        return model.to(dev)
    return distribute_params(model, mesh, rules)


def _serve_inputs(cfg, long_context: bool):
    """(prefill tokens [PREFILL_BATCH, PREFILL_SEQ], prompts [SERVE_BATCH,
    SERVE_PROMPT], whisper's stub frames or None) as host arrays from one
    seed (int64 tokens; float32 frames [PREFILL_BATCH + SERVE_BATCH, T,
    D]: the prefill's rows, then the decode's); row 0 of each under
    ``LONG_CONTEXT_RULES`` (batch 1)."""
    rng = np.random.default_rng(26)
    pre = rng.integers(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ))
    prompts = rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(0, 1, (PREFILL_BATCH + SERVE_BATCH,
                                   cfg.n_audio_frames, cfg.d_model)).astype(
            np.float32)
        if long_context:
            frames = frames[[0, PREFILL_BATCH]]
    if long_context:
        return pre[:1], prompts[:1], frames
    return pre, prompts, frames


def _encdec_greedy(torch, model, dev, prompts, frames, new: int):
    """Whisper's greedy tokens [B, new] on one device: ``encode`` and
    ``cross_kv`` fill the cache's cross keys and values from ``frames``,
    the decode steps take the prompts and then each argmax (``generate``
    serves the decoder-only families)."""
    b, n = prompts.shape
    cache = model.init_cache(b, n + new)
    enc = model.encode(torch.as_tensor(frames).to(dev))
    cache["cross_k"], cache["cross_v"] = model.cross_kv(enc)
    tok = torch.as_tensor(prompts, dtype=torch.int64).to(dev)
    out = []
    for t in range(n + new - 1):
        col = tok[:, t:t + 1] if t < n else out[-1][:, None]
        lg, cache = model.decode_step(cache, col, t)
        if t >= n - 1:
            out.append(lg[:, -1].float().argmax(-1))
    return torch.stack(out, 1).cpu().numpy()


def _serve_calls(torch, model, dev, pre, teacher, steps, mesh=None,
                 rules=None, count_comms=False, frames=None,
                 gathers=None) -> dict:
    """``Model.prefill`` on ``pre`` and ``steps`` decode steps fed
    ``teacher``'s tokens (a cache of ``teacher``'s length), on one device
    or, with ``mesh``, once a rank with the tokens (and whisper's
    ``frames``, ``_serve_inputs``') placed by ``batch_specs(rules)``: the
    prefill's and every step's logits gathered whole on the host
    (float32), the prefill's seconds, whisper's encoder and cross-cache
    seconds, each step's seconds (synchronised, the gather for the host
    outside), the collectives of the last step by kind (``count_comms``)
    and this rank's bytes of parameters and cache. ``gathers``: a list that
    takes (the group's ranks, the output's elements) of every all-gather
    the decode steps issue."""
    import contextlib
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.sharding.rules import distribute_batch
    from repro_torch.sharding.spmd import full_value
    kw = {} if mesh is None else {"rules": rules}

    def placed(x, name="tokens", dtype=torch.int64):
        t = torch.as_tensor(x, dtype=dtype)
        if mesh is None:
            return t.to(dev)
        return distribute_batch({name: t}, mesh, rules)[name]

    tokens = placed(pre)
    extra = {}
    if frames is not None:
        extra = {"extra": {"frames": placed(frames[:pre.shape[0]], "frames",
                                            torch.float32)}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg = model.prefill(tokens, **extra, **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = {"prefill": full_value(lg).float().cpu(), "prefill_s": prefill_s}
    cache = model.init_cache(teacher.shape[0], teacher.shape[1], **kw)
    if frames is not None:
        t0 = time.perf_counter()
        enc = model.encode(placed(frames[pre.shape[0]:], "frames",
                                  torch.float32), **kw)
        cache["cross_k"], cache["cross_v"] = model.cross_kv(enc, **kw)
        torch.cuda.synchronize()
        out["encode_s"] = time.perf_counter() - t0
    logits, secs, comms = [], [], None
    for t in range(steps):
        tok = placed(teacher[:, t:t + 1])
        counting = count_comms and t == steps - 1
        mode = CommDebugMode() if counting else contextlib.nullcontext()
        real_gather = dist.all_gather_into_tensor
        if gathers is not None:
            def spy(out_t, t_in, group=None, **k):
                gathers.append((dist.get_process_group_ranks(group),
                                out_t.numel()))
                return real_gather(out_t, t_in, group=group, **k)
            dist.all_gather_into_tensor = spy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with mode:
                lg, cache = model.decode_step(cache, tok, t, **kw)
            torch.cuda.synchronize()
        finally:
            dist.all_gather_into_tensor = real_gather
        secs.append(time.perf_counter() - t0)
        if counting:
            comms = {str(k).rsplit(".", 1)[-1]: v
                     for k, v in mode.get_comm_counts().items()}
        logits.append(full_value(lg)[:, 0].float().cpu())
    out.update(steps=torch.stack(logits), step_s=secs, comms=comms,
               param_bytes=_local_bytes(dict(model.named_parameters())),
               cache_bytes=_local_bytes(cache))
    return out


def _serve_key(arch: str, dtype: str, long_context: bool) -> str:
    return f"{arch}|{dtype}|{'batch1' if long_context else 'full'}"


def _held(torch, got, want) -> tuple[float, bool]:
    """(largest difference, within ``SERVE_MESH_TOL``) of two logits."""
    return ((got - want).abs().max().item(),
            bool(torch.allclose(got, want, **SERVE_MESH_TOL)))


def serve_rank_main(rank: int, world: int, port: int, workdir: str,
                    backend: str) -> None:
    """One rank of phase 26's meshed world (``python3 chip_smoke.py
    --serve-rank R --mesh-world W --mesh-port P --mesh-dir D --mesh-backend
    B``): with NCCL a card each, with gloo every rank on ``cuda:0``; the
    (2, 2) mesh at four ranks and (1, 2) at two. The weights are drawn on
    the host while world 1 runs; once world 1's results are in ``workdir``
    each of ``SERVE_WORLD_RUNS`` places them by its rule set and runs the
    prefill and the decode steps teacher-forced on world 1's tokens, held
    against world 1's logits; B7's launches and the context-parallel calls
    counted, B7 held against its plain version and timed at the shard's
    shape (and on data rank 1, from a carried state, at its block of the
    long-context prefill), and the all-gathers of every decode step's MoE
    layer recorded; rank 0 writes ``result.json`` under ``workdir``."""
    import faulthandler

    import torch
    import torch.distributed as dist
    faulthandler.enable()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch.models.layers as L
    import repro_torch.models.moe as MOE
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.dryrun import trace_counts
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding.rules import distribute_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    try:
        sizes = _world_mesh(world)
        mesh = make_device_mesh(sizes)
        rule_sets = _serve_rule_sets()
        # the first f32 scan's operands (a prefill calls B7's forward route
        # itself, under no gradient), and data rank 1's first of the
        # long-context prefill, which starts from data rank 0's state
        seen = {"cp": 0, "args": None, "queries": 0, "long": False,
                "carried": None}
        data_rank = mesh.get_coordinate()[0]
        real_cp, real_scan = L._context_parallel_flash, ops.selective_scan_fwd
        real_queries = L.split_queries

        def cp(*a, **k):
            seen["cp"] += 1
            return real_cp(*a, **k)

        def scan(*a, chunk):
            for key, want in (("args", a[0].dtype == torch.float32),
                              ("carried", seen["long"] and data_rank == 1)):
                if want and seen[key] is None:
                    seen[key] = [t.detach().clone() for t in a] + [chunk]
            return real_scan(*a, chunk=chunk)

        def queries(*a, **k):
            seen["queries"] += 1
            return real_queries(*a, **k)

        L._context_parallel_flash, ops.selective_scan_fwd = cp, scan
        L.split_queries = queries
        # every all-gather of a decode step's MoE layer (the group's ranks,
        # the output's elements): its parameters for the step
        # (moe_parts(..., decode=True)) and the layer itself
        seen["moe_gathers"] = []
        real_parts, real_ffn = MOE.moe_parts, MOE.moe_ffn

        def in_moe(fn):
            def run(*a, **k):
                if fn is real_parts and not k.get("decode"):
                    return fn(*a, **k)
                outer = dist.all_gather_into_tensor

                def spy(out_t, t_in, group=None, **kw):
                    seen["moe_gathers"].append(
                        (dist.get_process_group_ranks(group), out_t.numel()))
                    return outer(out_t, t_in, group=group, **kw)

                dist.all_gather_into_tensor = spy
                try:
                    return fn(*a, **k)
                finally:
                    dist.all_gather_into_tensor = outer
            return run

        MOE.moe_parts, MOE.moe_ffn = in_moe(real_parts), in_moe(real_ffn)
        t0 = time.perf_counter()
        # MOE_ARCH's weights come from the parent's file, named once world
        # 1's results are in
        host = _serve_host_models()
        build_s = time.perf_counter() - t0
        go = os.path.join(workdir, "go")
        deadline = time.monotonic() + MESH_WORLD_TIMEOUT
        while not os.path.exists(go):
            if time.monotonic() > deadline:
                raise TimeoutError("world 1's results never came")
            time.sleep(0.05)
        with open(os.path.join(workdir, "host_files.json")) as f:
            host[MOE_ARCH] = json.load(f)[MOE_ARCH]
        ref = torch.load(os.path.join(workdir, "world1.pt"),
                         map_location="cpu")
        runs = {}
        for arch, rules_name, dtype in SERVE_WORLD_RUNS:
            long_context = rules_name == "long"
            r = ref[_serve_key(arch, dtype, long_context)]
            cfg = _serve_cfg(arch, dtype)
            steps = (r["steps"].shape[0] if rules_name == "serving"
                     else SERVE_FSDP_STEPS)
            t0 = time.perf_counter()
            model = _serve_model(torch, host[arch], cfg, dev, mesh,
                                 rule_sets[rules_name])
            place_s = time.perf_counter() - t0
            ss.selective_scan_fwd_cuda.launches = 0
            cp_before, queries_before = seen["cp"], seen["queries"]
            gathers = [] if long_context else None
            seen["long"] = long_context and dtype == "float32"
            seen["moe_gathers"].clear()
            t0 = time.perf_counter()
            got = _serve_calls(torch, model, dev, r["pre"], r["teacher"],
                               steps, mesh, rule_sets[rules_name],
                               count_comms=True, frames=r["frames"],
                               gathers=gathers)
            run_s = time.perf_counter() - t0
            seen["long"] = False
            pre_err = _held(torch, got["prefill"], r["prefill"])
            step_errs = [_held(torch, g, w) for g, w in
                         zip(got["steps"], r["steps"][:steps])]
            greedy = bool(torch.equal(got["steps"].argmax(-1),
                                      r["steps"][:steps].argmax(-1)))
            dec = got["step_s"][1:] or got["step_s"]
            runs["|".join((arch, rules_name, dtype))] = {
                "batch": int(r["pre"].shape[0]), "steps": steps,
                "prefill": pre_err, "prefill_greedy_equal": bool(
                    torch.equal(got["prefill"].argmax(-1),
                                r["prefill"].argmax(-1))),
                "decode_worst": max(e for e, _ in step_errs),
                "decode_held": all(ok for _, ok in step_errs),
                "greedy_equal": greedy,
                "b7_launches": ss.selective_scan_fwd_cuda.launches,
                "cp_calls": seen["cp"] - cp_before,
                "queries_calls": seen["queries"] - queries_before,
                "prefill_s": got["prefill_s"],
                "prefill_tokens_per_s": r["pre"].numel() / got["prefill_s"],
                "decode_ms": statistics.median(dec) * 1e3,
                "decode_tokens_per_s": r["teacher"].shape[0] /
                statistics.median(dec),
                "comms_decode_step": got["comms"],
                "param_bytes": got["param_bytes"],
                "cache_bytes": got["cache_bytes"],
                "encode_s": got.get("encode_s"),
                "experts_a_rank": (model.blocks[-1].mlp.wi.to_local()
                                   .shape[0] if cfg.is_moe else None),
                "place_s": place_s, "run_s": run_s}
            data = dist.get_process_group_ranks(mesh.get_group("data"))
            if long_context:
                # the output sizes of the decode steps' all-gathers over
                # this rank's data group: one token's activation only
                runs["|".join((arch, rules_name, dtype))][
                    "data_gathers"] = sorted({n for g, n in gathers
                                              if g == data})
            if cfg.is_moe:
                # those of the MoE layers' all-gathers over it
                runs["|".join((arch, rules_name, dtype))][
                    "moe_data_gathers"] = sorted({
                        n for g, n in seen["moe_gathers"] if g == data})
            if (arch, rules_name, dtype) in SERVE_COUNTED:
                # one more decode step, at the cache's last slot, which
                # rank 0 counts as the dry-run does (the parent holds its
                # FLOPs and collectives to the meta count)
                b, n = r["teacher"].shape
                cache = model.init_cache(b, n, rules=rule_sets[rules_name])
                tok = distribute_batch({"tokens": torch.as_tensor(
                    r["teacher"][:, -1:], dtype=torch.int64)}, mesh,
                    rule_sets[rules_name])["tokens"]
                call = lambda: model.decode_step(
                    cache, tok, n - 1, rules=rule_sets[rules_name])
                if rank == 0:
                    runs["|".join((arch, rules_name, dtype))][
                        "card_count"] = _count_summary(trace_counts(
                            call, (cache, tok)))
                else:
                    call()
                del cache
            if long_context and (arch, rules_name, dtype) in SERVE_COUNTED:
                # one more long-context prefill, its sequence split over
                # "data", which rank 0 counts
                b = distribute_batch({"tokens": torch.as_tensor(
                    r["pre"], dtype=torch.int64), **({} if r["frames"] is None
                    else {"frames": torch.as_tensor(
                        r["frames"][:1], dtype=torch.float32)})}, mesh,
                    rule_sets[rules_name])
                call = lambda: model.prefill(b["tokens"], extra={
                    k: v for k, v in b.items() if k != "tokens"},
                    rules=rule_sets[rules_name])
                if rank == 0:
                    runs["|".join((arch, rules_name, dtype))][
                        "prefill_count"] = _count_summary(trace_counts(
                            call, (b,)))
                else:
                    call()
                del b
            if (arch, rules_name, dtype) == ("qwen2.5-3b", "serving",
                                             "float32"):
                # one more prefill, its query heads split and K and V
                # projected whole on each rank, which rank 0 counts
                tok = distribute_batch({"tokens": torch.as_tensor(
                    r["pre"], dtype=torch.int64)}, mesh,
                    rule_sets[rules_name])["tokens"]
                call = lambda: model.prefill(tok, rules=rule_sets[rules_name])
                if rank == 0:
                    runs["|".join((arch, rules_name, dtype))][
                        "prefill_count"] = _count_summary(trace_counts(
                            call, (tok,)))
                else:
                    call()
            del model, got
            torch.cuda.empty_cache()
        mine = {"device": str(dev), "runs": runs}
        if seen["carried"] is not None and mesh.get_coordinate()[1] == 0:
            mine["b7_carried"] = _b7_held(torch, ss, seen["carried"])
        per_rank = [None] * world
        dist.all_gather_object(per_rank, mine)
        if rank == 0:
            t0 = time.perf_counter()
            # B7 at this rank's shard of the f32 prefill's first Mamba layer
            *ops_, chunk = seen["args"]
            xc, dt, bm, cm, a, h0 = (t.contiguous() for t in ops_)
            fwd = lambda: ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0,
                                                     chunk=chunk)
            plain = {}
            plain_ms = time_cuda(torch, lambda: plain.__setitem__(
                "fwd", ss.selective_scan_fwd_plain(xc, dt, bm, cm, a, h0,
                                                   chunk=chunk)),
                reps=1, warmup=0)
            got = fwd()
            err = max((g.float() - e.float()).abs().max().item()
                      for g, e in zip(got, plain["fwd"]))
            held = all(torch.allclose(g, e, **SCAN_FWD_TOL)
                       for g, e in zip(got, plain["fwd"]))
            B, S_, Di = xc.shape
            fb, _ = scan_bounds(B, S_, Di, a.shape[1], chunk,
                                max_sm_clock_hz())
            shard = {"shape": [B, S_, Di, a.shape[1]], "chunk": chunk,
                     "ms": time_cuda(torch, fwd),
                     "device_ms": kernel_device_ms(torch, fwd, "ssm_fwd", 1),
                     "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
                     "plain_ms": plain_ms, "max_abs_err": err,
                     "held": held}
            rec = {"world": world, "mesh": list(sizes), "backend": backend,
                   "cards": len({r["device"] for r in per_rank}),
                   "card": card_line(), "build_s": build_s,
                   "per_rank": per_rank, "b7_shard": shard,
                   "b7_shard_s": time.perf_counter() - t0}
            with open(os.path.join(workdir, "result.json"), "w") as f:
                json.dump(rec, f)
        dist.all_reduce(torch.zeros(1, device=dev))
    finally:
        dist.destroy_process_group()


def _b7_held(torch, ss, args) -> dict:
    """B7 on the operands ``args`` ([xc, dt, bm, cm, a, h0, chunk]) of a
    data rank's first scan of the long-context prefill, whose ``h0`` is the
    state the rank before it ended in: held against its plain version
    within ``SCAN_FWD_TOL`` on y and the final state, and timed (host ms,
    the profiler's device ms, the bound of ``scan_bounds``)."""
    *ops_, chunk = args
    xc, dt, bm, cm, a, h0 = (t.contiguous() for t in ops_)
    fwd = lambda: ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0,
                                             chunk=chunk)
    plain = {}
    plain_ms = time_cuda(torch, lambda: plain.__setitem__(
        "fwd", ss.selective_scan_fwd_plain(xc, dt, bm, cm, a, h0,
                                           chunk=chunk)), reps=1, warmup=0)
    (y, _, ht), (y_p, _, ht_p) = fwd(), plain["fwd"]
    B, S_, Di = xc.shape
    fb, _ = scan_bounds(B, S_, Di, a.shape[1], chunk, max_sm_clock_hz())
    return {"shape": [B, S_, Di, a.shape[1]], "chunk": chunk,
            "h0_max_abs": h0.abs().max().item(),
            "y_err": (y - y_p).abs().max().item(),
            "ht_err": (ht - ht_p).abs().max().item(),
            "held": bool(torch.allclose(y, y_p, **SCAN_FWD_TOL) and
                         torch.allclose(ht, ht_p, **SCAN_FWD_TOL)),
            "ms": time_cuda(torch, fwd),
            "device_ms": kernel_device_ms(torch, fwd, "ssm_fwd", 1),
            "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
            "plain_ms": plain_ms}


def mesh_serving_path(torch, dev, zero_counts, read_counts) -> dict:
    """Phase 26 (``_mesh_serving``)."""
    return _in_scratch_world(_mesh_serving, torch, dev, zero_counts,
                             read_counts)


def _mesh_serving(torch, dev, zero_counts, read_counts, work: str,
                  procs: list) -> dict:
    """Phase 26: serving on a ``torch.distributed`` device mesh. (a) An
    NCCL world of 1 and a (1, 1) ("data", "model") ``DeviceMesh``:
    hymba-1.5b at published widths cut to ``SERVE_MESH_LAYERS`` (float32,
    the scan kernels), under each of the reference's three rule sets
    (``LONG_CONTEXT_RULES`` at batch 1), ``Model.prefill`` at
    ``PREFILL_BATCH`` x ``PREFILL_SEQ``, the decode steps of ``generate``'s
    ``SERVE_BATCH`` prompts of ``SERVE_PROMPT`` tokens and
    ``SERVE_MESH_NEW`` new ones teacher-forced on one device's tokens, and
    ``generate`` itself, against the same calls on one device: logits and
    tokens bit-equal, B7 launched once per Mamba layer of each prefill.
    One device also gives the references of the meshed world: hymba in
    bfloat16 and qwen2.5-3b (published widths cut to ``SERVE_LAYERS``). (b)
    A meshed world (``serve_rank_main``; four gloo ranks on ``cuda:0`` in a
    (2, 2) mesh on one card, NCCL ranks a card each on several), started
    with the phase to draw its weights while one device runs, and taking
    its runs once one device's references are written, while (a) runs the
    (1, 1) mesh: each of
    ``SERVE_WORLD_RUNS`` held to world 1's logits within ``SERVE_MESH_TOL``
    in float32 (prefill and every decode step; every greedy token equal),
    bfloat16 reported; B7 launched once per Mamba layer on each rank's
    shard and held against its plain version there, the context-parallel
    attention taken. The long-context prefills keep the sequence split
    over "data": rank 0 counts one of hymba's and one of whisper's against
    their meta counts, and B7 on data rank 1's first block, which starts
    from data rank 0's final state, is held against its plain version (y
    and the final state) and timed (``_b7_held``). Returns the phase's
    record."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.serve import generate

    rec = {"card": card_line()}
    torch.cuda.set_device(dev)
    torch.cuda.empty_cache()
    world, backend = _start_mesh_world(torch, work, procs, "--serve-rank")
    # the dry-run's count of the decode steps rank 0 counts on the card
    # (SERVE_COUNTED) and of the SERVING_RULES prefill of qwen2.5-3b
    # (query heads split)
    long_counted = [arch for arch, rules_name, _ in SERVE_COUNTED
                    if rules_name == "long"]
    count_pool, (meta_prefill, *meta_counts) = _start_meta_count(
        _world_mesh(world), "prefill", *(
            f"{rules_name}:{arch}" for arch, rules_name, _ in SERVE_COUNTED),
        *(
            f"longprefill:{arch}" for arch in long_counted))
    meta_counts, meta_long_prefill = (meta_counts[:len(SERVE_COUNTED)],
                                      meta_counts[len(SERVE_COUNTED):])
    procs.append(_PoolStopper(count_pool))
    rule_sets = _serve_rule_sets()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_device_mesh((1, 1))
        t0 = time.perf_counter()
        host = _serve_host_models()
        # drawn and saved by phase 25 in a whole run
        host[MOE_ARCH] = _shared_host_weights(torch, MOE_ARCH, _moe_cfg())
        rec["host_draw_s"] = time.perf_counter() - t0
        refs, world1 = {}, {}
        # one device: the references (and the tokens every world is fed)
        for arch, dtype, long_context in SERVE_REFERENCES:
            cfg = _serve_cfg(arch, dtype)
            t0 = time.perf_counter()
            model = _serve_model(torch, host[arch], cfg, dev, None, None)
            place_s = time.perf_counter() - t0
            pre, prompts, frames = _serve_inputs(cfg, long_context)
            zero_counts()
            t0 = time.perf_counter()
            if frames is None:
                new = generate(model, prompts, SERVE_MESH_NEW)
            else:
                new = _encdec_greedy(torch, model, dev, prompts,
                                     frames[pre.shape[0]:], SERVE_MESH_NEW)
            generate_s = time.perf_counter() - t0
            teacher = np.concatenate([prompts, new], axis=1)
            got = _serve_calls(torch, model, dev, pre, teacher,
                               teacher.shape[1], frames=frames)
            key = _serve_key(arch, dtype, long_context)
            counts = read_counts(f"mesh_serve_one_{key}", (
                "selective_scan_fwd",) if cfg.uses_ssm else ())
            refs[key] = {"pre": torch.from_numpy(pre),
                         "teacher": torch.from_numpy(teacher),
                         "frames": (None if frames is None
                                    else torch.from_numpy(frames)),
                         "prefill": got["prefill"], "steps": got["steps"]}
            world1[key] = {"one_device": {
                "b7_launches": counts["selective_scan_fwd"],
                "generate_s": generate_s, "prefill_s": got["prefill_s"],
                "decode_ms": statistics.median(got["step_s"][1:]) * 1e3,
                "decode_tokens_per_s": teacher.shape[0] / statistics.median(
                    got["step_s"][1:]),
                "prefill_tokens_per_s": pre.size / got["prefill_s"],
                "encode_s": got.get("encode_s"), "place_s": place_s,
                "param_bytes": got["param_bytes"],
                "cache_bytes": got["cache_bytes"]}}
            if not torch.equal(got["steps"][SERVE_PROMPT - 1:-1]
                               .argmax(-1).T, torch.from_numpy(new)):
                fail(f"phase 26: {key}: the decode steps' argmax differs "
                     f"from generate's tokens on one device")
            del model
            torch.cuda.empty_cache()
        # (b) takes its runs while (a) runs the (1, 1) mesh
        torch.save(refs, os.path.join(work, "world1.pt"))
        with open(os.path.join(work, "host_files.json"), "w") as f:
            json.dump({MOE_ARCH: host[MOE_ARCH]}, f)
        open(os.path.join(work, "go"), "w").close()
        # (a) the (1, 1) mesh under each rule set, against one device
        for arch, (rules_name, rules) in ((a, r) for a in SERVE_WORLD1_ARCHS
                                          for r in rule_sets.items()):
            n_mamba = (SERVE_MESH_LAYERS[arch]
                       if _serve_cfg(arch, "float32").uses_ssm else 0)
            long_context = rules_name == "long"
            key = _serve_key(arch, "float32", long_context)
            r = refs[key]
            model = _serve_model(torch, host[arch],
                                 _serve_cfg(arch, "float32"), dev, mesh,
                                 rules)
            zero_counts()
            got = _serve_calls(torch, model, dev, r["pre"].numpy(),
                               r["teacher"].numpy(), r["teacher"].shape[1],
                               mesh, rules, count_comms=True,
                               frames=r["frames"])
            counts = read_counts(f"mesh_serve_world1_{arch}_{rules_name}",
                                 ("selective_scan_fwd",) if n_mamba else ())
            same = {"prefill": bool(torch.equal(got["prefill"],
                                                r["prefill"])),
                    "steps": bool(torch.equal(got["steps"], r["steps"]))}
            if r["frames"] is None:     # generate serves decoder-only archs
                new = generate(model, r["teacher"][:, :SERVE_PROMPT].numpy(),
                               SERVE_MESH_NEW, mesh=mesh, rules=rules)
                same["tokens"] = bool(np.array_equal(
                    new, r["teacher"][:, SERVE_PROMPT:].numpy()))
            dec = got["step_s"][1:]
            world1[key][rules_name] = {
                "bit_equal": same, "b7_launches":
                    counts["selective_scan_fwd"],
                "prefill_s": got["prefill_s"],
                "prefill_tokens_per_s": r["pre"].numel() / got["prefill_s"],
                "decode_ms": statistics.median(dec) * 1e3,
                "decode_tokens_per_s": r["teacher"].shape[0] /
                statistics.median(dec),
                "comms_decode_step": got["comms"],
                "encode_s": got.get("encode_s"),
                "param_bytes": got["param_bytes"],
                "cache_bytes": got["cache_bytes"]}
            if not all(same.values()):
                fail(f"phase 26: the (1, 1) mesh's {arch} under {rules_name} "
                     f"differs from one device: {same}")
            if counts["selective_scan_fwd"] != n_mamba:
                fail(f"phase 26: the (1, 1) mesh's prefill under "
                     f"{rules_name} launched B7 {counts['selective_scan_fwd']}"
                     f" times; {n_mamba} Mamba layers")
            del model
            torch.cuda.empty_cache()
        rec["world1"] = world1
        log("phase 26: the (1, 1) mesh's hymba and whisper bit-equal to one "
            "device under default, serving and long-context rules (prefill, "
            "every decode step, hymba's generate tokens); hymba's B7 " +
            ", ".join(
                f"{k} {v['b7_launches']}" for k, v in
                world1[_serve_key("hymba-1.5b", "float32", False)].items()
                if k != "one_device") + " a prefill; decode ms a step " +
            ", ".join(f"{k} {v[n]['decode_ms']:.2f}" for k, v in
                      world1.items() for n in v))
        del host
    finally:
        dist.destroy_process_group()

    # (b) the meshed world's results
    ranks = [p for p in procs if isinstance(p, subprocess.Popen)]
    outs = [p.communicate(timeout=MESH_WORLD_TIMEOUT)[0] for p in ranks]
    codes = [p.returncode for p in ranks]
    if any(codes):
        fail(f"phase 26: the {world}-rank {backend} world failed (exit "
             f"codes {codes}): " + " | ".join(
                 f"rank {r}: {out[-1500:]}" for r, out in enumerate(outs)))
    with open(os.path.join(work, "result.json")) as f:
        cards = json.load(f)
    for r, per in enumerate(cards["per_rank"]):
        for name, run in per["runs"].items():
            arch, rules_name, dtype = name.split("|")
            n_mamba = (SERVE_MESH_LAYERS[arch]
                       if _serve_cfg(arch, dtype).uses_ssm else 0)
            if run["b7_launches"] != n_mamba:
                fail(f"phase 26: rank {r}, {name}: B7 launched "
                     f"{run['b7_launches']} times; {n_mamba} Mamba layers")
            if arch == "hymba-1.5b" and cards["mesh"][1] > 1 and \
                    run["cp_calls"] == 0:
                fail(f"phase 26: rank {r}, {name}: the prefill did not take "
                     f"the context-parallel attention")
            # SERVING_RULES keeps wk / wv whole: the query heads split
            if arch in ("qwen2.5-3b", ENCDEC_ARCH) and rules_name == \
                    "serving" and cards["mesh"][1] > 1 and \
                    run["queries_calls"] == 0:
                fail(f"phase 26: rank {r}, {name}: the prefill did not take "
                     f"the query-split attention")
            if dtype == "float32" and not (
                    run["prefill"][1] and run["prefill_greedy_equal"] and
                    run["decode_held"] and run["greedy_equal"]):
                fail(f"phase 26: rank {r}, {name}: prefill {run['prefill']} "
                     f"(greedy equal {run['prefill_greedy_equal']}), "
                     f"largest decode difference {run['decode_worst']} "
                     f"(held {run['decode_held']}), greedy tokens equal "
                     f"{run['greedy_equal']}, past {SERVE_MESH_TOL}")
            cfg = _serve_cfg(arch, dtype)
            if rules_name == "long" and cards["mesh"][0] > 1 and \
                    run["data_gathers"] != [cfg.d_model]:
                fail(f"phase 26: rank {r}, {name}: the decode steps' "
                     f"all-gathers over \"data\" have {run['data_gathers']} "
                     f"elements, not one token's {cfg.d_model}: a "
                     f"parameter is gathered")
            if cfg.is_moe and run["experts_a_rank"] != \
                    cfg.n_experts // cards["mesh"][1]:
                fail(f"phase 26: rank {r}, {name}: {run['experts_a_rank']} "
                     f"routed experts a rank; {cfg.n_experts} over "
                     f"{cards['mesh'][1]} model ranks")
            # a decode step's MoE layer gathers its tokens over "data" and
            # keeps each leaf's data shard: the tokens' activation and the
            # output columns are all it gathers there
            rows = 1 if rules_name == "long" else SERVE_BATCH
            if cfg.is_moe and cards["mesh"][0] > 1 and (
                    not run["moe_data_gathers"] or
                    max(run["moe_data_gathers"]) > rows * cfg.d_model):
                fail(f"phase 26: rank {r}, {name}: the MoE layers' "
                     f"all-gathers over \"data\" in the decode steps have "
                     f"{run['moe_data_gathers']} elements, not at most the "
                     f"tokens' activation ({rows} x {cfg.d_model}): a "
                     f"router, expert or shared-expert leaf is gathered, or "
                     f"the tokens are not")
            whole = world1[_serve_key(arch, "float32", rules_name == "long")][
                "one_device"]["param_bytes"]
            run["param_share"] = run["param_bytes"] / whole
    shard = cards["b7_shard"]
    if not shard["held"]:
        fail(f"phase 26: B7 on the shard {shard['shape']} differs from its "
             f"plain version past {SCAN_FWD_TOL}: max abs err "
             f"{shard['max_abs_err']}")
    # B7 on data rank 1's block of hymba's long-context prefill, from the
    # state data rank 0's scan ended in
    carried = [p["b7_carried"] for p in cards["per_rank"]
               if "b7_carried" in p]
    if cards["mesh"][0] > 1:
        if not carried:
            fail("phase 26: no data rank 1 scanned hymba's long-context "
                 "prefill")
        carried = carried[0]
        if not carried["held"] or carried["h0_max_abs"] == 0:
            fail(f"phase 26: B7 on data rank 1's block {carried['shape']} "
                 f"from a carried state (max |h0| {carried['h0_max_abs']}) "
                 f"differs from its plain version past {SCAN_FWD_TOL}: y "
                 f"{carried['y_err']}, final state {carried['ht_err']}")
        cards["b7_carried"] = carried
    rec["world"] = cards
    runs0 = cards["per_rank"][0]["runs"]
    for (arch, rules_name, dtype), meta in zip(SERVE_COUNTED, meta_counts):
        counted = runs0["|".join((arch, rules_name, dtype))]
        counted["card_count"] = _hold_count(
            26, f"a {arch} {rules_name} decode step on {cards['mesh']}",
            counted["card_count"], meta)
    counted = runs0[f"{MOE_ARCH}|default|float32"]
    log(f"phase 26: a {MOE_ARCH} DEFAULT_RULES decode step on "
        f"{cards['mesh']}, its MoE layer on each leaf's data shard: "
        f"{counted['decode_ms']:.1f} ms a step ({counted['steps']} steps); "
        f"every MoE all-gather over \"data\" at most "
        f"{max(counted['moe_data_gathers'], default=0)} elements")
    counted = runs0["qwen2.5-3b|serving|float32"]
    counted["prefill_count"] = _hold_count(
        26, f"a qwen2.5-3b SERVING_RULES prefill on {cards['mesh']}",
        counted["prefill_count"], meta_prefill)
    for arch, meta in zip(long_counted, meta_long_prefill):
        counted = runs0[f"{arch}|long|float32"]
        counted["prefill_count"] = _hold_count(
            26, f"a {arch} LONG_CONTEXT_RULES prefill of 1 x {PREFILL_SEQ} "
            f"on {cards['mesh']} (its sequence split over \"data\")",
            counted["prefill_count"], meta)
    if cards["mesh"][0] > 1:
        one = {a: world1[_serve_key(a, "float32", True)]["one_device"][
            "prefill_s"] for a in ("hymba-1.5b", ENCDEC_ARCH)}
        log(f"phase 26: B7 on data rank 1's block {carried['shape']} of "
            f"hymba's long-context prefill, from data rank 0's final state "
            f"(max |h0| {carried['h0_max_abs']:.3g}): {carried['ms']:.4f} ms "
            f"(device {carried['device_ms']:.4f}, bound "
            f"{carried['bound_ms']:.4g} by {carried['bound_by']}, plain "
            f"{carried['plain_ms']:.1f}), within {carried['y_err']:.3g} (y) "
            f"and {carried['ht_err']:.3g} (final state) of plain; the "
            f"long-context prefill of 1 x {PREFILL_SEQ} in " + ", ".join(
                f"{a} {runs0[f'{a}|long|float32']['prefill_s']:.3f} s"
                for a in ("hymba-1.5b", ENCDEC_ARCH)) + " on the mesh, " +
            ", ".join(f"{a} {s:.3f} s" for a, s in one.items()) +
            " on one device")
    log(f"phase 26: {world} ranks ({backend}, {cards['cards']} cards) "
        f"{cards['mesh']}: " + "; ".join(
            f"{name} prefill diff {run['prefill'][0]:.3g}, decode diff "
            f"{run['decode_worst']:.3g} over {run['steps']} steps, greedy "
            f"equal {run['greedy_equal']}, decode {run['decode_ms']:.1f} ms "
            f"a step ({run['decode_tokens_per_s']:.1f} tokens/s), prefill "
            f"{run['prefill_tokens_per_s']:.0f} tokens/s, bytes a rank "
            f"{run['param_bytes']} ({run['param_share']:.4f} of the "
            f"parameters) / {run['cache_bytes']}, collectives "
            f"{run['comms_decode_step']}"
            + (f", {run['experts_a_rank']} experts a rank"
               if run["experts_a_rank"] else "")
            + (f", the query-split attention {run['queries_calls']} times"
               if run["queries_calls"] else "")
            + (f", encoder and cross cache {run['encode_s']:.2f} s"
               if run["encode_s"] is not None else "")
            + f"; its place and run {run['place_s']:.1f} / "
            f"{run['run_s']:.1f} s"
            for name, run in runs0.items()) +
        f"; B7 on the shard {shard['shape']} {shard['ms']:.4f} ms (device "
        f"{shard['device_ms']:.4f}, bound {shard['bound_ms']:.4g}, plain "
        f"{shard['plain_ms']:.1f}), within {shard['max_abs_err']:.3g} of "
        f"plain; a rank's weights drawn in {cards['build_s']:.1f} s")
    log(f"phase 26: decode ms a step on {cards['mesh']}, LONG_CONTEXT_RULES "
        f"(each weight's data shard kept) against DEFAULT_RULES (weights "
        f"gathered over \"data\"): " + "; ".join(
            f"{a} {runs0[f'{a}|long|float32']['decode_ms']:.1f} against "
            f"{runs0[f'{a}|default|float32']['decode_ms']:.1f}"
            for a in ("hymba-1.5b", ENCDEC_ARCH)))
    return rec


def main() -> None:
    for entry, rank_main in (("--mesh-rank", mesh_rank_main),
                             ("--serve-rank", serve_rank_main)):
        if entry in sys.argv:
            args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
            rank_main(int(args[entry]), int(args["--mesh-world"]),
                      int(args["--mesh-port"]), args["--mesh-dir"],
                      args["--mesh-backend"])
            return
    if sys.argv[1:] in (["--phase", "25"], ["--phase", "26"]):
        mesh_phase_only(int(sys.argv[2]))
        return
    try:
        run_phases()
    except ProfilerMiss as e:
        fail(str(e))


def run_phases() -> None:
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
    from repro_torch.kernels import flow_accum as fa
    from repro_torch.kernels import load_prop as lp
    from repro_torch.kernels import minplus as mp
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import apsp_steps as aps
    import load_prop_steps as lps
    import scan_fwd_steps as sfs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # name -> (wrapper, its counter)
    kernels = {"load_propagate": (lp.load_prop_cuda, "launches"),
               "apsp_fused": (ap.apsp_fused_cuda, "launches"),
               "apsp_square": (ap.apsp_square_cuda, "launches"),
               "minplus": (mp.minplus_cuda, "launches"),
               "flow_accumulate": (fa.flow_accum_cuda, "launches"),
               "selective_scan_fwd": (ss.selective_scan_fwd_cuda, "launches"),
               "selective_scan_bwd": (ss.selective_scan_bwd_cuda, "launches")}
    path_launches: dict[str, dict] = {}

    def zero_counts() -> None:
        for fn, counter in kernels.values():
            setattr(fn, counter, 0)

    def read_counts(path: str, needs: tuple) -> dict:
        counts = {name: getattr(fn, counter)
                  for name, (fn, counter) in kernels.items()}
        path_launches[path] = counts
        missing = [name for name in needs if counts[name] == 0]
        if missing:
            fail(f"the {path} path launched no {missing} kernel")
        return counts

    # -- 1. build ------------------------------------------------------------
    # the port's sources and, beside them, the first designs that phases 2,
    # 6, 7 and 12 hold the kernels bit-equal to: the scan forward's (one
    # thread per channel), load propagation's and the fused APSP's; every
    # nvcc starts at once
    t0 = time.perf_counter()
    firsts = [sfs.start_build("one_thread"), lps.start_build("first"),
              aps.start_build("first")]
    secs = build.build_all()
    one_thread, lp_first, ap_first = [
        tool.finish_build(h)[0] for tool, h in zip((sfs, lps, aps), firsts)]
    secs = time.perf_counter() - t0
    log(f"phase 1: built {list(build.SOURCES)} and the first designs of the "
        f"scan forward, load propagation and the fused APSP in {secs:.3f} s")
    ptxas = ptxas_report(build.BUILD_LOGS)
    for kernel, rec in ptxas.items():
        log(f"  ptxas {kernel}: {rec}")
    print(json.dumps({"ptxas": ptxas}), flush=True)
    stacked = [k for k, rec in ptxas.items()
               if k.startswith(("ssm_fwd", "minplus", "load_prop",
                                "apsp_fused")) and rec["stack_frame"]]
    if stacked:
        fail(f"phase 1: {stacked} keep a stack frame")

    def lp_first_equal(nh, l0, hops, got) -> bool:
        """W and flow bit-equal to the first load-propagation design's."""
        want = lps.run(lp_first, "first", nh, l0, hops)
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

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
            if not lp_first_equal(nh_t, l0_t, hops, (w_k, f_k)):
                fail(f"phase 2: kernel W or flow differs from the first "
                     f"design's at n={n} B={batch}")
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
        f"err {max_err:.3g}, bit-equal to the first design; batch of 256 "
        f"bit-equal to solo")

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

    def kernel_record(nh, l0, hops):
        """The load-propagation kernel at one path shape: held against
        plain, timed (call, device, enqueue) and bounded."""
        nh = nh.to(torch.int32).contiguous()
        l0 = l0.to(torch.float32).contiguous()
        B, n, _ = nh.shape
        call = lambda: lp.load_prop_cuda(nh, l0, hops)
        w_k, f_k = call()
        w_p, f_p = plain(nh, l0, hops)
        err = max((w_k - w_p).abs().max().item(),
                  (f_k - f_p).abs().max().item())
        if not (torch.allclose(w_k, w_p, rtol=RTOL, atol=ATOL)
                and torch.allclose(f_k, f_p, rtol=RTOL, atol=ATOL)):
            fail(f"phase 6: kernel differs from plain at B={B} n={n}")
        if not lp_first_equal(nh, l0, hops, (w_k, f_k)):
            fail(f"phase 6: kernel W or flow differs from the first design's "
                 f"at B={B} n={n}")
        ms = time_cuda(torch, call)
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
                **call_device_ms(torch, call, LOAD_PROP_KERNELS),
                "enqueue_ms": enqueue_ms(torch, call),
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops, "max_abs_err": err}

    def batch_record(batch):
        return kernel_record(batch.next_hop,
                             _dest_major_load0(batch.next_hop, batch.traffic),
                             batch.max_hops)

    chunks = [encode_designs(points[i:i + 60], validate=False, device=dev)
              for i in range(0, len(points), 60)]
    chunk_recs = [batch_record(b) for b in chunks]
    large_rec = batch_record(encode_designs(big, validate=False, device=dev))
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
    log(f"phase 6: load-propagation launches on the sweep paths: "
        f"{sum(launches.values())} ({launches})")

    # -- 7-11. min-plus kernels, device routing, genome cost function --------
    minplus_records, genome_lp = minplus_paths(
        torch, dev, zero_counts, read_counts,
        lambda d, it: aps.run(ap_first, d, it))
    genome_rec = dict(kernel_record(*genome_lp), path="genomes_adjacency_32")
    print(json.dumps({"kernel_shapes": chunk_recs + [large_rec, genome_rec]}),
          flush=True)

    # -- 12-14. selective scan, training, pair-walk oracle --------------------
    scan_records, training = scan_and_training_paths(
        torch, dev, zero_counts, read_counts, max_sm_clock_hz(),
        lambda *args, chunk: sfs.forward(one_thread, *args, chunk))
    flow_record = flow_paths(torch, dev, zero_counts, read_counts)
    print(json.dumps({"training": training}), flush=True)

    # -- 15-16. the fault grid and the optimizer ------------------------------
    faults_rec = fault_grid_path(torch, dev, zero_counts, read_counts,
                                 lp_first_equal)
    print(json.dumps({"faults_grid": faults_rec}), flush=True)
    opt_rec = optimizer_path(torch, dev, zero_counts, read_counts)
    print(json.dumps({"optimizer": opt_rec}), flush=True)

    # -- 17-18. the search service and the simulator --------------------------
    serve_rec = serve_path(torch, dev, zero_counts, read_counts)
    print(json.dumps({"serve": serve_rec}), flush=True)
    sim_rec = simulator_path(torch, dev)
    print(json.dumps({"simulator": sim_rec}), flush=True)

    # -- 19-20. checkpointed training, trace import, pictures; the gate ------
    resume_rec = resume_trace_paths(torch, dev, zero_counts, read_counts)
    print(json.dumps({"resume_trace": resume_rec}), flush=True)
    analysis_rec = analysis_path(torch, dev, zero_counts, read_counts)
    print(json.dumps({"analysis": analysis_rec}), flush=True)

    # -- 21. serving every decoder-only config ---------------------------------
    phases_1_20_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    kept: dict = {}
    serve_models_rec = serve_models_path(torch, dev, zero_counts, read_counts,
                                         kept)
    serve_models_rec.update(phase_s=time.perf_counter() - t0,
                            phases_1_20_s=phases_1_20_s)
    print(json.dumps({"serve_models": serve_models_rec}), flush=True)
    log(f"phase 21: {serve_models_rec['phase_s']:.1f} s (phases 1-20 took "
        f"{phases_1_20_s:.1f} s)")

    # -- 22. training every family -------------------------------------------
    t0 = time.perf_counter()
    train_rec = train_families_path(torch, dev, zero_counts, read_counts,
                                    max_sm_clock_hz(), kept)
    train_rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"train_families": train_rec}), flush=True)
    log(f"phase 22: {train_rec['phase_s']:.1f} s ({train_rec['card']})")
    scan_records[1]["at_hybrid_width"] = {
        k: train_rec["b8_hybrid"][k] for k in (
            "arch", "shape", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "max_abs_err")}

    # -- 23. the dry-run and sharding stack ------------------------------------
    t0 = time.perf_counter()
    dryrun_rec = dryrun_sharding_path(torch, dev, zero_counts, read_counts,
                                      kernel_record)
    dryrun_rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"dryrun_sharding": dryrun_rec}), flush=True)
    log(f"phase 23: {dryrun_rec['phase_s']:.1f} s ({dryrun_rec['card']})")

    # -- 24. population sharding -----------------------------------------------
    t0 = time.perf_counter()
    sharding_rec = population_sharding_path(torch, dev, zero_counts,
                                            read_counts, points)
    sharding_rec.update(phase_s=time.perf_counter() - t0, card=card_line())
    print(json.dumps({"population_sharding": sharding_rec}), flush=True)
    log(f"phase 24: {sharding_rec['phase_s']:.1f} s ({sharding_rec['card']})")

    # -- 25. sharded training over a device mesh ------------------------------
    t0 = time.perf_counter()
    mesh_rec = mesh_training_path(torch, dev, zero_counts, read_counts)
    mesh_rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"mesh_training": mesh_rec}), flush=True)
    log(f"phase 25: {mesh_rec['phase_s']:.1f} s ({mesh_rec['card']})")

    # -- 26. serving on a device mesh ----------------------------------------
    t0 = time.perf_counter()
    serve_mesh_rec = mesh_serving_path(torch, dev, zero_counts, read_counts)
    serve_mesh_rec["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"mesh_serving": serve_mesh_rec}), flush=True)
    log(f"phase 26: {serve_mesh_rec['phase_s']:.1f} s "
        f"({serve_mesh_rec['card']})")

    totals = {name: sum(c[name] for c in path_launches.values())
              for name in kernels}
    print(json.dumps({"path_launches": path_launches}), flush=True)
    log(f"kernel launches over all paths: {totals}")
    log(f"wall {time.perf_counter() - t_start:.1f} s")

    # B1 and B2: one slab kernel, its launches split at the reference's
    # tier boundary, each timed at a shape of its own tier
    def load_prop_record(name, replaces, rec, launches):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/load_prop.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "device_ms": rec["device_ms"],
                "device_ms_per_launch": rec["device_ms_per_launch"],
                "enqueue_ms": rec["enqueue_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "shape": rec["shape"], "max_hops": rec["max_hops"]}

    # the paths whose load propagation runs above 160 nodes, where the
    # reference ran its tiled kernel: the 256-chiplet points and genomes
    tiled = sum(path_launches[p]["load_propagate"]
                for p in ("large_n", "genomes_adjacency_256",
                          "sharding_adjacency_256"))
    tiled += analysis_rec["contracts"]["ops.load_propagate[slab,n=256,B=2]"][
        "launches"].get("load_prop_cuda", 0)
    # the 16 x 16 pod's estimates and the layout rankings (n = 256)
    tiled += sum(path_launches[p]["load_propagate"]
                 for p in ("ici_model_16x16", "autoshard"))
    fused_rec = dict(head, max_abs_err=max(
        [max_err] + [r["max_abs_err"] for r in chunk_recs]))
    records = [
        load_prop_record("load_propagate",
                         "src/repro/kernels/load_prop.py:144", fused_rec,
                         totals["load_propagate"] - tiled),
        load_prop_record("load_propagate_tiled",
                         "src/repro/kernels/load_prop.py:279", large_rec,
                         tiled)]
    for rec in minplus_records + [flow_record] + scan_records:
        records.append(dict(rec, launches=totals[rec["name"]]))
    print(json.dumps({"kernels": records}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
