"""Batched DSE evaluation engine, sharded over a list of devices; port of
``src/repro/dse/engine.py``.

The engine is:

* **chunked** — bounded device memory regardless of sweep size;
* **checkpointed** — each finished chunk's results land in a resumable
  on-disk cursor file (idempotent work units; a restart skips completed
  points);
* **overlapped** — host-side encoding of chunk i+1 (graph + routing-table
  construction, structure-cache lookups) runs on a worker thread while the
  device evaluates chunk i.

It shards every batch's design axis over ``devices``, the port's
counterpart of the reference's ``mesh``: ``devices=None`` is every visible
card (raises without a GPU), as the reference's default mesh is every
device, so the engine stays elastic; ``device=x`` means ``devices=[x]``. A
list may repeat a device. The shards are equal and contiguous, dispatched
in shard order from one host thread and collected in shard order, and each
runs its own adaptive loops. ``evaluate_genomes`` is the optimizer's cost
function (``dse.genomes``), ``evaluate_genomes_faults_async`` its [P, F]
fault grid.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..core.latency import latency_proxy, num_doubling_steps, path_cost_doubling
from ..core.throughput import throughput_proxy
from ..obs.log import get_logger
from ..obs.trace import span as _span
from ..utils.device import gather_rows, on_device, resolve_devices
from .batch import DesignBatch, encode_designs
from .sweep import DesignPoint

_LOG = get_logger("dse")


@dataclass
class DseResult:
    latency: np.ndarray      # [B] f32
    throughput: np.ndarray   # [B] f32
    points: list

    def to_rows(self) -> list[dict]:
        rows = []
        for i, pt in enumerate(self.points):
            rows.append({
                "index": pt.index, "topology": pt.topology,
                "n_chiplets": pt.n_chiplets, "traffic": pt.traffic_pattern,
                "routing": pt.routing, "seed": pt.seed,
                "shg_bits": pt.shg_bits,
                "latency": float(self.latency[i]),
                "throughput": float(self.throughput[i]),
            })
        return rows


def batched_evaluate(next_hop: torch.Tensor, step_cost: torch.Tensor,
                     node_weight: torch.Tensor, adj_bw: torch.Tensor,
                     traffic: torch.Tensor, n_steps: int, max_hops: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both proxies over the design axis: latency [B], throughput [B]."""
    plat = path_cost_doubling(next_hop, step_cost, node_weight, n_steps)
    lat = latency_proxy(plat, traffic)
    # adaptive: the plain flow loop stops once every route has delivered
    # (same flows — converged loads propagate zeros); the kernel stops each
    # destination slab on its own
    thr = throughput_proxy(next_hop, adj_bw, traffic, max_hops=max_hops,
                           adaptive=True)
    return lat, thr


class DseEngine:
    def __init__(self, chunk_size: int = 256, device=None, devices=None,
                 checkpoint_path: str | None = None, prefetch: bool = True):
        if device is not None and devices is not None:
            raise ValueError("pass device= or devices=, not both")
        self.devices = resolve_devices(devices if device is None else device)
        self.device = self.devices[0]
        self.chunk_size = chunk_size
        self.checkpoint_path = checkpoint_path
        self.prefetch = prefetch
        self._done: dict[int, tuple[float, float]] = {}
        self._genome_pipelines: dict[int, tuple] = {}
        self._pipeline_lock = threading.Lock()
        if checkpoint_path and os.path.exists(checkpoint_path):
            with open(checkpoint_path) as f:
                for line in f:
                    rec = json.loads(line)
                    self._done[rec["index"]] = (rec["latency"], rec["throughput"])

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    # -- genome path (dse.genomes) ------------------------------------------
    def _genome_pipeline(self, space):
        """Per-space pipeline, built once and cached for the engine's
        lifetime (the key holds a strong reference to the space, so ids
        stay unique). Lock-guarded: concurrent callers over one shared
        space get ONE pipeline."""
        from .genomes import make_pipeline
        with self._pipeline_lock:
            cached = self._genome_pipelines.get(id(space))
            if cached is not None and cached[0] is space:
                return cached[1]
            pipeline = make_pipeline(space, self.devices)
            self._genome_pipelines[id(space)] = (space, pipeline)
            return pipeline

    def supports_genomes(self, space) -> bool:
        """True when ``evaluate_genomes`` has a device path for this space."""
        return self._genome_pipeline(space) is not None

    def evaluate_genomes(self, space, genomes):
        """From a genome population to metrics on the engine's device, with
        no DesignPoint materialization: decode, geometry, routing tables
        and proxies (see ``dse.genomes``). Genomes must be valid
        (``space.repair`` output). Raises ValueError for spaces whose
        structures the device path cannot reproduce (use
        ``evaluate_points``)."""
        return self.evaluate_genomes_async(space, genomes).result()

    def evaluate_genomes_async(self, space, genomes):
        """``evaluate_genomes`` without waiting for the device: returns a
        ``PendingGenomeEval`` whose ``result()`` waits on the CUDA event of
        the last launch and adds the host reports."""
        pipeline = self._genome_pipeline(space)
        if pipeline is None:
            raise ValueError(
                f"no device genome path for {type(space).__name__} "
                f"(routing {getattr(space, 'routing', None)!r}); "
                f"use evaluate_points")
        return pipeline.evaluate_async(genomes)

    def supports_faults(self, space) -> bool:
        """True when ``evaluate_genomes_faults_async`` has a device path:
        the fault grid exists for the adjacency pipeline only."""
        pipeline = self._genome_pipeline(space)
        return pipeline is not None and hasattr(pipeline,
                                                "evaluate_faults_async")

    def evaluate_genomes_faults_async(self, space, genomes, link_fail,
                                      node_fail):
        """The [P, F] population x fault grid: every genome under every
        fault scenario in one batch on the engine's device; ``result()``
        returns a ``dse.genomes.FaultGridResult``."""
        if not self.supports_faults(space):
            raise ValueError(
                f"no device fault-grid path for {type(space).__name__} "
                f"(routing {getattr(space, 'routing', None)!r})")
        return self._genome_pipeline(space).evaluate_faults_async(
            genomes, link_fail, node_fail)

    def _pad_chunk(self, batch: DesignBatch) -> tuple[DesignBatch, int]:
        """Pad the chunk's design axis to a device-count multiple with
        copies of its last design (elastic)."""
        b = batch.size
        mult = self.n_devices
        pad = -b % mult
        if pad == 0:
            return batch, b

        def padb(x):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

        return DesignBatch(
            next_hop=padb(batch.next_hop), step_cost=padb(batch.step_cost),
            node_weight=padb(batch.node_weight), adj_bw=padb(batch.adj_bw),
            traffic=padb(batch.traffic), max_hops=batch.max_hops,
            points=batch.points), b

    def evaluate_batch(self, batch: DesignBatch) -> DseResult:
        """Both proxies over the chunk, one equal contiguous shard of its
        design axis on each device."""
        with _span("dse.evaluate_batch", b=batch.size, n=batch.n,
                   shards=self.n_devices):
            padded, b_real = self._pad_chunk(batch)
            s = padded.size // self.n_devices
            n_steps = num_doubling_steps(padded.n)
            outs = []
            for i, dev in enumerate(self.devices):
                rows = slice(i * s, (i + 1) * s)
                args = [x[rows].to(dev) for x in (
                    padded.next_hop, padded.step_cost, padded.node_weight,
                    padded.adj_bw, padded.traffic)]
                with on_device(dev):
                    outs.append(batched_evaluate(
                        *args, n_steps=n_steps, max_hops=padded.max_hops))
            lat, thr = zip(*outs)
            return DseResult(latency=gather_rows(lat, b_real),
                             throughput=gather_rows(thr, b_real),
                             points=batch.points)

    def evaluate_points(self, points: list[DesignPoint],
                        validate: bool = False, n_pad: int | None = None,
                        round_hops: bool = False,
                        keep_designs: bool = False) -> DseResult:
        """Population evaluation without cursor bookkeeping. Encodes through
        the shared structure cache and evaluates one padded batch.

        ``n_pad`` pads every population to a fixed node count and
        ``round_hops`` rounds the static hop bound up to the next power of
        two (capped at n - 1), as the reference does to keep its compiled
        shapes stable; extra hops are exact no-ops. ``keep_designs`` retains
        built Designs in the structure cache."""
        batch = encode_designs(points, n_pad=n_pad, validate=validate,
                               keep_designs=keep_designs, device=self.device)
        if round_hops:
            mh = 1
            while mh < batch.max_hops:
                mh *= 2
            batch.max_hops = min(mh, max(batch.n - 1, 1))
        return self.evaluate_batch(batch)

    def _finish_chunk(self, batch: DesignBatch,
                      results: dict[int, tuple[float, float]]) -> None:
        """Evaluate one encoded chunk, fold results in, checkpoint."""
        res = self.evaluate_batch(batch)
        rows = res.to_rows()
        for row in rows:
            results[row["index"]] = (row["latency"], row["throughput"])
        if self.checkpoint_path:
            with _span("dse.checkpoint", rows=len(rows)):
                with open(self.checkpoint_path, "a") as f:
                    for row in rows:
                        f.write(json.dumps(row) + "\n")

    def run(self, points: list[DesignPoint], validate: bool = False,
            progress: bool = False) -> DseResult:
        """Evaluate a sweep with chunking + resumable checkpointing.

        With ``prefetch`` (default) the host encodes chunk i+1 on a worker
        thread while the device evaluates chunk i. The structure cache is
        thread-safe; checkpoint writes stay on the caller thread, in chunk
        order, so resume semantics are unchanged.
        """
        todo = [pt for pt in points if pt.index not in self._done]
        results: dict[int, tuple[float, float]] = dict(self._done)
        chunks = [todo[i:i + self.chunk_size]
                  for i in range(0, len(todo), self.chunk_size)]

        def encode(chunk):
            with _span("dse.encode", b=len(chunk)):
                return encode_designs(chunk, validate=validate,
                                      device=self.device)

        def report(ci):
            done = min((ci + 1) * self.chunk_size, len(todo))
            _LOG.log("info" if progress else "debug",
                     f"[dse] {done}/{len(todo)} designs evaluated")

        if self.prefetch and len(chunks) > 1:
            with ThreadPoolExecutor(max_workers=1) as pool:
                pending = pool.submit(encode, chunks[0])
                for ci in range(len(chunks)):
                    batch = pending.result()
                    if ci + 1 < len(chunks):
                        pending = pool.submit(encode, chunks[ci + 1])
                    self._finish_chunk(batch, results)
                    report(ci)
        else:
            for ci, chunk in enumerate(chunks):
                self._finish_chunk(encode(chunk), results)
                report(ci)

        lat = np.asarray([results[pt.index][0] for pt in points], np.float32)
        thr = np.asarray([results[pt.index][1] for pt in points], np.float32)
        return DseResult(latency=lat, throughput=thr, points=list(points))


__all__ = ["DseEngine", "DseResult", "batched_evaluate"]
