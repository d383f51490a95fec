"""Load driver of the fault-aware genome cost function.

Set-up builds the port's ``AdjacencySpace`` and ``DseEngine``, draws the
parent pool and the fault scenarios from the seed and runs the mix's
warm-up calls, whose first launches load the port's kernels from
``build/repro_torch/`` in the checkout (nvcc runs there on a checkout's
first run only; ``setup_s`` includes it, and the result's ``setup`` key
names what this run built and times each warm-up call apart). The window is a closed loop of
``in_flight`` calls, each: ``space.repair`` of a fresh offspring
population (made ahead by a producer thread), then
``engine.evaluate_genomes_faults_async`` and ``.result()``. A call is timed
from the start of its repair to its result in hand; the window runs from
the first call's start to the last call's result, and no call starts once
``seconds`` have passed.

A sample of the window's calls, drawn from the seed, is kept and compared
with the plain reference (``perfbench/reference``) once the window has
closed and the program's state is freed. A traced run adds the program's
spans and counters over the window, and then profiles ``trace_calls`` more
calls under ``torch.profiler``, drained at both ends.
"""
from __future__ import annotations

import heapq
import queue
import sys
import threading
import time
from collections import deque
from contextlib import nullcontext

from perfbench import compare, devtrace
from perfbench.gen.traffic import FaultGridMix, seeded_rng
from perfbench.harness import Outcome, Readings

PRIORITY = 7            # seed stream of the compared calls' sample


def _log(t0: float, msg: str) -> None:
    print(f"[{time.perf_counter() - t0:8.2f} s] {msg}", file=sys.stderr,
          flush=True)


class _Producer:
    """Offspring of calls 0, 1, ... made ahead on one thread (NumPy's
    generators and array loops release the interpreter lock)."""

    def __init__(self, mix: FaultGridMix, depth: int, start: int = 0,
                 warmup: bool = False):
        self._mix, self._warmup = mix, warmup
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next = start
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="offspring")
        self._thread.start()

    def _loop(self):
        i = self._next
        try:
            while not self._stop.is_set():
                item = (i, self._mix.offspring(i, warmup=self._warmup))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                i += 1
        except BaseException as exc:     # handed to the consumer by get()
            self._error = exc

    def get(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError("the offspring thread ended") \
                        from self._error

    def wait_full(self, timeout: float = 300.0):
        """Block until the queue holds ``depth`` populations."""
        t_end = time.perf_counter() + timeout
        while not self._q.full():
            if not self._thread.is_alive():
                raise RuntimeError("the offspring thread ended") \
                    from self._error
            if time.perf_counter() > t_end:
                raise RuntimeError("the offspring thread fell behind")
            time.sleep(0.005)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            raise RuntimeError("the offspring thread did not stop")


def _loop(calls, producer, repair, evaluate, space, masks, in_flight,
          until=None, n_calls=None, annotate=None, on_done=None):
    """The closed loop; returns (records, t_start, t_end). A record is
    (call index, seconds, repair seconds)."""
    ann = annotate or (lambda name: nullcontext())
    inflight: deque = deque()
    records = []

    def finish():
        i, t0, rep, handle, rep_s = inflight.popleft()
        with ann("bench.result"):
            res = handle.result()
        t1 = time.perf_counter()
        records.append((i, t1 - t0, rep_s))
        if on_done is not None:
            on_done(i, rep, res)
        return t1

    t_start = time.perf_counter()
    t_end = t_start
    submitted = 0
    while True:
        if until is not None and time.perf_counter() >= t_start + until:
            break
        if n_calls is not None and submitted >= n_calls:
            break
        with ann("bench.queue"):
            i, raw = producer.get()
        t0 = time.perf_counter()
        with ann("bench.repair"):
            rep = repair(raw)
        rep_s = time.perf_counter() - t0
        with ann("bench.dispatch"):
            handle = evaluate(space, rep, *masks)
        inflight.append((i, t0, rep, handle, rep_s))
        submitted += 1
        calls.append(i)
        if len(inflight) >= in_flight:
            t_end = finish()
    while inflight:
        t_end = finish()
    return records, t_start, t_end


def run(spec, *, seed, seconds, trace, t0, device, program=None):
    import torch

    import repro_torch.core  # noqa: F401  (the routing package's import cycle)
    from repro_torch.dse import DseEngine
    from repro_torch.obs import metrics as pmetrics
    from repro_torch.obs import trace as ptrace
    from repro_torch.opt import AdjacencySpace

    cfg, mix_p, limits = spec["config"], spec["mix"], spec["limits"]
    n, maxd = int(cfg["n_chiplets"]), int(cfg["max_degree"])
    space = AdjacencySpace(n_chiplets=n, max_degree=maxd,
                           traffic_pattern=cfg["traffic_pattern"],
                           routing=cfg["routing"])
    engine = DseEngine(device=device)
    repair = space.repair
    evaluate = engine.evaluate_genomes_faults_async
    if program and "repair" in program:
        repair = program["repair"](space)
    if program and "evaluate" in program:
        evaluate = program["evaluate"](engine)
    mix = FaultGridMix(mix_p, n, maxd, seed)
    _log(t0, f"inputs drawn: pool {len(mix.pool)}, scenarios {mix.n_scenarios}")
    masks = (mix.link_fail, mix.node_fail)
    in_flight = int(mix_p["in_flight"])
    depth = in_flight + 1

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    # warm-up: the cell's own shapes, through the same loop
    warm = _Producer(mix, depth, warmup=True)
    try:
        warm_records, _, _ = _loop([], warm, repair, evaluate, space, masks,
                                   in_flight,
                                   n_calls=int(mix_p["warmup_calls"]))
    finally:
        warm.close()
    sync()
    from repro_torch.kernels.build import BUILD_LOGS
    setup_parts = {"built": sorted(BUILD_LOGS),
                   "warmup_call_s": [r[1] for r in warm_records]}
    _log(t0, f"warm-up done: built {setup_parts['built']}, calls "
             f"{setup_parts['warmup_call_s']} s")

    # the window
    keep = int(mix_p["compare_calls"])
    kept: list = []                     # heap of (-priority, index, rep, res)

    def on_done(i, rep, res):
        prio = seeded_rng(seed, PRIORITY, i).random()
        item = (-prio, i, rep, res)
        if len(kept) < keep:
            heapq.heappush(kept, item)
        elif item > kept[0]:
            heapq.heapreplace(kept, item)

    def counter_total(name):
        return sum(c.value for c in pmetrics.REGISTRY.series("Counter", name))

    syncs0 = counter_total("routing.host_sync")
    if trace:
        ptrace.enable_tracing(clear=True)
    producer = _Producer(mix, depth)
    calls: list = []
    try:
        producer.wait_full()
        setup_s = time.perf_counter() - t0
        records, w0, w1 = _loop(calls, producer, repair, evaluate, space,
                                masks, in_flight, until=seconds,
                                on_done=on_done)
    finally:
        producer.close()
    spans = None
    if trace:
        ptrace.disable_tracing()
        spans = {}
        for rec in ptrace.TRACER.to_dicts():
            spans[rec["name"]] = spans.get(rec["name"], 0.0) \
                + rec["dur_us"] / 1e6
    syncs = counter_total("routing.host_sync") - syncs0
    _log(t0, f"window: {len(records)} calls in {w1 - w0:.3f} s")
    memory_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else 0)
    rows = mix.population * mix.n_scenarios
    readings = Readings(
        setup_s=setup_s, window_s=w1 - w0, calls=len(records),
        call_s=[r[1] for r in records], evaluations=rows * len(records),
        repair_s=sum(r[2] for r in records) if trace else None,
        spans=spans, counters={"routing.host_sync": syncs})

    breakdown = None
    if trace:
        tp = _Producer(mix, depth, start=max(calls) + 1)
        try:
            readings.device, breakdown = devtrace.profile(
                lambda ann: _loop([], tp, repair, evaluate, space, masks,
                                  in_flight,
                                  n_calls=int(mix_p["trace_calls"]),
                                  annotate=ann),
                calls=int(mix_p["trace_calls"]), device=device, rows=rows,
                n=n, max_degree=maxd)
        finally:
            tp.close()

    # free the program's state before the reference runs
    del engine, evaluate
    sync()
    if device == "cuda":
        torch.cuda.empty_cache()
    _log(t0, f"comparing {len(kept)} calls with the reference")
    checks = compare.check_calls(
        sorted((i, rep, res) for _, i, rep, res in kept), mix, n, maxd,
        device, limits)
    _log(t0, "compared")
    return Outcome(readings=readings, checks=checks, attempted=len(calls),
                   setup_parts=setup_parts,
                   failed=len(calls) - len(records),
                   memory_peak_bytes=int(memory_peak), breakdown=breakdown)
