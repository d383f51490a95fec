# Port of src/repro/opt/runner.py: the same runner, checkpoints and CLI, plus
# --device (the card by default).
"""Checkpointable optimizer runner + CLI.

Mirrors the DSE engine's cursor-file story at the optimizer level: after
every generation the full optimizer state — RNG stream, population, archive,
evaluation count — is written atomically to a JSON checkpoint. A run that is
killed mid-search resumes from the checkpoint and reproduces exactly the
archive an uninterrupted run would have produced (asserted in
``tests/test_torch_opt.py``).

CLI (``--device`` picks the engine's devices: ``cuda``, the default, shards
the population over every visible card, as the reference's default mesh
spans every device (``CUDA_VISIBLE_DEVICES`` chooses which), or ``cpu``
for the plain PyTorch path on one host device)::

    PYTHONPATH=src python -m repro_torch.opt --space adjacency \
        --n-chiplets 32 --algo nsga2 --generations 20 --pop-size 24 \
        --max-interposer-area 2500 --checkpoint opt_ckpt.json --out front.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from ..faults.harness import (CheckpointCorruptError, graceful_shutdown,
                              json_digest)
from ..obs import metrics as _metrics
from ..obs.log import get_logger
from ..obs.trace import enable_tracing, span as _span
from ..utils.device import cli_devices
from ..utils.version import check_version_stamp, version_stamp
from .algorithms import ALGORITHMS, Budgets, OptimizerBase, PopulationEvaluator
from .archive import ParetoArchive
from .space import AdjacencySpace, ParametricSpace, SearchSpace

_LOG = get_logger("opt")


@dataclass
class OptResult:
    archive: ParetoArchive
    n_evals: int
    generations: int
    # Per-generation hypervolume for the generations executed by *this*
    # run() call: history[i] belongs to generation history_start + 1 + i.
    # After a checkpoint resume, history_start > 0 and pre-resume
    # generations have no entries.
    history: list = field(default_factory=list)
    history_start: int = 0

    def to_rows(self, space: SearchSpace | None = None) -> list[dict]:
        rows = []
        for e in self.archive.front():
            row = {"latency": e.latency, "throughput": e.throughput,
                   **e.metrics}
            if space is not None and e.payload is not None:
                row.update(space.describe(np.asarray(e.payload, np.int64)))
            rows.append(row)
        return rows


def save_checkpoint(path: str, optimizer: OptimizerBase,
                    meta: dict | None = None) -> None:
    """Atomic write so a kill mid-dump never corrupts the resume point.
    ``meta`` substitutes a snapshot of the RNG/eval-count/generation triple
    captured earlier (the async driver's deferred checkpointing). The
    snapshot carries a version stamp so a resume from a different
    repro/torch version warns instead of silently mixing trajectories.

    Format 2: the state is wrapped in an envelope with a
    canonical sha256, the bytes are fsynced before the atomic rename, and
    the previous snapshot is rotated to ``<path>.prev`` first — so a
    SIGKILL at any instant leaves either the new verified snapshot, the
    old verified snapshot, or both, never a torn resume point."""
    with _span("opt.checkpoint", path=path):
        state = optimizer.state(meta)
        state["versions"] = version_stamp()
        payload = {"format": 2, "sha256": json_digest(state), "state": state}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            os.replace(path, path + ".prev")
        os.replace(tmp, path)


class AsyncStepper:
    """Double-buffered generation pipeline over ``OptimizerBase``'s
    begin/finish split.

    Each ``step()`` completes exactly one generation, but in pipelined
    order: first the *previous* generation's deferred work (archive ingest,
    hypervolume, checkpoint write) runs while the current generation's
    device call — dispatched at the end of the previous ``step()`` with
    ``PopulationEvaluator.dispatch`` — is still in flight; only then does
    the driver block on the device, fold the results in, and dispatch the
    next generation. The RNG stream, archive contents, per-generation
    checkpoints, and eval counts are bit-identical to synchronous stepping
    (asserted in tests/test_torch_opt.py): every RNG draw happens in the same
    order, the deferred ingest feeds no selection decision, and checkpoints
    are built from a state snapshot taken before the next generation's
    draws.

    ``on_generation(optimizer, meta, ev)`` runs inside the overlap window,
    after the deferred ingest — the place for checkpoint writes and
    progress reporting.
    """

    def __init__(self, optimizer: OptimizerBase, generations: int,
                 on_generation=None):
        self.optimizer = optimizer
        self.generations = generations
        self.on_generation = on_generation
        self._pending = None
        self._deferred = None

    def _flush_deferred(self) -> None:
        if self._deferred is None:
            return
        ev, meta = self._deferred
        self._deferred = None
        # This is the host work hidden behind the in-flight device call;
        # its duration vs the subsequent device wait is the async overlap
        # efficiency reported by obs.report.
        t0 = time.perf_counter()
        with _span("opt.flush_deferred", generation=meta["generation"]):
            self.optimizer._ingest(ev)
            if self.on_generation is not None:
                self.on_generation(self.optimizer, meta, ev)
        _metrics.counter("opt.async.host_s").inc(time.perf_counter() - t0)

    def step(self) -> bool:
        """Complete one generation; returns False once the target count is
        reached (after flushing the last generation's deferred work)."""
        opt = self.optimizer
        t_start = time.perf_counter()
        # Deferred work of generation g-1 executes while generation g's
        # dispatched evaluation runs on the device.
        self._flush_deferred()
        if opt.generation >= self.generations:
            return False
        if self._pending is None:
            self._pending = opt.evaluator.dispatch(opt.begin_step())
        t0 = time.perf_counter()
        with _span("opt.device_wait", generation=opt.generation):
            ev = self._pending.result()
        _metrics.counter("opt.async.wait_s").inc(time.perf_counter() - t0)
        self._pending = None
        with _span("opt.generation", generation=opt.generation,
                   mode="async"):
            opt.finish_step(ev, ingest=False)
            meta = opt.snapshot_meta()
            if opt.generation < self.generations:
                # dispatch generation g+1 before generation g's bookkeeping:
                # the device computes through the entire deferred window
                self._pending = opt.evaluator.dispatch(opt.begin_step())
        self._deferred = (ev, meta)
        dt = time.perf_counter() - t_start
        _metrics.histogram("opt.generation_s").observe(dt)
        if dt > 0:
            _metrics.histogram("opt.evals_per_s").observe(
                len(ev.latency) / dt)
        return True

    def run(self, stop=None) -> None:
        while self.step():
            if stop is not None and stop.requested():
                break
        self.drain()

    def drain(self) -> None:
        """Finish the in-flight generation (its device work is already
        paid for) and flush deferred bookkeeping, so an early exit leaves
        the same per-generation checkpoint a full run would have written
        at this point."""
        self._flush_deferred()
        if self._pending is None:
            return
        opt = self.optimizer
        ev = self._pending.result()
        self._pending = None
        opt.finish_step(ev, ingest=False)
        meta = opt.snapshot_meta()
        opt._ingest(ev)
        if self.on_generation is not None:
            self.on_generation(opt, meta, ev)


def load_checkpoint(path: str) -> dict:
    """Load ONE checkpoint file, verifying the format-2 sha256 envelope.
    Pre-format-2 flat states (no envelope) load without verification.
    Raises ``CheckpointCorruptError`` on digest mismatch and the usual
    OSError/JSONDecodeError on unreadable bytes."""
    with open(path) as f:
        payload = json.load(f)
    if isinstance(payload, dict) and payload.get("format") == 2:
        state = payload["state"]
        want = payload.get("sha256")
        if want is not None and json_digest(state) != want:
            raise CheckpointCorruptError(f"{path}: sha256 mismatch "
                                         f"(torn or tampered snapshot)")
        return state
    return payload


def load_checkpoint_resilient(path: str) -> tuple[dict | None, str | None]:
    """Warn-then-fall-back resume ladder: try ``path``, then the rotated
    ``path.prev``; a candidate that is corrupt or unreadable logs a warning
    and bumps ``ckpt.corrupt`` instead of crashing the run. Returns
    ``(state, source_path)`` or ``(None, None)`` when nothing loads."""
    for cand in (path, path + ".prev"):
        if not os.path.exists(cand):
            continue
        try:
            return load_checkpoint(cand), cand
        except Exception as e:
            _metrics.counter("ckpt.corrupt", stage="opt").inc()
            _LOG.warning(f"[opt] checkpoint {cand} rejected "
                         f"({type(e).__name__}: {e}); trying fallback")
    return None, None


class OptRunner:
    """Drives an optimizer for N generations with per-generation
    checkpointing and optional hypervolume tracking.

    ``async_pipeline=True`` swaps the stepping loop for the double-buffered
    ``AsyncStepper``: generation g+1's device evaluation is dispatched
    before generation g's archive ingest, hypervolume bookkeeping, and
    checkpoint write, which then overlap the in-flight device call. The RNG
    stream, archive, and every per-generation checkpoint stay bit-identical
    to the synchronous loop, so the two modes are freely interchangeable
    (even across a resume)."""

    def __init__(self, optimizer: OptimizerBase,
                 checkpoint_path: str | None = None,
                 ref_latency: float | None = None,
                 ref_throughput: float = 0.0,
                 async_pipeline: bool = False):
        self.optimizer = optimizer
        self.checkpoint_path = checkpoint_path
        self.ref_latency = ref_latency
        self.ref_throughput = ref_throughput
        self.async_pipeline = async_pipeline
        if checkpoint_path and (os.path.exists(checkpoint_path)
                                or os.path.exists(checkpoint_path + ".prev")):
            state, source = load_checkpoint_resilient(checkpoint_path)
            if state is None:
                _LOG.warning(f"[opt] no usable checkpoint at "
                             f"{checkpoint_path} (all candidates corrupt); "
                             f"starting fresh")
            else:
                if source != checkpoint_path:
                    _LOG.warning(f"[opt] resumed from fallback snapshot "
                                 f"{source}")
                for problem in check_version_stamp(state.get("versions"),
                                                  what="checkpoint"):
                    _LOG.warning(f"[opt] resume warning: {problem}")
                self.optimizer.load_state(state)

    def _after_generation(self, opt, meta, history, generations,
                          progress) -> None:
        if self.checkpoint_path:
            save_checkpoint(self.checkpoint_path, opt, meta)
        hv = None
        if self.ref_latency is not None:
            hv = opt.archive.hypervolume(self.ref_latency,
                                         self.ref_throughput)
            history.append(hv)
        msg = (f"[opt] gen {meta['generation']}/{generations} "
               f"evals={meta['n_evals']} "
               f"archive={len(opt.archive)}")
        if hv is not None:
            msg += f" hv={hv:.4g}"
        # progress=True keeps the classic stdout line (via the obs logging
        # root at INFO); progress=False still records it at DEBUG for
        # REPRO_LOG=debug runs.
        _LOG.log("info" if progress else "debug", msg)

    def run(self, generations: int, progress: bool = False) -> OptResult:
        opt = self.optimizer
        history = []
        history_start = opt.generation
        # SIGTERM/SIGINT set a pollable flag: the loop exits through its
        # normal checkpoint-flush path after the current generation, so a
        # preempted run resumes bit-identically (a second signal forces
        # KeyboardInterrupt).
        with graceful_shutdown() as stop:
            if self.async_pipeline:
                AsyncStepper(
                    opt, generations,
                    on_generation=lambda o, meta, ev: self._after_generation(
                        o, meta, history, generations, progress)).run(
                            stop=stop)
            else:
                while opt.generation < generations:
                    t0 = time.perf_counter()
                    n0 = opt.evaluator.n_evals
                    with _span("opt.generation", generation=opt.generation,
                               mode="sync"):
                        opt.step()
                        self._after_generation(opt, opt.snapshot_meta(),
                                               history, generations, progress)
                    dt = time.perf_counter() - t0
                    _metrics.histogram("opt.generation_s").observe(dt)
                    if dt > 0:
                        _metrics.histogram("opt.evals_per_s").observe(
                            (opt.evaluator.n_evals - n0) / dt)
                    if stop.requested():
                        break
            if stop.requested():
                _LOG.warning(f"[opt] shutdown at generation "
                             f"{opt.generation}/{generations}; checkpoint "
                             f"is current — rerun to resume")
        return OptResult(archive=opt.archive, n_evals=opt.evaluator.n_evals,
                         generations=opt.generation, history=history,
                         history_start=history_start)


def make_space(kind: str, **kw) -> SearchSpace:
    if kind == "adjacency":
        return AdjacencySpace(**kw)
    if kind == "parametric":
        return ParametricSpace(**kw)
    raise ValueError(f"unknown space {kind!r}; options: adjacency, parametric")


def make_optimizer(algo: str, space: SearchSpace,
                   evaluator: PopulationEvaluator, seed: int = 0,
                   **kw) -> OptimizerBase:
    try:
        cls = ALGORITHMS[algo]
    except KeyError:
        raise ValueError(f"unknown algorithm {algo!r}; options: "
                         f"{sorted(ALGORITHMS)}") from None
    return cls(space, evaluator, seed=seed, **kw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.opt",
        description="Population-based multi-objective ICI design "
                    "optimization on the batched proxy engine.")
    p.add_argument("--space", choices=("adjacency", "parametric"),
                   default="adjacency")
    p.add_argument("--algo", choices=sorted(ALGORITHMS), default="nsga2")
    p.add_argument("--n-chiplets", type=int, default=32,
                   help="adjacency space: chiplet count")
    p.add_argument("--max-degree", type=int, default=8,
                   help="adjacency space: soft per-chiplet link cap")
    p.add_argument("--counts", type=str, default="16,36,64",
                   help="parametric space: comma-separated chiplet counts")
    p.add_argument("--traffic", type=str, default="random_uniform")
    p.add_argument("--routing", type=str, default="dijkstra_lowest_id")
    p.add_argument("--generations", type=int, default=20)
    p.add_argument("--pop-size", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-interposer-area", type=float, default=None)
    p.add_argument("--max-total-area", type=float, default=None)
    p.add_argument("--max-power", type=float, default=None)
    p.add_argument("--max-cost", type=float, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device of the cost function: every visible GPU "
                        "(default; raises without one) or the plain "
                        "PyTorch path on the host")
    p.add_argument("--host-path", action="store_true",
                   help="force the classic host evaluation path "
                        "(decode -> DesignPoint -> structure cache) instead "
                        "of the fused device genome pipeline")
    p.add_argument("--async", dest="async_pipeline", action="store_true",
                   help="double-buffered generation pipeline: dispatch the "
                        "next generation's device call before archiving / "
                        "checkpointing the current one (bit-identical "
                        "results, lower wall-clock)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resume point, written after every generation")
    p.add_argument("--faults", action="store_true",
                   help="fault-aware search: evaluate every genome over a "
                        "batch of failure scenarios and optimize the "
                        "degraded (worst/expected) latency-throughput "
                        "front instead of the pristine one (adjacency "
                        "space, device path only)")
    p.add_argument("--fault-model", type=str, default="single",
                   help="fault scenario sampler: iid, region, single, "
                        "double, chiplet (see repro_torch.faults.model)")
    p.add_argument("--fault-p", type=float, default=0.02,
                   help="iid model: per-link failure probability")
    p.add_argument("--fault-scenarios", type=int, default=16,
                   help="iid/region models: sampled scenario count")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="fault sampler seed (independent of --seed)")
    p.add_argument("--fault-top-k", type=int, default=None,
                   help="single/double models: restrict enumeration to the "
                        "k longest-trace link slots")
    p.add_argument("--fault-mode", choices=("worst", "expected"),
                   default="worst",
                   help="robust objective: worst-case over scenarios or "
                        "scenario-weighted expectation")
    p.add_argument("--max-disconnect", type=float, default=0.0,
                   help="feasibility cap on the probability mass of "
                        "scenarios that disconnect any traffic")
    p.add_argument("--out", type=str, default=None,
                   help="write the final front as JSON rows")
    p.add_argument("--trace", type=str, nargs="?", const="opt_trace",
                   default=None, metavar="PREFIX",
                   help="enable full tracing and write <PREFIX>.trace.jsonl, "
                        "<PREFIX>.chrome.json (Perfetto-loadable), "
                        "<PREFIX>.metrics.json, and <PREFIX>.report.json "
                        "at the end of the run (default prefix: opt_trace)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    if args.trace:
        enable_tracing()

    if args.space == "adjacency":
        space = make_space("adjacency", n_chiplets=args.n_chiplets,
                           max_degree=args.max_degree,
                           traffic_pattern=args.traffic,
                           routing=args.routing)
    else:
        counts = tuple(int(c) for c in args.counts.split(","))
        space = make_space("parametric", chiplet_counts=counts,
                           traffic_pattern=args.traffic,
                           routings=(args.routing,))
    budgets = Budgets(max_interposer_area=args.max_interposer_area,
                      max_total_area=args.max_total_area,
                      max_power=args.max_power, max_cost=args.max_cost)
    faults = None
    if args.faults:
        if args.space != "adjacency":
            p.error("--faults requires --space adjacency")
        if args.host_path:
            p.error("--faults requires the fused device path "
                    "(drop --host-path)")
        from ..faults.model import make_scenarios
        from ..faults.objectives import FaultSetup, RobustObjectives
        kw: dict = {}
        if args.fault_model == "iid":
            kw = {"p": args.fault_p, "n_scenarios": args.fault_scenarios,
                  "seed": args.fault_seed}
        elif args.fault_model == "region":
            kw = {"n_scenarios": args.fault_scenarios,
                  "seed": args.fault_seed}
        elif args.fault_model in ("single", "double") \
                and args.fault_top_k is not None:
            kw = {"top_k": args.fault_top_k}
        scenarios = make_scenarios(space, args.fault_model, **kw)
        faults = FaultSetup(
            scenarios=scenarios,
            objectives=RobustObjectives(
                mode=args.fault_mode,
                max_disconnect_prob=args.max_disconnect))
        _LOG.info(f"[opt] fault-aware search: model={args.fault_model} "
                  f"F={scenarios.n_scenarios} mode={args.fault_mode}")
    evaluator = PopulationEvaluator(
        space, budgets=budgets,
        device_path=False if args.host_path else None,
        faults=faults, devices=cli_devices(args.device))
    size_kw = ({"batch_size": args.pop_size} if args.algo == "random"
               else {"n_chains": args.pop_size} if args.algo == "sa"
               else {"pop_size": args.pop_size})
    optimizer = make_optimizer(args.algo, space, evaluator, seed=args.seed,
                               **size_kw)
    runner = OptRunner(optimizer, checkpoint_path=args.checkpoint,
                       async_pipeline=args.async_pipeline)
    result = runner.run(args.generations, progress=not args.quiet)

    rows = result.to_rows(space)
    lvl = "debug" if args.quiet else "info"
    _LOG.log(lvl, f"[opt] {result.n_evals} evaluations, "
                  f"{len(result.archive)} points on the front:")
    for r in rows:
        _LOG.log(lvl,
                 f"   lat={r['latency']:8.2f} thr={r['throughput']:10.2f} "
                 f"area={r.get('interposer_area', float('nan')):8.1f} "
                 f"links={r.get('n_links', '-')}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
            f.write("\n")
        _LOG.log(lvl, f"[opt] front written to {args.out}")
    if args.trace:
        from ..obs.report import dump_run, format_report
        summary = dump_run(args.trace)
        _LOG.log(lvl, format_report(summary))
        _LOG.log(lvl, f"[opt] trace written to {args.trace}.trace.jsonl / "
                      f"{args.trace}.chrome.json (open in Perfetto); "
                      f"report in {args.trace}.report.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
