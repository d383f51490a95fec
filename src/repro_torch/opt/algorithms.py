# Port of src/repro/opt/algorithms.py: the same optimizers, RNG stream and
# selection; populations are evaluated on the engine's explicit device.
"""Population-based optimizers over the batched proxy engine.

Every algorithm evaluates whole populations per generation through the
engine: by default ``DseEngine.evaluate_genomes_async`` on the engine's
device (the card unless the caller passes ``device="cpu"``), or the host
path ``DseEngine.evaluate_points`` with the structure cache absorbing
repeats across generations. Area/power/cost come from the batched
``core.reports.report_arrays`` (memoized per structure key on the host
path), feeding the constraint masks.

Optimizers share a small stateful interface — ``step()`` advances one
generation, ``state()``/``load_state()`` round-trip everything (RNG stream
included) through JSON — so ``opt.runner`` can checkpoint mid-run and resume
bit-identically.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, fields as dc_fields

import numpy as np

from ..core.reports import ReportArrays, report_arrays
from ..core.structure_cache import GLOBAL_STRUCTURE_CACHE
from ..dse.engine import DseEngine
from ..dse.genomes import PendingGenomeEval
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .archive import ParetoArchive
from .operators import mutate_genes, tournament_select, uniform_crossover
from .space import SearchSpace


@dataclass(frozen=True)
class Budgets:
    """Constraint budgets; ``None`` leaves a dimension unconstrained."""
    max_interposer_area: float | None = None   # mm^2
    max_total_area: float | None = None        # mm^2 (chiplets + interposer)
    max_power: float | None = None             # W
    max_cost: float | None = None              # $

    def mask(self, reports: ReportArrays) -> np.ndarray:
        ok = np.ones(len(reports.power), bool)
        if self.max_interposer_area is not None:
            ok &= reports.interposer_area <= self.max_interposer_area
        if self.max_total_area is not None:
            ok &= reports.total_area <= self.max_total_area
        if self.max_power is not None:
            ok &= reports.power <= self.max_power
        if self.max_cost is not None:
            ok &= reports.cost <= self.max_cost
        return ok

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if v is not None}


@dataclass
class EvaluatedPopulation:
    genomes: np.ndarray       # [P, G]
    latency: np.ndarray       # [P] f64
    throughput: np.ndarray    # [P] f64
    feasible: np.ndarray      # [P] bool
    reports: ReportArrays
    # Robustness columns [P] from the fault grid: None on
    # pristine runs. Keys: expected/worst latency+throughput,
    # disconnect_prob, min_reachable_fraction, pristine_latency/throughput.
    extra: dict | None = None


def _pop_apply(fn, *pops: EvaluatedPopulation) -> EvaluatedPopulation:
    """Apply ``fn`` field-wise over populations (and their report columns):
    the dataclasses are the single source of truth for what a population
    carries, so concatenation/selection never drop a field."""
    kw = {}
    for f in dc_fields(EvaluatedPopulation):
        vals = [getattr(p, f.name) for p in pops]
        if f.name == "reports":
            kw[f.name] = ReportArrays(**{
                g.name: fn(*[getattr(v, g.name) for v in vals])
                for g in dc_fields(ReportArrays)})
        elif f.name == "extra":
            if any(v is None for v in vals):
                kw[f.name] = None
            else:
                kw[f.name] = {k: fn(*[v[k] for v in vals])
                              for k in vals[0]}
        else:
            kw[f.name] = fn(*vals)
    return EvaluatedPopulation(**kw)


_POP_DTYPES = {"genomes": np.int64, "latency": np.float64,
               "throughput": np.float64, "feasible": bool}


def _pop_to_state(ev: EvaluatedPopulation | None):
    if ev is None:
        return None
    state = {k: np.asarray(getattr(ev, k)).tolist() for k in _POP_DTYPES}
    state["reports"] = {f.name: np.asarray(getattr(ev.reports, f.name)).tolist()
                        for f in dc_fields(ReportArrays)}
    if ev.extra is not None:
        state["extra"] = {k: np.asarray(v).tolist()
                          for k, v in ev.extra.items()}
    return state


def _pop_from_state(state) -> EvaluatedPopulation | None:
    if state is None:
        return None
    # .get: checkpoints written before a report column existed restore
    # with the column's constructor default instead of crashing.
    reports = {f.name: np.asarray(state["reports"][f.name], np.float64)
               for f in dc_fields(ReportArrays)
               if state["reports"].get(f.name) is not None}
    extra = state.get("extra")
    if extra is not None:
        extra = {k: np.asarray(v, np.float64) for k, v in extra.items()}
    return EvaluatedPopulation(
        **{k: np.asarray(state[k], dt) for k, dt in _POP_DTYPES.items()},
        reports=ReportArrays(**reports), extra=extra)


class PopulationEvaluator:
    """genomes -> proxies + constraint masks, counting evaluations.

    By default populations go through the engine's **device path**
    (``DseEngine.evaluate_genomes``): decode, geometry, routing tables, and
    proxies run on the engine's device, and no ``DesignPoint`` is ever
    materialized — the optimizer inner loop never touches per-design
    Python. The engine is ``DseEngine(device=device)`` unless one is
    passed: ``device=None`` means the card, and raises without one;
    ``device="cpu"`` runs the plain PyTorch path on the host. The classic
    host path
    (``evaluate_points`` through the structure cache) remains for spaces the
    device cannot reproduce (updown_random-routed adjacency spaces), for
    ``validate=True`` runs, and for explicit ``device_path=False`` callers;
    its reports are memoized by ``DesignPoint.structure_key()``."""

    def __init__(self, space: SearchSpace, engine: DseEngine | None = None,
                 budgets: Budgets | None = None, validate: bool = False,
                 device_path: bool | None = None, faults=None,
                 device=None):
        self.space = space
        self.engine = (engine if engine is not None
                       else DseEngine(device=device))
        self.budgets = budgets or Budgets()
        self.validate = validate
        self.device_path = device_path
        self.faults = faults          # faults.objectives.FaultSetup | None
        self.n_evals = 0
        self._report_cache: dict = {}
        if faults is not None and not self.engine.supports_faults(space):
            raise ValueError(
                f"fault-aware evaluation needs the fused device fault "
                f"grid, which {type(space).__name__} (routing "
                f"{getattr(space, 'routing', None)!r}) does not support")

    def _use_device_path(self) -> bool:
        if self.device_path is not None:
            return self.device_path
        return not self.validate and self.engine.supports_genomes(self.space)

    def _reports_for(self, points) -> ReportArrays:
        missing, missing_keys = [], set()
        for pt in points:
            key = pt.structure_key()
            if key not in self._report_cache and key not in missing_keys:
                missing.append(pt)
                missing_keys.add(key)
        if missing:
            # evaluate_points(keep_designs=True) retained the built Design
            # in the structure cache; fall back to rebuilding only when an
            # entry was evicted between the proxy call and this one.
            def design_of(pt):
                entry = GLOBAL_STRUCTURE_CACHE.get(pt.structure_key())
                design = entry.extra.get("design") if entry else None
                return design if design is not None else pt.build()

            built = report_arrays([design_of(pt) for pt in missing])
            for i, pt in enumerate(missing):
                self._report_cache[pt.structure_key()] = (
                    built.total_chiplet_area[i], built.interposer_area[i],
                    built.power[i], built.cost[i],
                    built.reachable_fraction[i])
        cols = np.asarray([self._report_cache[pt.structure_key()]
                           for pt in points], np.float64)
        return ReportArrays(total_chiplet_area=cols[:, 0],
                            interposer_area=cols[:, 1],
                            power=cols[:, 2], cost=cols[:, 3],
                            reachable_fraction=cols[:, 4])

    def dispatch(self, genomes: np.ndarray) -> "PendingPopulationEval":
        """Start evaluating a population without blocking on the device.

        On the device path the population's kernels are launched and the
        host returns as soon as the launches are queued (the BFS of the
        routing tables reads a flag back once a frontier step); ``PendingPopulationEval.result()``
        materializes metrics, reports, and the constraint mask. The host
        path has no asynchrony to exploit — it evaluates eagerly and wraps
        the finished result, so callers can pipeline uniformly.
        Evaluations are counted at dispatch time."""
        genomes = np.asarray(genomes, np.int64)
        if self.faults is not None:
            sc = self.faults.scenarios
            with _span("opt.dispatch", path="faults", evals=len(genomes),
                       scenarios=sc.n_scenarios):
                pending = self.engine.evaluate_genomes_faults_async(
                    self.space, genomes, sc.link_fail, sc.node_fail)
            self.n_evals += len(genomes)
            return PendingPopulationEval(
                lambda: self._finalize_faults(genomes, pending.result()))
        if self._use_device_path():
            with _span("opt.dispatch", path="device", evals=len(genomes)):
                pending = self.engine.evaluate_genomes_async(self.space,
                                                             genomes)
            self.n_evals += len(genomes)
            return PendingPopulationEval(
                lambda: self._finalize(genomes, pending.result(), None))
        with _span("opt.dispatch", path="host", evals=len(genomes)):
            points = self.space.decode(genomes, start_index=self.n_evals)
            self.n_evals += len(points)
            res = self.engine.evaluate_points(
                points, validate=self.validate, n_pad=self.space.max_nodes,
                round_hops=True, keep_designs=True)
        return PendingPopulationEval(
            lambda: self._finalize(genomes, res, points))

    def _finalize(self, genomes, res, points) -> EvaluatedPopulation:
        from ..faults.harness import quarantine_nonfinite
        with _span("opt.finalize", evals=len(genomes),
                   path="device" if points is None else "host"):
            reports = (res.reports if points is None
                       else self._reports_for(points))
            lat = np.asarray(res.latency, np.float64)
            thr = np.asarray(res.throughput, np.float64)
            feasible = self.budgets.mask(reports)
            # NaN/inf rows get finite penalty scores + feasible=False and
            # land in the quarantine list — selection math stays finite,
            # the archive never ingests them.
            lat, thr, feasible = quarantine_nonfinite(
                genomes, lat, thr, feasible, context="eval")
            return EvaluatedPopulation(genomes=genomes, latency=lat,
                                       throughput=thr, feasible=feasible,
                                       reports=reports)

    def _finalize_faults(self, genomes, grid) -> EvaluatedPopulation:
        """Reduce the [P, F] fault grid into robust Pareto objectives: the
        configured mode's latency/throughput become THE archive axes, the
        disconnection-probability constraint folds into feasibility, and
        the remaining robustness columns ride along in ``extra``."""
        from ..faults.harness import quarantine_nonfinite
        from ..faults.objectives import reduce_grid, robust_columns
        with _span("opt.finalize", evals=len(genomes), path="faults"):
            sc = self.faults.scenarios
            reduced = reduce_grid(grid.latency, grid.throughput,
                                  grid.reachable_fraction, sc.weights)
            lat, thr, ok = robust_columns(reduced, self.faults.objectives)
            try:
                pristine = sc.names.index("pristine")
            except ValueError:
                pristine = 0
            extra = dict(reduced)
            extra["pristine_latency"] = np.asarray(
                grid.latency[:, pristine], np.float64)
            extra["pristine_throughput"] = np.asarray(
                grid.throughput[:, pristine], np.float64)
            feasible = self.budgets.mask(grid.reports) & ok
            lat, thr, feasible = quarantine_nonfinite(
                genomes, lat, thr, feasible, context="faults")
            return EvaluatedPopulation(genomes=genomes, latency=lat,
                                       throughput=thr, feasible=feasible,
                                       reports=grid.reports, extra=extra)

    def __call__(self, genomes: np.ndarray) -> EvaluatedPopulation:
        return self.dispatch(genomes).result()


class PendingPopulationEval(PendingGenomeEval):
    """In-flight population evaluation (the same memoized-finisher contract
    as ``PendingGenomeEval``, built with no event of its own: its finisher
    calls the genome evaluation's ``result()``, which waits on that
    evaluation's CUDA event); ``result()`` builds the constraint mask and
    is idempotent."""


# ---------------------------------------------------------------------------
# NSGA-II machinery
# ---------------------------------------------------------------------------

def nondominated_ranks(latency: np.ndarray, throughput: np.ndarray,
                       feasible: np.ndarray) -> np.ndarray:
    """Constraint-dominated non-dominated sorting: rank 0 is the first front;
    every infeasible point ranks after every feasible one.

    Vectorized front peeling — one Python iteration per *front* (the
    staircase scan is a cumulative max over the sort order, the duplicate
    fold one broadcast comparison), so the merged-population sort stays off
    the optimizer's critical path. Output is identical to the original
    per-point scan (same staircase with tol=0, duplicates of a front member
    join its rank, an all--inf-throughput remainder closes out together).
    """
    P = len(latency)
    ranks = np.full(P, P, np.int64)
    lat = np.where(np.isfinite(latency), latency, np.inf)
    thr = np.where(np.isfinite(throughput), throughput, -np.inf)
    remaining = np.asarray(feasible, bool).copy()
    rank = 0
    while remaining.any():
        idx = np.nonzero(remaining)[0]
        order = idx[np.lexsort((-thr[idx], lat[idx]))]
        t = thr[order]
        # staircase with tol=0: keep strictly rising throughput. A skipped
        # point never exceeds the running best, so the cumulative max over
        # ALL previous equals the best over kept ones — the scan is exact.
        prev_best = np.maximum.accumulate(
            np.concatenate(([-np.inf], t[:-1])))
        keep = t > prev_best
        if not keep.any():
            # every remaining point has -inf throughput: no staircase, and
            # they are mutually incomparable here — close them out together
            ranks[idx] = rank
            remaining[idx] = False
            rank += 1
            continue
        # duplicates of a front member are non-dominated too: keep any point
        # equal in both objectives to a front member in the same rank
        f_lat, f_thr = lat[order[keep]], thr[order[keep]]
        eq = np.any((lat[idx][:, None] == f_lat[None, :]) &
                    (thr[idx][:, None] == f_thr[None, :]), axis=1)
        members = idx[eq]
        ranks[members] = rank
        remaining[members] = False
        rank += 1
    infeasible = np.nonzero(~np.asarray(feasible, bool))[0]
    ranks[infeasible] = rank
    return ranks


def crowding_distance(latency: np.ndarray, throughput: np.ndarray,
                      ranks: np.ndarray) -> np.ndarray:
    """Per-point crowding distance within its rank (inf at boundaries)."""
    P = len(latency)
    dist = np.zeros(P, np.float64)
    for r in np.unique(ranks):
        idx = np.nonzero(ranks == r)[0]
        if len(idx) <= 2:
            dist[idx] = np.inf
            continue
        for obj in (latency, throughput):
            vals = np.where(np.isfinite(obj[idx]), obj[idx], 0.0)
            order = idx[np.argsort(vals, kind="stable")]
            span = vals.max() - vals.min()
            dist[order[0]] = dist[order[-1]] = np.inf
            if span <= 0:
                continue
            v = np.sort(vals, kind="stable")
            dist[order[1:-1]] += (v[2:] - v[:-2]) / span
    return dist


def _selection_scores(ranks: np.ndarray, crowd: np.ndarray) -> np.ndarray:
    """Scalar key for tournaments: lower rank wins, crowding breaks ties."""
    return ranks.astype(np.float64) * 1e6 - np.minimum(crowd, 1e5)


def _rng_state(rng: np.random.Generator) -> dict:
    state = rng.bit_generator.state
    # JSON round-trips Python ints of any size; copy to plain dicts.
    return {"bit_generator": state["bit_generator"],
            "state": {k: int(v) for k, v in state["state"].items()},
            "has_uint32": int(state.get("has_uint32", 0)),
            "uinteger": int(state.get("uinteger", 0))}


def _restore_rng(state: dict) -> np.random.Generator:
    rng = np.random.default_rng()
    rng.bit_generator.state = {
        "bit_generator": state["bit_generator"],
        "state": dict(state["state"]),
        "has_uint32": state["has_uint32"],
        "uinteger": state["uinteger"]}
    return rng


class OptimizerBase:
    """Shared stepping/checkpointing shell for the three searches."""

    algo = "base"

    def __init__(self, space: SearchSpace, evaluator: PopulationEvaluator,
                 seed: int = 0, archive: ParetoArchive | None = None):
        self.space = space
        self.evaluator = evaluator
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.archive = archive if archive is not None else ParetoArchive()
        self.generation = 0

    # -- checkpointing ------------------------------------------------------
    def state(self, meta: dict | None = None) -> dict:
        """Serializable optimizer state. ``meta`` (from ``snapshot_meta``)
        substitutes the RNG/eval-count/generation triple captured at an
        earlier moment — the async driver snapshots it right after a
        generation completes, then builds the checkpoint while the next
        generation's device call is in flight (the archive and population
        are only mutated by the deferred ingest that runs first, so the
        resulting checkpoint is bit-identical to the synchronous one)."""
        if meta is None:
            meta = self.snapshot_meta()
        return {"algo": self.algo, "seed": self.seed,
                "generation": meta["generation"],
                "rng": meta["rng"],
                "n_evals": meta["n_evals"],
                "archive": self.archive.to_dicts(),
                **self._extra_state()}

    def snapshot_meta(self) -> dict:
        """The cheap, mutation-prone part of the state (RNG stream, eval
        count, generation) — captured before the next generation's RNG
        draws happen."""
        return {"generation": self.generation,
                "rng": _rng_state(self.rng),
                "n_evals": self.evaluator.n_evals}

    def load_state(self, state: dict) -> None:
        if state.get("algo") != self.algo:
            raise ValueError(f"checkpoint is for algo {state.get('algo')!r}, "
                             f"this optimizer is {self.algo!r}")
        self.seed = state["seed"]
        self.generation = state["generation"]
        self.rng = _restore_rng(state["rng"])
        self.evaluator.n_evals = state["n_evals"]
        self.archive = ParetoArchive.from_dicts(state["archive"])
        self._load_extra_state(state)

    def _extra_state(self) -> dict:
        return {}

    def _load_extra_state(self, state: dict) -> None:
        pass

    # -- stepping -----------------------------------------------------------
    def _ingest(self, ev: EvaluatedPopulation) -> None:
        t0 = time.perf_counter()
        with _span("opt.ingest", evals=len(ev.latency)):
            metrics = {"interposer_area": ev.reports.interposer_area,
                       "total_chiplet_area": ev.reports.total_chiplet_area,
                       "power": ev.reports.power, "cost": ev.reports.cost,
                       "reachable_fraction": ev.reports.reachable_fraction}
            if ev.extra is not None:
                metrics.update(ev.extra)
            self.archive.update(
                ev.latency, ev.throughput, feasible=ev.feasible,
                payloads=[g.tolist() for g in ev.genomes],
                metrics=metrics)
        _metrics.histogram("opt.ingest_s").observe(time.perf_counter() - t0)

    def begin_step(self) -> np.ndarray:
        """Produce the next population to evaluate. Every RNG draw that
        precedes the evaluation happens here, in the same order as
        ``step`` — the sync and async drivers therefore consume one
        identical RNG stream."""
        raise NotImplementedError

    def finish_step(self, ev: EvaluatedPopulation,
                    ingest: bool = True) -> None:
        """Fold an evaluated population back in (selection/acceptance —
        including any post-evaluation RNG draws) and advance the
        generation counter. With ``ingest=False`` the archive update is the
        caller's responsibility (the async driver defers it into the window
        where the next generation's device call is in flight; the archive
        feeds no selection decision, so ordering it later is exact)."""
        raise NotImplementedError

    def step(self) -> None:
        self.finish_step(self.evaluator(self.begin_step()))


class EvolutionarySearch(OptimizerBase):
    """NSGA-II-style evolutionary multi-objective search: non-dominated
    sorting + crowding, binary tournaments, uniform crossover, per-gene
    mutation, (mu + lambda) environmental selection."""

    algo = "nsga2"

    def __init__(self, space, evaluator, seed: int = 0, pop_size: int = 24,
                 mutation_rate: float | None = None,
                 crossover_prob: float = 0.9, archive=None):
        super().__init__(space, evaluator, seed, archive)
        self.pop_size = pop_size
        self.mutation_rate = (mutation_rate if mutation_rate is not None
                              else max(1.0 / space.genome_length, 0.01))
        self.crossover_prob = crossover_prob
        self.pop: EvaluatedPopulation | None = None

    def _extra_state(self) -> dict:
        return {"pop_size": self.pop_size,
                "mutation_rate": self.mutation_rate,
                "crossover_prob": self.crossover_prob,
                "pop": _pop_to_state(self.pop)}

    def _load_extra_state(self, state: dict) -> None:
        self.pop_size = state["pop_size"]
        self.mutation_rate = state["mutation_rate"]
        self.crossover_prob = state["crossover_prob"]
        self.pop = _pop_from_state(state.get("pop"))

    def begin_step(self) -> np.ndarray:
        if self.pop is None:
            return self.space.sample(self.rng, self.pop_size)
        pop = self.pop
        ranks = nondominated_ranks(pop.latency, pop.throughput, pop.feasible)
        crowd = crowding_distance(pop.latency, pop.throughput, ranks)
        scores = _selection_scores(ranks, crowd)
        pa = pop.genomes[tournament_select(scores, self.pop_size, self.rng)]
        pb = pop.genomes[tournament_select(scores, self.pop_size, self.rng)]
        cross = self.rng.random(self.pop_size) < self.crossover_prob
        children = np.where(cross[:, None],
                            uniform_crossover(pa, pb, self.rng), pa)
        return self.space.repair(
            mutate_genes(children, self.space.cardinalities,
                         self.mutation_rate, self.rng))

    def finish_step(self, ev: EvaluatedPopulation,
                    ingest: bool = True) -> None:
        if self.pop is None:
            self.pop = ev
            if ingest:
                self._ingest(ev)
            self.generation += 1
            return
        if ingest:
            self._ingest(ev)
        # (mu + lambda) environmental selection over parents + children
        merged = _pop_apply(lambda a, b: np.concatenate([a, b]),
                            self.pop, ev)
        m_ranks = nondominated_ranks(merged.latency, merged.throughput,
                                     merged.feasible)
        m_crowd = crowding_distance(merged.latency, merged.throughput, m_ranks)
        order = np.sort(np.lexsort((-m_crowd, m_ranks))[:self.pop_size])
        self.pop = _pop_apply(lambda x: x[order], merged)
        self.generation += 1


class SimulatedAnnealing(OptimizerBase):
    """Parallel-chain simulated annealing on the scalarized objective
    ``latency / throughput`` (monotone in both proxies); every chain's
    proposal is evaluated in the same batched proxy call."""

    algo = "sa"

    def __init__(self, space, evaluator, seed: int = 0, n_chains: int = 24,
                 mutation_rate: float | None = None, t0: float = 1.0,
                 cooling: float = 0.95, archive=None):
        super().__init__(space, evaluator, seed, archive)
        self.n_chains = n_chains
        self.mutation_rate = (mutation_rate if mutation_rate is not None
                              else max(2.0 / space.genome_length, 0.01))
        self.t0 = t0
        self.cooling = cooling
        self.chains: np.ndarray | None = None
        self.energies: np.ndarray | None = None

    @staticmethod
    def _energy(ev: EvaluatedPopulation) -> np.ndarray:
        ok = ev.feasible & (ev.throughput > 0)
        return np.where(ok, ev.latency / np.maximum(ev.throughput, 1e-30),
                        1e30)

    @property
    def temperature(self) -> float:
        return self.t0 * self.cooling ** max(self.generation - 1, 0)

    def _extra_state(self) -> dict:
        return {"n_chains": self.n_chains,
                "mutation_rate": self.mutation_rate,
                "t0": self.t0, "cooling": self.cooling,
                "chains": None if self.chains is None
                else self.chains.tolist(),
                "energies": None if self.energies is None
                else self.energies.tolist()}

    def _load_extra_state(self, state: dict) -> None:
        self.n_chains = state["n_chains"]
        self.mutation_rate = state["mutation_rate"]
        self.t0 = state["t0"]
        self.cooling = state["cooling"]
        self.chains = (None if state["chains"] is None
                       else np.asarray(state["chains"], np.int64))
        self.energies = (None if state["energies"] is None
                         else np.asarray(state["energies"], np.float64))

    def begin_step(self) -> np.ndarray:
        if self.chains is None:
            self.chains = self.space.sample(self.rng, self.n_chains)
            return self.chains
        self._proposals = self.space.repair(
            mutate_genes(self.chains, self.space.cardinalities,
                         self.mutation_rate, self.rng))
        return self._proposals

    def finish_step(self, ev: EvaluatedPopulation,
                    ingest: bool = True) -> None:
        if ingest:
            self._ingest(ev)
        if self.energies is None:
            self.energies = self._energy(ev)
            self.generation += 1
            return
        # the accept gate draws AFTER the evaluation — still one shared RNG
        # stream, because finish_step always runs before the next begin_step
        energy = self._energy(ev)
        d = energy - self.energies
        temp = max(self.temperature, 1e-12)
        accept = (d < 0) | (self.rng.random(self.n_chains)
                            < np.exp(-np.clip(d, 0, 700) / temp))
        self.chains = np.where(accept[:, None], self._proposals, self.chains)
        self.energies = np.where(accept, energy, self.energies)
        self.generation += 1


class RandomSearch(OptimizerBase):
    """Equal-budget baseline: independent uniform samples every generation."""

    algo = "random"

    def __init__(self, space, evaluator, seed: int = 0, batch_size: int = 24,
                 archive=None):
        super().__init__(space, evaluator, seed, archive)
        self.batch_size = batch_size

    def _extra_state(self) -> dict:
        return {"batch_size": self.batch_size}

    def _load_extra_state(self, state: dict) -> None:
        self.batch_size = state["batch_size"]

    def begin_step(self) -> np.ndarray:
        return self.space.sample(self.rng, self.batch_size)

    def finish_step(self, ev: EvaluatedPopulation,
                    ingest: bool = True) -> None:
        if ingest:
            self._ingest(ev)
        self.generation += 1


ALGORITHMS = {
    "nsga2": EvolutionarySearch,
    "sa": SimulatedAnnealing,
    "random": RandomSearch,
}
