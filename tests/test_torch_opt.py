"""The port's optimizer (``repro_torch.opt``) on the CPU against the JAX
package's ``repro.opt``.

Tolerances: the copied numpy modules (operators, archive, ``pareto_front``,
``hypervolume_2d``, ``nondominated_ranks``, ``crowding_distance``) give
exactly the reference's integers, ranks and float64 values on the same
inputs. NSGA-II, SA and random search, seeded alike, propose identical
genomes generation by generation and keep identical archive fronts, their
f32 objectives within rtol 1e-5 (the reference's own bound between its host
and device paths); the port's device path runs with ``device="cpu"``, the
reference's on its default CPU backend. The port's own bit-identity rules
(async equals sync, a resume equals an uninterrupted run) hold exactly.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro's modules need repro.core loaded)
from repro.dse import pareto as ref_pareto
from repro.opt import algorithms as ref_algorithms
from repro.opt import archive as ref_archive
from repro.opt import operators as ref_operators
from repro.opt import runner as ref_runner

import repro_torch.core  # noqa: F401
from repro_torch.dse import pareto
from repro_torch.opt import (ALGORITHMS, AdjacencySpace, Budgets,
                             EvolutionarySearch, OptRunner,
                             PopulationEvaluator, RandomSearch,
                             SimulatedAnnealing, archive, operators)
from repro_torch.opt import algorithms, runner

RTOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# the copied numpy modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_operators_equal_reference(seed):
    card = np.asarray([2, 2, 5, 17, 1, 3, 2, 9], np.int64)
    rng = np.random.default_rng(100 + seed)
    g = rng.integers(0, card, (12, len(card)))
    h = rng.integers(0, card, (12, len(card)))
    scores = rng.random(12).round(1)           # ties on purpose
    for rate in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(
            operators.mutate_genes(g, card, rate, np.random.default_rng(seed)),
            ref_operators.mutate_genes(g, card, rate,
                                       np.random.default_rng(seed)))
    np.testing.assert_array_equal(
        operators.uniform_crossover(g, h, np.random.default_rng(seed), 0.3),
        ref_operators.uniform_crossover(g, h, np.random.default_rng(seed),
                                        0.3))
    for k in (1, 2, 3):
        np.testing.assert_array_equal(
            operators.tournament_select(scores, 9,
                                        np.random.default_rng(seed), k),
            ref_operators.tournament_select(scores, 9,
                                            np.random.default_rng(seed), k))


def _objectives(seed, size=40):
    """Latency/throughput with exact duplicates, ties in one objective,
    non-finite entries and an infeasible share."""
    rng = np.random.default_rng(seed)
    lat = rng.integers(50, 60, size).astype(np.float64) + rng.random(size)
    thr = rng.integers(1, 9, size).astype(np.float64) * 100.0
    lat[10:14], thr[10:14] = lat[:4], thr[:4]        # exact duplicates
    lat[3], thr[5], thr[9] = np.inf, np.nan, -np.inf
    feasible = rng.random(size) < 0.8
    return lat, thr, feasible


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fronts_and_hypervolume_equal_reference(seed):
    lat, thr, feasible = _objectives(seed)
    np.testing.assert_array_equal(archive.pareto_front(lat, thr),
                                  ref_archive.pareto_front(lat, thr))
    np.testing.assert_array_equal(archive.pareto_front(lat, thr, feasible),
                                  ref_archive.pareto_front(lat, thr,
                                                           feasible))
    assert pareto.pareto_front is archive.pareto_front
    np.testing.assert_array_equal(
        pareto.pareto_front(lat, thr, feasible),
        ref_pareto.pareto_front(lat, thr, feasible))
    for ref_lat in (55.0, 70.0):
        assert archive.hypervolume_2d(lat, thr, ref_lat, 100.0) == \
            ref_archive.hypervolume_2d(lat, thr, ref_lat, 100.0)
    assert pareto.hypervolume_2d([], [], 1.0) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_archive_updates_equal_reference(seed):
    got, want = archive.ParetoArchive(), ref_archive.ParetoArchive()
    for batch in range(4):
        lat, thr, feasible = _objectives(seed * 10 + batch, size=15)
        payloads = [[batch, i] for i in range(15)]
        metrics = {"power": np.arange(15.0) + batch}
        a = got.update(lat, thr, feasible, payloads, metrics)
        b = want.update(lat, thr, feasible, payloads, metrics)
        assert a == b
        assert got.to_dicts() == want.to_dicts()
    assert got.hypervolume(70.0, 100.0) == want.hypervolume(70.0, 100.0)
    back = archive.ParetoArchive.from_dicts(got.to_dicts())
    assert back.to_dicts() == got.to_dicts()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranks_and_crowding_equal_reference(seed):
    lat, thr, feasible = _objectives(seed, size=48)
    ranks = algorithms.nondominated_ranks(lat, thr, feasible)
    np.testing.assert_array_equal(
        ranks, ref_algorithms.nondominated_ranks(lat, thr, feasible))
    np.testing.assert_array_equal(
        algorithms.crowding_distance(lat, thr, ranks),
        ref_algorithms.crowding_distance(lat, thr, ranks))


# ---------------------------------------------------------------------------
# the optimizers against the reference, generation by generation
# ---------------------------------------------------------------------------

_SIZE_KW = {"nsga2": "pop_size", "sa": "n_chains", "random": "batch_size"}
# the seeds tests/test_opt.py gives each algorithm
_REF_SEEDS = {"nsga2": 0, "sa": 2, "random": 4}


def _pair(algo, n, seed, size=16, **kw):
    """The same optimizer in both packages: the port on its device path
    with device="cpu", the reference on its default path."""
    from repro.opt import AdjacencySpace as RefSpace
    from repro.opt import Budgets as RefBudgets
    ref_sp = RefSpace(n_chiplets=n, max_degree=5)
    ref_ev = ref_algorithms.PopulationEvaluator(
        ref_sp, budgets=RefBudgets(max_interposer_area=2500.0), **kw)
    ref = ref_algorithms.ALGORITHMS[algo](ref_sp, ref_ev, seed=seed,
                                          **{_SIZE_KW[algo]: size})
    sp = AdjacencySpace(n_chiplets=n, max_degree=5)
    ev = PopulationEvaluator(sp, budgets=Budgets(max_interposer_area=2500.0),
                             device="cpu", **kw)
    assert ev._use_device_path()
    port = ALGORITHMS[algo](sp, ev, seed=seed, **{_SIZE_KW[algo]: size})
    return port, ref


def _front(opt):
    return [(e.latency, e.throughput, e.payload) for e in opt.archive.front()]


def _run_side_by_side(port, ref, gens):
    """Step both optimizers; returns the first generation whose proposed
    genomes differ (None if none did) after checking the objectives of
    every generation that agreed."""
    for g in range(gens):
        got, want = port.begin_step(), ref.begin_step()
        if not np.array_equal(got, want):
            return g
        ev, ref_ev = port.evaluator(got), ref.evaluator(want)
        np.testing.assert_allclose(ev.latency, ref_ev.latency, rtol=RTOL)
        np.testing.assert_allclose(ev.throughput, ref_ev.throughput,
                                   rtol=RTOL)
        np.testing.assert_array_equal(ev.feasible, ref_ev.feasible)
        port.finish_step(ev)
        ref.finish_step(ref_ev)
    return None


@pytest.mark.parametrize("n", [10, 12, 16])
@pytest.mark.parametrize("algo", ["nsga2", "sa", "random"])
def test_optimizer_matches_reference_generation_by_generation(algo, n):
    port, ref = _pair(algo, n, _REF_SEEDS[algo])
    assert _run_side_by_side(port, ref, gens=4) is None
    got, want = _front(port), _front(ref)
    assert [p for _, _, p in got] == [p for _, _, p in want]
    np.testing.assert_allclose([lt[:2] for lt in got],
                               [lt[:2] for lt in want], rtol=RTOL)
    assert port.evaluator.n_evals == ref.evaluator.n_evals == 64
    assert port.generation == ref.generation == 4
    if algo == "sa":
        np.testing.assert_array_equal(port.chains, ref.chains)


# ROADMAP Queue C, "NSGA-II rank flip at n = 16, seed 16": the two packages
# agree through generation 1, where designs 16 and 26 of the merged
# population have throughputs 7e-8 apart in the f64 oracle's order and the
# reference's f32 sums swap them (3322.6638 < 3322.6641), the port's do not
# (3322.6665 > 3322.6663); design 16's rank then differs (3 vs 2) and the
# generation-2 offspring differ.
_FLIP = dict(algo="nsga2", n=16, seed=16)


@pytest.mark.xfail(strict=True, reason="ROADMAP Queue C: NSGA-II rank flip "
                   "at n = 16, seed 16 (sub-1e-5 throughputs swap order)")
def test_nsga2_n16_seed16_matches_reference_generation_by_generation():
    port, ref = _pair(_FLIP["algo"], _FLIP["n"], _FLIP["seed"])
    assert _run_side_by_side(port, ref, gens=4) is None


def test_nsga2_n16_seed16_rank_flip_comes_from_sub_1e5_throughputs():
    """The mechanism of the Queue C entry: generation 2 is the first to
    differ; before it every objective agrees within 1e-5, and the only
    rank that differs in the merged population belongs to a design whose
    throughput is within 1e-6 of a design that dominates it in the
    reference and not in the port."""
    port, ref = _pair(_FLIP["algo"], _FLIP["n"], _FLIP["seed"])
    assert _run_side_by_side(port, ref, gens=1) is None
    got, want = port.begin_step(), ref.begin_step()
    np.testing.assert_array_equal(got, want)
    ev, ref_ev = port.evaluator(got), ref.evaluator(want)
    np.testing.assert_allclose(ev.throughput, ref_ev.throughput, rtol=RTOL)
    merged = {}
    for name, opt, e in (("port", port, ev), ("ref", ref, ref_ev)):
        lat = np.concatenate([opt.pop.latency, e.latency])
        thr = np.concatenate([opt.pop.throughput, e.throughput])
        feas = np.concatenate([opt.pop.feasible, e.feasible])
        merged[name] = (lat, thr,
                        algorithms.nondominated_ranks(lat, thr, feas))
    differ = np.nonzero(merged["port"][2] != merged["ref"][2])[0]
    assert differ.tolist() == [16]
    (lat_p, thr_p, _), (lat_r, thr_r, _) = merged["port"], merged["ref"]
    assert lat_r[26] < lat_r[16] and lat_p[26] < lat_p[16]
    assert thr_r[26] > thr_r[16] and thr_p[26] < thr_p[16]
    assert abs(thr_p[16] / thr_p[26] - 1) < 1e-6
    port.finish_step(ev)
    ref.finish_step(ref_ev)
    assert not np.array_equal(port.begin_step(), ref.begin_step())


# ---------------------------------------------------------------------------
# the port's own bit-identity rules (ported from tests/test_opt.py)
# ---------------------------------------------------------------------------

def _make_optimizer(cls, seed, size=16, n=12):
    space = AdjacencySpace(n_chiplets=n, max_degree=5)
    ev = PopulationEvaluator(space, budgets=Budgets(max_interposer_area=2500.0),
                             device="cpu")
    kw = ({"batch_size": size} if cls is RandomSearch
          else {"n_chains": size} if cls is SimulatedAnnealing
          else {"pop_size": size})
    return space, cls(space, ev, seed=seed, **kw)


def test_resume_reproduces_uninterrupted_run(tmp_path):
    ckpt = str(tmp_path / "opt.json")
    gens = 6
    _, full = _make_optimizer(EvolutionarySearch, seed=3, size=10, n=10)
    r_full = OptRunner(full).run(gens)
    _, part = _make_optimizer(EvolutionarySearch, seed=3, size=10, n=10)
    OptRunner(part, checkpoint_path=ckpt).run(3)
    _, fresh = _make_optimizer(EvolutionarySearch, seed=3, size=10, n=10)
    r_res = OptRunner(fresh, checkpoint_path=ckpt).run(gens)
    assert _front(full) == _front(fresh)
    assert r_full.n_evals == r_res.n_evals
    assert r_res.history_start == 3


@pytest.mark.parametrize("cls", [EvolutionarySearch, SimulatedAnnealing,
                                 RandomSearch])
def test_async_pipeline_is_bit_identical_to_sync(cls, tmp_path):
    """Every per-generation checkpoint, the hypervolume history, the final
    state and the eval count of the double-buffered driver equal the
    synchronous loop's, for every algorithm."""
    gens = 5
    ckpts = {}
    for mode in ("sync", "async"):
        ckpt = str(tmp_path / f"{mode}.json")
        per_gen = []
        _, opt = _make_optimizer(cls, seed=5, size=8, n=10)
        run = OptRunner(opt, checkpoint_path=ckpt, ref_latency=300.0,
                        async_pipeline=mode == "async")
        orig = run._after_generation

        def capture(o, meta, history, generations, progress,
                    _orig=orig, _per_gen=per_gen, _ckpt=ckpt):
            _orig(o, meta, history, generations, progress)
            with open(_ckpt) as f:
                _per_gen.append(json.load(f))

        run._after_generation = capture
        result = run.run(gens)
        ckpts[mode] = (per_gen, result.history, opt.state(), result.n_evals)
    sync, asyn = ckpts["sync"], ckpts["async"]
    assert len(sync[0]) == len(asyn[0]) == gens
    for g, (a, b) in enumerate(zip(sync[0], asyn[0])):
        assert a == b, f"checkpoint for generation {g + 1} diverged"
    assert sync[1] == asyn[1]
    assert sync[2] == asyn[2]
    assert sync[3] == asyn[3]


def test_async_and_sync_resume_interchangeably(tmp_path):
    gens = 6
    _, full = _make_optimizer(EvolutionarySearch, seed=6, size=8, n=10)
    r_full = OptRunner(full).run(gens)
    for first_async in (True, False):
        ckpt = str(tmp_path / f"cross_{first_async}.json")
        _, part = _make_optimizer(EvolutionarySearch, seed=6, size=8, n=10)
        OptRunner(part, checkpoint_path=ckpt,
                  async_pipeline=first_async).run(3)
        _, fresh = _make_optimizer(EvolutionarySearch, seed=6, size=8, n=10)
        r_res = OptRunner(fresh, checkpoint_path=ckpt,
                          async_pipeline=not first_async).run(gens)
        assert _front(full) == _front(fresh)
        assert r_full.n_evals == r_res.n_evals


def test_checkpoint_is_json_and_atomic(tmp_path):
    from repro_torch.faults.harness import json_digest
    ckpt = str(tmp_path / "opt.json")
    _, opt = _make_optimizer(RandomSearch, seed=4, size=6, n=10)
    OptRunner(opt, checkpoint_path=ckpt).run(2)
    with open(ckpt) as f:
        envelope = json.load(f)
    assert envelope["format"] == 2
    assert envelope["sha256"] == json_digest(envelope["state"])
    assert envelope["state"]["versions"]["torch"] == torch.__version__
    assert "jax" not in envelope["state"]["versions"]
    state = runner.load_checkpoint(ckpt)
    assert state["algo"] == "random"
    assert state["generation"] == 2
    assert not os.path.exists(ckpt + ".tmp")
    assert os.path.exists(ckpt + ".prev")


def test_version_stamp_mismatch_warns_instead_of_crashing(tmp_path):
    from repro_torch.utils.version import check_version_stamp, version_stamp
    stamp = version_stamp("abc")
    assert check_version_stamp(stamp, "abc") == []
    assert check_version_stamp(None)
    problems = check_version_stamp(dict(stamp, torch="0.0"), "abc")
    assert len(problems) == 1 and "torch=0.0" in problems[0]
    # a reference checkpoint's stamp names jax, not torch: no mismatch
    assert check_version_stamp({"repro": stamp["repro"], "jax": "0.9"}) == []
    ckpt = str(tmp_path / "old.json")
    _, opt = _make_optimizer(RandomSearch, seed=4, size=6, n=10)
    OptRunner(opt, checkpoint_path=ckpt).run(1)
    state = runner.load_checkpoint(ckpt)
    state["versions"]["torch"] = "0.0"
    with open(ckpt, "w") as f:
        json.dump(state, f)              # a flat (pre-format-2) state
    _, fresh = _make_optimizer(RandomSearch, seed=4, size=6, n=10)
    assert OptRunner(fresh, checkpoint_path=ckpt).optimizer.generation == 1


def test_pending_population_eval_is_idempotent():
    space, opt = _make_optimizer(RandomSearch, seed=4, size=6, n=10)
    pending = opt.evaluator.dispatch(space.sample(np.random.default_rng(1), 6))
    assert isinstance(pending, algorithms.PendingPopulationEval)
    first = pending.result()
    assert pending.result() is first
    assert opt.evaluator.n_evals == 6


def test_device_and_host_paths_agree():
    """The engine's device path (device="cpu") and the host path through
    ``evaluate_points`` give the same objectives within 1e-5 and the same
    feasibility."""
    space = AdjacencySpace(n_chiplets=10, max_degree=4)
    genomes = space.sample(np.random.default_rng(9), 6)
    budgets = Budgets(max_interposer_area=1000.0)
    dev = PopulationEvaluator(space, budgets=budgets, device="cpu")(genomes)
    host = PopulationEvaluator(space, budgets=budgets, device="cpu",
                               device_path=False)(genomes)
    np.testing.assert_allclose(dev.latency, host.latency, rtol=RTOL)
    np.testing.assert_allclose(dev.throughput, host.throughput, rtol=RTOL)
    np.testing.assert_array_equal(dev.feasible, host.feasible)
    np.testing.assert_array_equal(dev.reports.power, host.reports.power)


def test_structure_cache_hits_on_the_host_path_only():
    from repro_torch.core.structure_cache import GLOBAL_STRUCTURE_CACHE
    space = AdjacencySpace(n_chiplets=10, max_degree=4)
    genomes = space.sample(np.random.default_rng(9), 6)
    host = PopulationEvaluator(space, device_path=False, device="cpu")
    host(genomes)
    before = GLOBAL_STRUCTURE_CACHE.stats()
    host(genomes)
    assert GLOBAL_STRUCTURE_CACHE.stats()["hits"] >= before["hits"] + 6
    dev = PopulationEvaluator(space, device="cpu")
    assert dev._use_device_path()
    dev(genomes)
    before = GLOBAL_STRUCTURE_CACHE.stats()
    dev(genomes)
    after = GLOBAL_STRUCTURE_CACHE.stats()
    assert (after["hits"], after["misses"]) == (before["hits"],
                                                before["misses"])


def test_simulated_annealing_cools_and_archives():
    _, opt = _make_optimizer(SimulatedAnnealing, seed=2, size=8)
    res = OptRunner(opt).run(6)
    assert res.n_evals == 48
    assert len(res.archive) >= 1
    assert opt.temperature < opt.t0


def test_make_space_and_optimizer_reject_unknown_names():
    with pytest.raises(ValueError, match="unknown space"):
        runner.make_space("ring")
    space = runner.make_space("adjacency", n_chiplets=8)
    ev = PopulationEvaluator(space, device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        runner.make_optimizer("pso", space, ev)
    assert isinstance(runner.make_optimizer("sa", space, ev),
                      SimulatedAnnealing)


# ---------------------------------------------------------------------------
# the CLI: python -m repro_torch.opt prints the reference's front
# ---------------------------------------------------------------------------

_CLI_ARGS = ["--space", "adjacency", "--n-chiplets", "12", "--generations",
             "2", "--pop-size", "8"]


@pytest.mark.parametrize("extra", [[], ["--faults", "--fault-model",
                                         "single"]],
                         ids=["pristine", "faults_single"])
def test_cli_prints_the_reference_front(extra, tmp_path):
    out = str(tmp_path / "front.json")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.opt", "--device", "cpu",
         *_CLI_ARGS, *extra, "--out", out],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    ref_out = str(tmp_path / "ref_front.json")
    assert ref_runner.main([*_CLI_ARGS, *extra, "--out", ref_out,
                            "--quiet"]) == 0
    with open(out) as f:
        got = json.load(f)
    with open(ref_out) as f:
        want = json.load(f)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if isinstance(w[key], float):
                assert g[key] == pytest.approx(w[key], rel=RTOL), key
            else:
                assert g[key] == w[key], key
    # the lines the CLI prints (2 decimals) are the reference's
    lines = [ln for ln in proc.stderr.splitlines() + proc.stdout.splitlines()
             if ln.strip().startswith("lat=")]
    assert len(lines) == len(want)
    for ln, w in zip(lines, want):
        assert f"lat={w['latency']:8.2f}" in ln
        assert f"thr={w['throughput']:10.2f}" in ln


def test_cli_trace_dumps_a_valid_report(tmp_path):
    from repro_torch.obs import __main__ as obs_cli
    from repro_torch.obs.report import load_trace, validate_trace
    from repro_torch.obs.trace import TRACER, disable_tracing
    prefix = str(tmp_path / "run")
    try:
        assert runner.main(["--device", "cpu", "--n-chiplets", "8",
                            "--generations", "2", "--pop-size", "6",
                            "--async", "--quiet", "--trace", prefix]) == 0
    finally:
        disable_tracing()
    events = load_trace(prefix + ".trace.jsonl")
    assert validate_trace(events) == []
    names = {e["name"] for e in events}
    assert {"opt.dispatch", "opt.finalize", "opt.ingest", "opt.device_wait",
            "opt.flush_deferred", "opt.generation"} <= names
    with open(prefix + ".report.json") as f:
        report = json.load(f)
    assert report["telemetry"]["async_overlap_pct"] is not None
    assert obs_cli.main(["--prefix", prefix, "--check", "--quiet"]) == 0
    TRACER.clear()
