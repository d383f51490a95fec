"""The port's search service (``repro_torch.serve``) on the CPU: the
counterparts of ``tests/test_serve.py`` at its sizes, and the port's solo
runs against the JAX package's ``repro.serve.run_spec_solo``.

The load-bearing assertion, as in the reference: a job driven by the
co-batching scheduler — its evaluations concatenated with other jobs' into
shared mega-batches — produces the **bit-identical** front, eval count and
full ``optimizer.state()`` (archive and RNG stream) that the same spec
produces run solo (``run_spec_solo``), across all three algorithms, ragged
batch sizes, mid-run admission, drain/resume (in-process and SIGTERM +
restart), and with a crashed batch-mate. Everything runs with
``device="cpu"`` (the plain PyTorch path).

Against the reference, a port solo run proposes the same genomes, keeps the
same archive front (its f32 objectives within rtol 1e-5, the reference's own
bound between its host and device paths) and counts the same evaluations,
for every spec of ``tests/test_serve.py`` but one: nsga2 seed 12 leaves the
reference's trajectory on a throughput tie (ROADMAP Queue C), pinned below.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (first: repro's modules need repro.core)
from repro.opt import algorithms as ref_algorithms  # noqa: E402
from repro.serve import JobSpec as RefJobSpec  # noqa: E402
from repro.serve import job as ref_job  # noqa: E402
from repro.serve import run_spec_solo as ref_run_spec_solo  # noqa: E402

import repro_torch.core  # noqa: E402,F401
from repro_torch.opt import algorithms  # noqa: E402
from repro_torch.serve import (AdmissionError, JobSpec,  # noqa: E402
                               SearchService, front_json_bytes,
                               run_spec_solo)
from repro_torch.serve import job as port_job  # noqa: E402

SPACE = {"kind": "adjacency", "n_chiplets": 10, "max_degree": 4}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = 1e-5


def _spec(job_id, algo="nsga2", generations=4, pop_size=8, seed=0, **kw):
    return JobSpec(job_id=job_id, algo=algo, generations=generations,
                   pop_size=pop_size, seed=seed,
                   space=dict(kw.pop("space", SPACE)), **kw)


def _service(**kw):
    return SearchService(device="cpu", **kw)


def _assert_solo_identical(job, spec):
    assert job.status == "done", (job.job_id, job.status, job.reason)
    solo_opt, solo_rows = run_spec_solo(spec, device="cpu")
    assert front_json_bytes(job.result_rows) == front_json_bytes(solo_rows)
    assert job.n_evals == solo_opt.evaluator.n_evals
    # the full serialized optimizer state — archive AND RNG stream —
    # must match, not just the front
    served = job.optimizer.state()
    solo = solo_opt.state()
    assert served["rng"] == solo["rng"]
    assert served == solo


# ---------------------------------------------------------------------------
# co-batching bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["nsga2", "sa", "random"])
def test_cobatched_job_bit_identical_to_solo(algo):
    """Three same-space jobs of every algorithm running concurrently —
    each one's archive, RNG stream, and eval count must equal its solo
    run exactly."""
    specs = [_spec(f"{algo}-{seed}", algo=algo, generations=5, seed=seed,
                   pop_size=8) for seed in (1, 2)]
    with _service() as svc:
        for spec in specs:
            svc.submit(spec)
        jobs = [svc.wait(spec.job_id, 300) for spec in specs]
    for job, spec in zip(jobs, specs):
        _assert_solo_identical(job, spec)


def test_ragged_job_sizes_share_one_bucket():
    """Jobs with populations 3/5/8 co-batch into one 16-row bucket —
    the same bucket any of them would pad to solo — and every slice is
    still exact."""
    specs = [_spec(f"ragged-{size}", generations=4, pop_size=size,
                   seed=size) for size in (3, 5, 8)]
    with _service() as svc:
        for spec in specs:
            svc.submit(spec)
        jobs = [svc.wait(spec.job_id, 300) for spec in specs]
        occupancy = svc.stats()
    assert occupancy["jobs"] == {"done": 3}
    for job, spec in zip(jobs, specs):
        _assert_solo_identical(job, spec)


def test_job_admitted_mid_generation():
    """A job submitted while another is mid-run joins the next round and
    neither trajectory is perturbed."""
    early = _spec("early", generations=8, seed=4)
    late = _spec("late", algo="sa", generations=4, seed=5)
    with _service() as svc:
        svc.submit(early)
        deadline = time.monotonic() + 300
        while svc.job("early").generation < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        svc.submit(late)
        j_early = svc.wait("early", 300)
        j_late = svc.wait("late", 300)
    _assert_solo_identical(j_early, early)
    _assert_solo_identical(j_late, late)


# ---------------------------------------------------------------------------
# budgets, deadlines, backpressure
# ---------------------------------------------------------------------------

def test_job_eval_budget_stops_early_and_stays_identical():
    """max_evals cuts the run mid-way (3 of 10 generations) through the
    same pre-dispatch check the solo reference applies, so even the
    truncated front is bit-identical."""
    spec = _spec("budgeted", generations=10, pop_size=8, seed=6,
                 max_evals=24)
    with _service() as svc:
        svc.submit(spec)
        job = svc.wait("budgeted", 300)
    assert job.status == "done" and job.reason == "eval_budget"
    assert job.n_evals == 24 and job.generation == 3
    _assert_solo_identical(job, spec)


def test_tenant_budget_enforced_mid_run_and_at_admission():
    """Two jobs drain one tenant's eval budget mid-run: the job that
    would overrun fails with reason 'tenant_budget', its sibling (and
    the other tenant's job) finish bit-identically, and a late
    submission for the spent tenant is shed at admission."""
    a = _spec("tenant-a", generations=3, pop_size=8, seed=7, tenant="t")
    b = _spec("tenant-b", generations=10, pop_size=8, seed=8, tenant="t")
    other = _spec("other", generations=3, pop_size=8, seed=9, tenant="u")
    with _service(tenant_budgets={"t": 40}) as svc:
        for spec in (a, b, other):
            svc.submit(spec)
        ja, jb, jo = (svc.wait(s.job_id, 300) for s in (a, b, other))
        with pytest.raises(AdmissionError) as shed:
            svc.submit(_spec("tenant-c", tenant="t"))
        assert shed.value.reason == "tenant_budget"
        spent = svc.stats()["tenant_spent"]
    assert jb.status == "failed" and jb.reason == "tenant_budget"
    assert spent["t"] <= 40
    _assert_solo_identical(ja, a)
    _assert_solo_identical(jo, other)


def test_deadline_expiry_fails_only_that_job():
    quick = _spec("quick", generations=3, seed=10)
    doomed = _spec("doomed", generations=100000, pop_size=8, seed=11,
                   deadline_s=0.05)
    with _service() as svc:
        svc.submit(doomed)
        svc.submit(quick)
        j_doomed = svc.wait("doomed", 300)
        j_quick = svc.wait("quick", 300)
    assert j_doomed.status == "failed" and j_doomed.reason == "deadline"
    _assert_solo_identical(j_quick, quick)


def test_admission_control_sheds_with_reason():
    svc = _service(max_queued=2)
    svc.submit(_spec("q1"), auto_start=False)
    svc.submit(_spec("q2"), auto_start=False)
    with pytest.raises(AdmissionError) as full:
        svc.submit(_spec("q3"), auto_start=False)
    assert full.value.reason == "queue_full"
    with pytest.raises(AdmissionError) as dup:
        svc.submit(_spec("q1"), auto_start=False)
    assert dup.value.reason == "duplicate"
    with pytest.raises(AdmissionError) as bad:
        svc.submit(JobSpec(job_id="qx", algo="gradient-descent"),
                   auto_start=False)
    assert bad.value.reason == "bad_spec"
    # the parked queue still drains to completion once started
    svc.start()
    assert svc.wait("q1", 300).status == "done"
    assert svc.wait("q2", 300).status == "done"
    svc.drain()
    with pytest.raises(AdmissionError) as stopped:
        svc.submit(_spec("q4"))
    assert stopped.value.reason == "stopped"


# ---------------------------------------------------------------------------
# fault isolation
# ---------------------------------------------------------------------------

def test_crashed_job_never_alters_siblings():
    """A job whose dispatch is force-crashed (chaos hook) fails alone;
    every batch-mate's front is bit-identical to solo."""
    good1 = _spec("good1", generations=5, seed=12)
    bad = _spec("bad", generations=5, seed=13, chaos_fail_generation=2)
    good2 = _spec("good2", algo="sa", generations=5, seed=14)
    with _service() as svc:
        for spec in (good1, bad, good2):
            svc.submit(spec)
        j1, jb, j2 = (svc.wait(s.job_id, 300) for s in (good1, bad, good2))
    assert jb.status == "failed" and jb.reason == "error"
    assert jb.generation == 2          # crashed exactly where armed
    _assert_solo_identical(j1, good1)
    _assert_solo_identical(j2, good2)


# ---------------------------------------------------------------------------
# drain / resume
# ---------------------------------------------------------------------------

def test_drain_and_resume_bit_identical(tmp_path):
    """drain() mid-run suspends the job with a checkpoint; a new service
    on the same state dir finishes it bit-identically to solo."""
    state = str(tmp_path / "state")
    spec = _spec("resume", generations=8, pop_size=8, seed=15)
    svc1 = _service(state_dir=state)
    svc1.submit(spec)
    deadline = time.monotonic() + 300
    while svc1.job("resume").generation < 3:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    svc1.drain()
    assert svc1.job("resume").status == "suspended"
    assert os.path.exists(os.path.join(state, "job-resume.json"))

    svc2 = _service(state_dir=state)
    svc2.start()
    job = svc2.wait("resume", 300)
    svc2.drain()
    assert job.generation == 8
    _assert_solo_identical(job, spec)


def test_sigterm_drain_restart_resumes_bit_identically(tmp_path):
    """The CLI under SIGTERM: graceful drain checkpoints the in-flight
    job, a restarted server completes it, and the persisted front equals
    the solo run byte-for-byte."""
    state = str(tmp_path / "state")
    spec = _spec("cli", generations=6, pop_size=8, seed=16)
    jobs_file = str(tmp_path / "jobs.json")
    with open(jobs_file, "w") as f:
        json.dump([spec.to_dict()], f)
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.abspath(SRC) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
           "--state-dir", state, "--jobs", jobs_file, "--exit-when-idle"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    ckpt = os.path.join(state, "job-cli.json")
    try:
        deadline = time.monotonic() + 120
        while not os.path.exists(ckpt) and proc.poll() is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # restart on the same state dir: the job must finish
    subprocess.run(cmd, env=env, check=True, timeout=120,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    with open(os.path.join(state, "job-cli.front.json"), "rb") as f:
        served = f.read()
    _, solo_rows = run_spec_solo(spec, device="cpu")
    assert served == front_json_bytes(solo_rows)


# ---------------------------------------------------------------------------
# why co-batching is exact: a row's bits at every bucket and slab tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 32, 176])
def test_load_propagation_rows_equal_at_every_population_bucket(n):
    """A solo population of 8 pads to 8 rows, a mega-batch of 24 to 32
    (``bucket_population``): load propagation gives each design the same W
    and flow at every bucket the service reaches, next to batch-mates that
    need more hops (the CPU loop runs to the batch's largest eccentricity,
    adding zeros to rows that finished). At n = 176 the plain slab form
    runs, with the tile ``pick_tile`` picks from the batch (128 at 8 rows,
    32 at 32; the 64-row bucket is left out there to keep the test short)."""
    from repro_torch.core.proxies import prepare_arrays
    from repro_torch.dse.genomes import bucket_population
    from repro_torch.kernels.load_prop import pick_tile
    from repro_torch.kernels.ops import load_propagate
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    tables = [prepare_arrays(make_design(topo, n))[0].next_hop
              for topo in ("mesh", "torus", "flattened_butterfly")]
    nh = torch.as_tensor(np.stack(tables)).long()
    load0 = torch.as_tensor(
        make_traffic("random_uniform", n)).float().T.contiguous()
    assert [bucket_population(p) for p in (3, 8, 24, 40)] == [8, 8, 32, 64]
    buckets = (8, 16, 32, 64) if n <= 160 else (8, 32)
    if n > 160:
        assert pick_tile(n, 8) != pick_tile(n, 32)
    rows = {}
    for bucket in buckets:
        # design 0 (the mesh, largest diameter) at row 0 alone among its
        # own copies, then among the others at every offset
        order = [i % 3 for i in range(bucket)]
        w, flow = load_propagate(nh[order], load0.expand(bucket, n, n),
                                 max_hops=n - 1)
        for i in range(bucket):
            rows.setdefault(order[i], []).append((w[i], flow[i]))
    for design, got in rows.items():
        for w, flow in got[1:]:
            assert torch.equal(w, got[0][0]), design
            assert torch.equal(flow, got[0][1]), design


def test_slab_form_flow_bits_do_not_depend_on_the_tile():
    from repro_torch.kernels.load_prop import load_prop_plain_blocked

    rng = np.random.default_rng(176)
    n, batch = 176, 2
    nh = torch.as_tensor(rng.integers(0, n, (batch, n, n)))
    load0 = torch.as_tensor(rng.random((batch, n, n)), dtype=torch.float32)
    want = load_prop_plain_blocked(nh, load0, 6, False, 8)
    for tile in (16, 32, 64, 128):
        got = load_prop_plain_blocked(nh, load0, 6, False, tile)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# cache thread-safety under concurrent jobs
# ---------------------------------------------------------------------------

def test_concurrent_evaluations_share_one_pipeline():
    """Stress the shared mutable caches the service exposes to threads:
    four threads evaluating the same spaces concurrently (with a short
    switch interval) must agree bit-for-bit, build one genome pipeline
    per space, and grow the parametric structure table exactly once per
    structure (the counterpart of the reference's one-compile check:
    PyTorch compiles nothing)."""
    from repro_torch.dse.engine import DseEngine
    from repro_torch.opt.runner import make_space

    adj = make_space("adjacency", n_chiplets=12, max_degree=4)
    par = make_space("parametric", topologies=("mesh", "torus"),
                     chiplet_counts=(9, 16))
    engine = DseEngine(device="cpu")
    rng = np.random.default_rng(17)
    adj_genomes = adj.sample(rng, 8)
    par_genomes = par.sample(rng, 8)

    results, errors = {}, []

    def worker(idx):
        try:
            out = []
            for _round in ("one", "two", "three"):
                ra = engine.evaluate_genomes(adj, adj_genomes)
                rp = engine.evaluate_genomes(par, par_genomes)
                out.append((ra.latency.copy(), rp.latency.copy(),
                            ra.throughput.copy(), rp.throughput.copy()))
            results[idx] = out
        except Exception as err:  # noqa: BLE001 - reported by the assert
            errors.append(err)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(idx,))
                   for idx in ("t0", "t1", "t2", "t3")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 4
    ref = results["t0"]
    for idx in ("t1", "t2", "t3"):
        for a, b in zip(ref, results[idx]):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    # the pipeline lock: one pipeline per space
    assert len(engine._genome_pipelines) == 2
    pipeline = engine._genome_pipelines[id(par)][1]
    keys = {pipeline._key_of(g) for g in par.repair(par_genomes)}
    assert len(pipeline._sid) == len(keys)
    assert len(pipeline._rows["next_hop"]) == len(keys)
    assert len(pipeline._reports) == len(keys)


# ---------------------------------------------------------------------------
# against the reference: the port's solo runs on tests/test_serve.py's specs
# ---------------------------------------------------------------------------

# (algo, generations, pop_size, seed, max_evals) of every spec that
# tests/test_serve.py runs to completion, but nsga2 seed 12 (below)
_REF_SPECS = [
    ("nsga2", 5, 8, 1, None), ("nsga2", 5, 8, 2, None),
    ("sa", 5, 8, 1, None), ("sa", 5, 8, 2, None),
    ("random", 5, 8, 1, None), ("random", 5, 8, 2, None),
    ("nsga2", 4, 3, 3, None), ("nsga2", 4, 5, 5, None),
    ("nsga2", 4, 8, 8, None), ("nsga2", 8, 8, 4, None),
    ("sa", 4, 8, 5, None), ("nsga2", 10, 8, 6, 24),
    ("nsga2", 3, 8, 7, None), ("nsga2", 3, 8, 9, None),
    ("nsga2", 3, 8, 10, None), ("nsga2", 4, 8, 0, None),
    ("sa", 5, 8, 14, None), ("nsga2", 8, 8, 15, None),
    ("nsga2", 6, 8, 16, None),
]


def _both_specs(algo, generations, pop_size, seed, max_evals=None):
    kw = dict(job_id=f"{algo}-{seed}", algo=algo, generations=generations,
              pop_size=pop_size, seed=seed, space=dict(SPACE),
              max_evals=max_evals)
    return JobSpec(**kw), RefJobSpec(**kw)


def _design_keys(rows):
    return [{k: v for k, v in r.items() if k not in ("latency", "throughput")}
            for r in rows]


@pytest.mark.parametrize("algo,generations,pop_size,seed,max_evals",
                         _REF_SPECS)
def test_solo_front_matches_reference(algo, generations, pop_size, seed,
                                      max_evals):
    spec, ref_spec = _both_specs(algo, generations, pop_size, seed,
                                 max_evals)
    port_opt, rows = run_spec_solo(spec, device="cpu")
    ref_opt, ref_rows = ref_run_spec_solo(ref_spec)
    assert port_opt.evaluator.n_evals == ref_opt.evaluator.n_evals
    assert port_opt.generation == ref_opt.generation
    assert port_opt.state()["rng"] == ref_opt.state()["rng"]
    assert _design_keys(rows) == _design_keys(ref_rows)
    np.testing.assert_allclose([r["latency"] for r in rows],
                               [r["latency"] for r in ref_rows], rtol=RTOL)
    np.testing.assert_allclose([r["throughput"] for r in rows],
                               [r["throughput"] for r in ref_rows],
                               rtol=RTOL)


# ROADMAP Queue C, "NSGA-II tie at seed 12 of the serve specs": the two
# packages propose the same genomes through generation 4 (index 3); in that
# step's merged population designs 5 and 12 have the same true throughput
# (3860). The port's fixed-order sums give both exactly 3860.0, so design 12
# (lower latency) dominates design 5; the reference's f32 sums put design 5
# 2.4e-4 (6e-8 relative) above design 12, so it stays on the first front.
# Design 5's rank differs (1 vs 0) and the fifth generation's offspring
# differ.
_TIE = ("nsga2", 5, 8, 12)


def _pair_optimizers(algo, generations, pop_size, seed):
    spec, ref_spec = _both_specs(algo, generations, pop_size, seed)
    space = port_job.make_job_space(spec)
    port = port_job.make_job_optimizer(
        spec, space, algorithms.PopulationEvaluator(space, device="cpu"))
    ref_space = ref_job.make_job_space(ref_spec)
    ref = ref_job.make_job_optimizer(
        ref_spec, ref_space, ref_algorithms.PopulationEvaluator(ref_space))
    return port, ref


def _step_side_by_side(port, ref, gens):
    """Step both optimizers ``gens`` generations; returns the index of the
    first generation whose proposed genomes differ (None if none did)."""
    for g in range(gens):
        got, want = port.begin_step(), ref.begin_step()
        if not np.array_equal(got, want):
            return g
        ev, ref_ev = port.evaluator(got), ref.evaluator(want)
        np.testing.assert_allclose(ev.latency, ref_ev.latency, rtol=RTOL)
        np.testing.assert_allclose(ev.throughput, ref_ev.throughput,
                                   rtol=RTOL)
        port.finish_step(ev)
        ref.finish_step(ref_ev)
    return None


@pytest.mark.xfail(strict=True, reason="ROADMAP Queue C: NSGA-II tie at "
                   "seed 12 of the serve specs (sub-1e-5 throughputs)")
def test_nsga2_seed12_matches_reference_generation_by_generation():
    spec, ref_spec = _both_specs(*_TIE)
    port_opt, rows = run_spec_solo(spec, device="cpu")
    ref_opt, ref_rows = ref_run_spec_solo(ref_spec)
    assert _design_keys(rows) == _design_keys(ref_rows)
    port, ref = _pair_optimizers(*_TIE)
    assert _step_side_by_side(port, ref, gens=5) is None


def test_nsga2_seed12_flip_comes_from_a_throughput_tie():
    """The mechanism of the Queue C entry: generation index 4 is the first
    to differ; before it every objective agrees within 1e-5, and in index
    3's merged population the rank of design 5 differs because it ties
    design 12's throughput in the port and exceeds it by about 6e-8
    (relative) in the reference."""
    port, ref = _pair_optimizers(*_TIE)
    assert _step_side_by_side(port, ref, gens=3) is None
    got, want = port.begin_step(), ref.begin_step()
    np.testing.assert_array_equal(got, want)
    ev, ref_ev = port.evaluator(got), ref.evaluator(want)
    merged = {}
    for name, opt, e, mod in (("port", port, ev, algorithms),
                              ("ref", ref, ref_ev, ref_algorithms)):
        lat = np.concatenate([opt.pop.latency, e.latency])
        thr = np.concatenate([opt.pop.throughput, e.throughput])
        feas = np.concatenate([opt.pop.feasible, e.feasible])
        merged[name] = (lat, thr, mod.nondominated_ranks(lat, thr, feas))
    (lat_p, thr_p, rank_p), (lat_r, thr_r, rank_r) = (merged["port"],
                                                      merged["ref"])
    np.testing.assert_allclose(thr_p, thr_r, rtol=RTOL)
    assert lat_p[12] < lat_p[5] and lat_r[12] < lat_r[5]
    assert thr_p[5] == thr_p[12] == 3860.0
    assert thr_r[5] > thr_r[12] and thr_r[5] / thr_r[12] - 1 < 1e-6
    assert rank_p[5] == 1 and rank_r[5] == 0
    port.finish_step(ev)
    ref.finish_step(ref_ev)
    assert not np.array_equal(port.begin_step(), ref.begin_step())
