# Port of src/repro/serve/service.py: the same scheduler, co-batching round,
# fault isolation, drain/resume and manifest; SearchService takes device=
# and devices=.
"""The search service: many concurrent optimizer jobs, one device.

``SearchService`` runs a single scheduler thread that drives every
admitted job cooperatively through the ``OptimizerBase``
``begin_step``/``finish_step`` split. Each round it collects one pending
population from every running job, groups them by search-space identity,
concatenates each group into one **mega-batch**, and dispatches it
through the shared ``DseEngine`` — so a hundred small jobs fill the
device the way one large job would, through the same pow2 population
buckets (the fused eval is row-independent, and ``bucket_population``
padding is exact, so a row's metrics are bit-identical at any batch size
or offset: the load-propagation kernel's launch depends on the node count
only, the min-plus kernel's k split follows the batch but (min, +) is
exact in any order, and the CPU's slab form adds its flow in fixed row
groups whatever its tile). Results are sliced back per job and folded in through each job's own ``PopulationEvaluator``
(budget masks, non-finite quarantine, eval counting — the exact solo
path), so **every job's archive, RNG stream, and checkpoints are
bit-identical to the same spec run solo** (``job.run_spec_solo``;
asserted in tests/test_torch_serve.py).

Robustness model:

* **Fault isolation** — a mega-batch dispatch/materialization failure
  (including the ``chaos_fail_generation`` injection hook) falls back to
  per-job solo dispatches with bounded retries; only the job whose own
  dispatch keeps failing is marked FAILED. Batch-mates re-evaluate solo
  to the same bits. Non-finite rows quarantine per job slice.
* **Admission control + backpressure** — ``submit`` rejects with an
  explicit reason (``AdmissionError.reason``) once ``max_queued`` specs
  are waiting, when the service is draining, when the spec is invalid,
  or when the tenant's eval budget is already spent; sheds are counted
  per reason on ``serve.shed``. At most ``max_jobs`` jobs run at once;
  the rest queue.
* **Budgets and deadlines** — per-job ``max_evals`` stops a job early
  through the same pre-dispatch check the solo reference applies (the
  stopped front is still bit-identical); per-tenant budgets are enforced
  mid-run (the offending job fails, the tenant's other jobs keep their
  finished evals); per-job deadlines are monotonic-clock walls checked
  between generations.
* **Drain/resume** — ``drain()`` (the CLI wires it to SIGTERM) stops
  admission, finishes the in-flight round, snapshots every running job
  through the format-2 checksummed checkpoints, and writes an atomic
  manifest; a service restarted on the same ``state_dir`` resumes every
  job bit-identically. Per-generation checkpoints (``ckpt_every``) make
  even a SIGKILL resumable.
* **Observability** — queue/running gauges, mega-batch occupancy and
  round-latency histograms, shed/retry/fault counters, and spans on the
  scheduler round through ``repro_torch.obs``.

Scope: jobs evaluate through the fused device genome path or the host
``evaluate_points`` path (not co-batched, still isolated); fault-grid
(``FaultSetup``) jobs are not served — run those through ``repro_torch.opt``.

The shared engine runs on one explicit device: ``SearchService(device=None)``
builds ``DseEngine(device=None)``, the card, which raises without a GPU;
``device="cpu"`` runs the plain PyTorch path on the host. The scheduler
thread both launches a round and waits on its CUDA event
(``PendingGenomeEval.result``), so a round's rows are sliced only after the
device has finished them.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import numpy as np

from ..core.reports import ReportArrays
from ..dse.engine import DseEngine
from ..dse.genomes import GenomeEvalResult, PendingGenomeEval
from ..faults.harness import call_with_retry
from ..obs import metrics as _metrics
from ..obs.log import get_logger
from ..obs.trace import span as _span
from ..opt.algorithms import Budgets, PopulationEvaluator
from ..opt.runner import load_checkpoint_resilient, save_checkpoint
from ..utils import env as _env
from . import job as _job
from .job import (DONE, FAILED, QUEUED, RUNNING, SUSPENDED, TERMINAL,
                  BackendChaosError, Job, JobSpec, eval_budget_reached,
                  front_rows, write_front)

log = get_logger("serve")


class AdmissionError(RuntimeError):
    """A submission the service refused, with a machine-readable reason
    (``queue_full`` | ``draining`` | ``duplicate`` | ``bad_spec`` |
    ``tenant_budget`` | ``stopped``)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"job rejected ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason


def _slice_result(res: GenomeEvalResult, sl: slice) -> GenomeEvalResult:
    rep = {f.name: getattr(res.reports, f.name)
           for f in dataclasses.fields(res.reports)}
    return GenomeEvalResult(
        latency=res.latency[sl], throughput=res.throughput[sl],
        reports=ReportArrays(**{k: (None if v is None else v[sl])
                                for k, v in rep.items()}))


class _EvalRequest:
    """One job's pending population inside the current scheduler round."""

    def __init__(self, service, job: Job, space, genomes: np.ndarray):
        self.service = service
        self.job = job
        self.space = space
        self.genomes = genomes
        self.fetch = None            # installed by _flush_round

    def result(self) -> GenomeEvalResult:
        if self.fetch is None:
            raise RuntimeError("evaluation round was never flushed")
        return self.fetch()


class CoBatchEngine:
    """The engine facade each job's ``PopulationEvaluator`` sees.

    ``evaluate_genomes_async`` does not touch the device — it parks the
    population in the scheduler's current round and returns a pending
    handle; the scheduler later dispatches all parked populations as
    grouped mega-batches and the handle resolves to this job's row
    slice. Everything else delegates to the shared real engine, so
    host-path spaces and capability checks behave exactly as solo."""

    def __init__(self, service: "SearchService", job: Job):
        self._service = service
        self._job = job

    def supports_genomes(self, space) -> bool:
        return self._service.engine.supports_genomes(space)

    def supports_faults(self, space) -> bool:
        return False        # fault-grid jobs are out of serve's scope

    def evaluate_genomes_async(self, space, genomes) -> PendingGenomeEval:
        req = self._service._enqueue(self._job, space, genomes)
        return PendingGenomeEval(req.result)

    def evaluate_genomes(self, space, genomes) -> GenomeEvalResult:
        return self.evaluate_genomes_async(space, genomes).result()

    def evaluate_points(self, points, **kw):
        return self._service.engine.evaluate_points(points, **kw)


class SearchService:
    """A persistent, fault-isolated multi-job search scheduler.

    In-process use::

        svc = SearchService()
        svc.submit(JobSpec(job_id="a", algo="nsga2", generations=8))
        job = svc.wait("a")
        rows = job.result_rows      # bit-identical to run_spec_solo

    ``python -m repro_torch.serve`` wraps this with a jobs file, SIGTERM
    drain, and an optional HTTP front-end. Without an ``engine`` the
    service builds ``DseEngine(device=device, devices=devices)``: every
    visible card unless ``device``/``devices`` say otherwise
    (``device="cpu"`` is one host device, ``devices=["cpu"] * 4`` four host
    shards).
    """

    def __init__(self, engine: DseEngine | None = None,
                 device=None,
                 devices=None,
                 state_dir: str | None = None,
                 max_jobs: int | None = None,
                 max_queued: int | None = None,
                 tenant_budgets: dict | None = None,
                 retries: int | None = None,
                 default_deadline_s: float | None = None,
                 ckpt_every: int | None = None):
        self.engine = (engine if engine is not None
                       else DseEngine(device=device, devices=devices))
        self.state_dir = state_dir
        self.max_jobs = (max_jobs if max_jobs is not None
                         else _env.get_int("REPRO_SERVE_MAX_JOBS"))
        self.max_queued = (max_queued if max_queued is not None
                           else _env.get_int("REPRO_SERVE_MAX_QUEUED"))
        self.tenant_budgets = dict(tenant_budgets or {})
        self.retries = (retries if retries is not None
                        else _env.get_int("REPRO_SERVE_RETRIES"))
        if default_deadline_s is None:
            d = _env.get_int("REPRO_SERVE_DEADLINE_S")
            default_deadline_s = float(d) if d > 0 else None
        self.default_deadline_s = default_deadline_s
        self.ckpt_every = (ckpt_every if ckpt_every is not None
                           else _env.get_int("REPRO_SERVE_CKPT_EVERY"))

        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._jobs: dict[str, Job] = {}
        self._queue: list[Job] = []
        self._running: list[Job] = []
        self._tenant_spent: dict[str, int] = {}
        self._round: list[_EvalRequest] = []
        self._spaces: dict[tuple, object] = {}
        self._draining = False
        self._stopped = False
        self._thread: threading.Thread | None = None
        self._rounds = 0
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
            self._load_state_dir()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "SearchService":
        with self._lock:
            if self._stopped:
                raise RuntimeError("service already drained/stopped")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="repro-serve-scheduler",
                    daemon=True)
                self._thread.start()
        return self

    def __enter__(self) -> "SearchService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.drain()

    def drain(self, timeout_s: float | None = None) -> None:
        """Stop admission, finish the in-flight round, checkpoint every
        running job (state ``suspended``), write the manifest, and stop
        the scheduler thread. Idempotent."""
        if timeout_s is None:
            timeout_s = float(_env.get_int("REPRO_SERVE_DRAIN_TIMEOUT_S"))
        with self._lock:
            self._draining = True
            thread = self._thread
            self._wake.notify_all()
        if thread is not None:
            thread.join(timeout=timeout_s)
            if thread.is_alive():
                log.warning("[serve] drain timed out; scheduler thread "
                            "still busy (daemon, will not block exit)")
        with self._lock:
            if self._thread is None and not self._stopped:
                # never started: suspend queued jobs directly
                self._suspend_all()
                self._stopped = True

    # -- admission ----------------------------------------------------------
    def submit(self, spec: JobSpec, auto_start: bool = True) -> str:
        """Admit one job spec (auto-starting the scheduler), or raise
        ``AdmissionError`` with an explicit shed reason.
        ``auto_start=False`` only parks the spec — the queue drains once
        ``start()`` runs (pre-loading, backpressure tests)."""
        with self._lock:
            reason, detail = self._admission_check(spec)
            if reason is not None:
                _metrics.counter("serve.shed", reason=reason).inc()
                log.warning(f"[serve] shed job {spec.job_id!r}: {reason} "
                            f"{detail}")
                raise AdmissionError(reason, detail)
            job = Job(spec)
            self._jobs[spec.job_id] = job
            self._queue.append(job)
            self._write_manifest()
            self._wake.notify_all()
        if auto_start:
            self.start()
        return spec.job_id

    def _admission_check(self, spec: JobSpec) -> tuple[str | None, str]:
        if self._stopped:
            return "stopped", "service already drained"
        if self._draining:
            return "draining", "service is draining"
        try:
            spec.validate()
        except ValueError as err:
            return "bad_spec", str(err)
        if spec.job_id in self._jobs:
            return "duplicate", f"job id {spec.job_id!r} already submitted"
        if len(self._queue) >= self.max_queued:
            return "queue_full", (f"{len(self._queue)} jobs queued "
                                  f"(max_queued={self.max_queued})")
        budget = self.tenant_budgets.get(spec.tenant)
        if budget is not None \
                and self._tenant_spent.get(spec.tenant, 0) >= budget:
            return "tenant_budget", (f"tenant {spec.tenant!r} spent "
                                     f"{self._tenant_spent[spec.tenant]} "
                                     f"of {budget} evals")
        return None, ""

    # -- introspection ------------------------------------------------------
    def job(self, job_id: str) -> Job:
        with self._lock:
            return self._jobs[job_id]

    def jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs.values())

    def wait(self, job_id: str, timeout_s: float | None = None) -> Job:
        job = self.job(job_id)
        if not job.done_event.wait(timeout_s):
            raise TimeoutError(f"job {job_id!r} still "
                               f"{job.status} after {timeout_s}s")
        return job

    def wait_all(self, timeout_s: float | None = None) -> list[Job]:
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        for job in self.jobs():
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            self.wait(job.job_id, left)
        return self.jobs()

    def stats(self) -> dict:
        with self._lock:
            by_status: dict[str, int] = {}
            for job in self._jobs.values():
                by_status[job.status] = by_status.get(job.status, 0) + 1
            return {"queue_depth": len(self._queue),
                    "running": len(self._running),
                    "jobs": by_status,
                    "rounds": self._rounds,
                    "tenant_spent": dict(self._tenant_spent),
                    "evals_total": sum(j.n_evals
                                       for j in self._jobs.values()),
                    "draining": self._draining}

    # -- scheduler ----------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._lock:
                self._admit_locked()
                running = list(self._running)
                draining = self._draining
                _metrics.gauge("serve.queue_depth").set(len(self._queue))
                _metrics.gauge("serve.running").set(len(running))
                if draining:
                    self._suspend_all()
                    self._stopped = True
                    self._wake.notify_all()
                    return
                if not running:
                    self._wake.wait(timeout=0.1)
                    continue
            t0 = time.perf_counter()
            with _span("serve.round", jobs=len(running)):
                self._run_round(running)
            dt = time.perf_counter() - t0
            with self._lock:
                self._rounds += 1
            _metrics.histogram("serve.round_s").observe(dt)

    def _admit_locked(self) -> None:
        while self._queue and len(self._running) < self.max_jobs:
            job = self._queue.pop(0)
            job.status = RUNNING
            self._running.append(job)

    def _run_round(self, running: list[Job]) -> None:
        """One generation step for every running job: pre-checks and
        dispatch for all, then one grouped mega-dispatch, then ingest.
        A job admitted during the round simply joins the next one."""
        dispatched: list[tuple[Job, object]] = []
        for job in running:
            pending = self._begin_job_step(job)
            if pending is not None:
                dispatched.append((job, pending))
        self._flush_round()
        for job, pending in dispatched:
            self._finish_job_step(job, pending)

    def _begin_job_step(self, job: Job):
        """Pre-dispatch checks + ``begin_step`` + dispatch. Returns the
        pending population eval, or None when the job reached a terminal
        state instead."""
        try:
            if job.optimizer is None:
                self._start_job(job)
            now = time.monotonic()
            if job.deadline_at is not None and now > job.deadline_at:
                self._fail(job, "deadline",
                           f"exceeded {job.spec.deadline_s or self.default_deadline_s}s")
                return None
            if job.finished():
                self._complete(job)
                return None
            tenant = job.spec.tenant
            budget = self.tenant_budgets.get(tenant)
            if budget is not None and (self._tenant_spent.get(tenant, 0)
                                       + job.spec.pop_size) > budget:
                self._fail(job, "tenant_budget",
                           f"tenant {tenant!r} budget {budget} evals")
                return None
            job._gen_t0 = time.perf_counter()
            genomes = job.optimizer.begin_step()
            pending = job.optimizer.evaluator.dispatch(genomes)
            self._tenant_spent[tenant] = (
                self._tenant_spent.get(tenant, 0) + len(genomes))
            return pending
        except Exception as err:  # noqa: BLE001 - isolate per job
            self._fail(job, "error", f"{type(err).__name__}: {err}")
            return None

    def _start_job(self, job: Job) -> None:
        job.space = self._space_for(job.spec)
        evaluator = PopulationEvaluator(job.space,
                                        engine=CoBatchEngine(self, job),
                                        budgets=Budgets(**job.spec.budgets))
        job.optimizer = _job.make_job_optimizer(job.spec, job.space,
                                                evaluator)
        if job.resume_state is not None:
            job.optimizer.load_state(job.resume_state)
            job.resume_state = None
            # restarted server: the resumed evals count against the
            # tenant's budget exactly as they did pre-crash
            tenant = job.spec.tenant
            self._tenant_spent[tenant] = (
                self._tenant_spent.get(tenant, 0)
                + job.optimizer.evaluator.n_evals)
        job.started_at = time.monotonic()
        deadline = (job.spec.deadline_s if job.spec.deadline_s is not None
                    else self.default_deadline_s)
        if deadline:
            job.deadline_at = job.started_at + float(deadline)

    def _space_for(self, spec: JobSpec):
        """One shared space instance per canonical spec — the co-batching
        unit: identical specs share one device pipeline and jit cache
        (spaces are deterministic, stateless functions of their params,
        so sharing cannot couple jobs)."""
        key = spec.space_key()
        space = self._spaces.get(key)
        if space is None:
            space = self._spaces[key] = _job.make_job_space(spec)
        return space

    # -- the co-batching round ---------------------------------------------
    def _enqueue(self, job: Job, space, genomes: np.ndarray) -> _EvalRequest:
        req = _EvalRequest(self, job, space, np.asarray(genomes, np.int64))
        self._round.append(req)
        return req

    def _chaos_due(self, job: Job) -> bool:
        cg = job.spec.chaos_fail_generation
        return (cg is not None and job.optimizer is not None
                and job.optimizer.generation == cg)

    def _maybe_chaos(self, job: Job) -> None:
        if self._chaos_due(job):
            raise BackendChaosError(
                f"job {job.job_id!r} chaos-failed at generation "
                f"{job.optimizer.generation} (chaos_fail_generation)")

    def _flush_round(self) -> None:
        """Dispatch every parked population: group by space identity,
        concatenate each group into one mega-batch, install per-request
        fetchers that slice this job's rows back out. A group whose mega
        dispatch fails (or that contains a chaos-armed job) degrades to
        per-job solo dispatches — bit-identical rows, isolated failures."""
        parked, self._round = self._round, []
        groups: dict[int, list[_EvalRequest]] = {}
        for req in parked:
            groups.setdefault(id(req.space), []).append(req)
        for reqs in groups.values():
            total = sum(len(r.genomes) for r in reqs)
            _metrics.histogram("serve.batch_occupancy").observe(total)
            mega_pending = None
            if not any(self._chaos_due(r.job) for r in reqs):
                try:
                    with _span("serve.dispatch", jobs=len(reqs),
                               evals=total):
                        mega = np.concatenate([r.genomes for r in reqs])
                        mega_pending = self.engine.evaluate_genomes_async(
                            reqs[0].space, mega)
                except Exception as err:  # noqa: BLE001 - degrade to solo
                    _metrics.counter("serve.batch_fault").inc()
                    log.warning(f"[serve] mega-batch dispatch failed "
                                f"({type(err).__name__}: {err}); falling "
                                f"back to per-job dispatches")
                    mega_pending = None
            else:
                _metrics.counter("serve.batch_fault").inc()
            offset = 0
            for req in reqs:
                sl = slice(offset, offset + len(req.genomes))
                offset += len(req.genomes)
                req.fetch = self._make_fetch(req, mega_pending, sl)

    def _make_fetch(self, req: _EvalRequest, mega_pending, sl: slice):
        def fetch() -> GenomeEvalResult:
            if mega_pending is not None:
                try:
                    return _slice_result(mega_pending.result(), sl)
                except Exception as err:  # noqa: BLE001 - isolate batch-mates
                    _metrics.counter("serve.batch_fault").inc()
                    log.warning(f"[serve] mega-batch materialization "
                                f"failed ({type(err).__name__}: {err}); "
                                f"re-dispatching {req.job.job_id!r} solo")
            seen = {"attempts": 0}

            def attempt() -> GenomeEvalResult:
                if seen["attempts"]:
                    _metrics.counter("serve.retry").inc()
                seen["attempts"] += 1
                self._maybe_chaos(req.job)
                return self.engine.evaluate_genomes_async(
                    req.space, req.genomes).result()

            return call_with_retry(attempt, retries=self.retries,
                                   backoff=0.0,
                                   describe=f"serve-solo:{req.job.job_id}")

        return fetch

    # -- per-job completion path --------------------------------------------
    def _finish_job_step(self, job: Job, pending) -> None:
        try:
            ev = pending.result()
            with _span("serve.ingest", job=job.job_id):
                job.optimizer.finish_step(ev)
            job.gen_seconds.append(time.perf_counter() - job._gen_t0)
            _metrics.histogram("serve.generation_s").observe(
                job.gen_seconds[-1])
            if self._ckpt_due(job):
                self._checkpoint(job)
            if job.finished():
                self._complete(job)
        except Exception as err:  # noqa: BLE001 - isolate per job
            self._fail(job, "error", f"{type(err).__name__}: {err}")

    def _ckpt_due(self, job: Job) -> bool:
        return (self.state_dir is not None and self.ckpt_every > 0
                and job.optimizer.generation % self.ckpt_every == 0)

    def _ckpt_path(self, job: Job) -> str:
        return os.path.join(self.state_dir, f"job-{job.job_id}.json")

    def _front_path(self, job: Job) -> str:
        return os.path.join(self.state_dir, f"job-{job.job_id}.front.json")

    def _checkpoint(self, job: Job) -> None:
        save_checkpoint(self._ckpt_path(job), job.optimizer)

    def _complete(self, job: Job) -> None:
        job.result_rows = front_rows(job.optimizer, job.space)
        job.status = DONE
        if (job.spec.max_evals is not None
                and job.optimizer.generation < job.spec.generations):
            job.reason = "eval_budget"
        if self.state_dir:
            self._checkpoint(job)
            write_front(self._front_path(job), job.result_rows)
        self._terminal(job)
        log.info(f"[serve] job {job.job_id!r} done: "
                 f"{job.optimizer.generation} generations, "
                 f"{job.n_evals} evals, front {len(job.result_rows)}")

    def _fail(self, job: Job, reason: str, detail: str = "") -> None:
        job.status = FAILED
        job.reason = reason
        self._terminal(job)
        log.warning(f"[serve] job {job.job_id!r} failed ({reason}): "
                    f"{detail}")

    def _terminal(self, job: Job) -> None:
        if job.started_at is not None:
            job.wall_s = time.monotonic() - job.started_at
        _metrics.counter("serve.jobs", status=job.status).inc()
        with self._lock:
            if job in self._running:
                self._running.remove(job)
            self._write_manifest()
        job.done_event.set()

    # -- drain / restart ----------------------------------------------------
    def _suspend_all(self) -> None:
        """Under lock, at a round boundary: checkpoint every running job
        and park it (with everything queued) for a restarted server."""
        for job in list(self._running):
            if self.state_dir and job.optimizer is not None:
                self._checkpoint(job)
            job.status = SUSPENDED
        for job in self._queue:
            job.status = SUSPENDED
        self._running.clear()
        self._queue.clear()
        self._write_manifest()

    def _manifest_path(self) -> str:
        return os.path.join(self.state_dir, "jobs.json")

    def _write_manifest(self) -> None:
        if not self.state_dir:
            return
        import json
        entries = []
        for job in self._jobs.values():
            entries.append({"spec": job.spec.to_dict(),
                            "status": job.status,
                            "reason": job.reason,
                            "n_evals": job.n_evals})
        path = self._manifest_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"format": 1, "jobs": entries}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _load_state_dir(self) -> None:
        """Adopt a previous server's manifest: terminal jobs are kept as
        records, everything else re-queues and resumes from its newest
        loadable checkpoint (bit-identically — the format-2 resume
        semantics of ``opt.runner``)."""
        import json
        path = self._manifest_path()
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as err:
            log.warning(f"[serve] unreadable manifest {path} "
                        f"({type(err).__name__}: {err}); starting empty")
            return
        for entry in manifest.get("jobs", ()):
            spec = JobSpec.from_dict(entry["spec"])
            job = Job(spec)
            if entry.get("status") in TERMINAL:
                job.status = entry["status"]
                job.reason = entry.get("reason")
                if entry["status"] == DONE:
                    front = os.path.join(self.state_dir,
                                         f"job-{spec.job_id}.front.json")
                    if os.path.exists(front):
                        with open(front) as f:
                            job.result_rows = json.load(f)
                job.done_event.set()
            else:
                state, source = load_checkpoint_resilient(
                    os.path.join(self.state_dir, f"job-{spec.job_id}.json"))
                if state is not None:
                    job.resume_state = state
                    log.info(f"[serve] resuming job {spec.job_id!r} from "
                             f"{os.path.basename(source)} (generation "
                             f"{state.get('generation')})")
                job.status = QUEUED
                self._queue.append(job)
            self._jobs[spec.job_id] = job


__all__ = ["SearchService", "CoBatchEngine", "AdmissionError"]
