# Port of src/repro/serve/job.py: the same job model; run_spec_solo takes
# device=, and BackendChaosError lives here (the port's harness has none).
"""Job model for the search service.

A *job* is one complete optimizer run — algorithm, search-space spec,
population size, generation count, seed, budgets — submitted to the
``SearchService``. The spec is plain JSON-serializable data so the same
object travels through the in-process API, the ``--jobs`` file of
``python -m repro_torch.serve``, the HTTP front-end, and the drain manifest.

The one rule that everything else in ``repro_torch.serve`` leans on: a job's
entire trajectory is a deterministic function of its spec. All RNG draws
come from the job's own seeded stream inside the optimizer's
``begin_step``/``finish_step`` calls, and the device evaluation is
row-exact under co-batching (see ``service.py``), so ``run_spec_solo``
— the plain synchronous reference run below — defines the ground
truth every served job must reproduce bit-for-bit.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field

from ..opt.algorithms import Budgets, PopulationEvaluator
from ..opt.runner import make_optimizer, make_space


class BackendChaosError(RuntimeError):
    """The failure a job armed with ``JobSpec.chaos_fail_generation``
    raises at that generation's dispatch. The reference raises its kernel
    fallback ladder's exception of this name (``faults/harness.py``); the
    port has no such ladder, so the job-level hook keeps its own."""


# Job lifecycle. QUEUED -> RUNNING -> DONE | FAILED; SUSPENDED is the
# drain state (checkpointed, waiting for a restarted server to resume).
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
SUSPENDED = "suspended"
TERMINAL = (DONE, FAILED)

_DEFAULT_SPACE = {"kind": "adjacency", "n_chiplets": 10, "max_degree": 4}


@dataclass
class JobSpec:
    """One search job, as plain data (JSON round-trips exactly)."""
    job_id: str
    algo: str = "nsga2"                    # nsga2 | sa | random
    generations: int = 8
    pop_size: int = 8
    seed: int = 0
    tenant: str = "default"
    # make_space(**space): {"kind": "adjacency"|"parametric", ...params}
    space: dict = field(default_factory=lambda: dict(_DEFAULT_SPACE))
    budgets: dict = field(default_factory=dict)   # Budgets(**budgets)
    max_evals: int | None = None           # per-job eval budget
    deadline_s: float | None = None        # wall deadline from admission
    # Test/chaos hook: the job's dispatch raises BackendChaosError at this
    # generation — the fault-isolation path must fail THIS job only.
    chaos_fail_generation: int | None = None

    def to_dict(self) -> dict:
        return {"job_id": self.job_id, "algo": self.algo,
                "generations": self.generations, "pop_size": self.pop_size,
                "seed": self.seed, "tenant": self.tenant,
                "space": dict(self.space), "budgets": dict(self.budgets),
                "max_evals": self.max_evals, "deadline_s": self.deadline_s,
                "chaos_fail_generation": self.chaos_fail_generation}

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})

    def validate(self) -> None:
        from ..opt.algorithms import ALGORITHMS
        if self.algo not in ALGORITHMS:
            raise ValueError(f"unknown algo {self.algo!r}")
        if self.generations < 1 or self.pop_size < 1:
            raise ValueError("generations and pop_size must be >= 1")
        if self.space.get("kind") not in ("adjacency", "parametric"):
            raise ValueError(f"unknown space kind "
                             f"{self.space.get('kind')!r}")

    def space_key(self) -> tuple:
        """Canonical hashable identity of the search space: jobs with the
        same key share ONE space instance, one device pipeline, and one
        jit cache — the unit of cross-job co-batching."""
        return tuple(sorted((k, _canon(v)) for k, v in self.space.items()))


def _canon(value):
    """JSON round-trips tuples as lists; canonicalize for hashing and
    for the tuple-typed ParametricSpace fields."""
    return tuple(value) if isinstance(value, (list, tuple)) else value


def make_job_space(spec: JobSpec):
    kw = {k: _canon(v) for k, v in spec.space.items()}
    return make_space(kw.pop("kind"), **kw)


def make_job_optimizer(spec: JobSpec, space, evaluator: PopulationEvaluator):
    size_kw = {"random": "batch_size", "sa": "n_chains",
               "nsga2": "pop_size"}[spec.algo]
    return make_optimizer(spec.algo, space, evaluator, seed=spec.seed,
                          **{size_kw: spec.pop_size})


def eval_budget_reached(optimizer, spec: JobSpec) -> bool:
    """True when dispatching one more generation would overrun the job's
    eval budget — checked BEFORE ``begin_step`` so the RNG stream of a
    budget-stopped job is a prefix of the unbudgeted stream (shared by
    the service scheduler and ``run_spec_solo``)."""
    return (spec.max_evals is not None
            and optimizer.evaluator.n_evals + spec.pop_size > spec.max_evals)


class Job:
    """Mutable service-side record for one submitted spec."""

    def __init__(self, spec: JobSpec):
        self.spec = spec
        self.status = QUEUED
        self.reason: str | None = None     # why FAILED / stopped early
        self.space = None
        self.optimizer = None
        self.resume_state: dict | None = None   # checkpoint to load on start
        self.result_rows: list | None = None
        self.gen_seconds: list[float] = []
        self.wall_s: float | None = None
        self.started_at: float | None = None    # monotonic
        self.deadline_at: float | None = None   # monotonic
        self.done_event = threading.Event()

    @property
    def job_id(self) -> str:
        return self.spec.job_id

    @property
    def generation(self) -> int:
        return 0 if self.optimizer is None else self.optimizer.generation

    @property
    def n_evals(self) -> int:
        return (0 if self.optimizer is None
                else self.optimizer.evaluator.n_evals)

    def finished(self) -> bool:
        return (self.optimizer is not None
                and (self.optimizer.generation >= self.spec.generations
                     or eval_budget_reached(self.optimizer, self.spec)))

    def summary(self) -> dict:
        return {"job_id": self.job_id, "status": self.status,
                "reason": self.reason, "tenant": self.spec.tenant,
                "generation": self.generation,
                "generations": self.spec.generations,
                "n_evals": self.n_evals}


def run_spec_solo(spec: JobSpec, engine=None, device=None) -> tuple:
    """The ground-truth reference: run one spec synchronously to
    completion on a private evaluator and return ``(optimizer, rows)``.
    Every served job's front must be bit-identical to this (asserted in
    tests/test_torch_serve.py). Without an ``engine`` the evaluator builds
    ``DseEngine(device=device)``: the card unless ``device="cpu"``."""
    space = make_job_space(spec)
    evaluator = PopulationEvaluator(space, engine=engine,
                                    budgets=Budgets(**spec.budgets),
                                    device=device)
    opt = make_job_optimizer(spec, space, evaluator)
    while (opt.generation < spec.generations
           and not eval_budget_reached(opt, spec)):
        opt.step()
    return opt, front_rows(opt, space)


def front_rows(optimizer, space) -> list[dict]:
    """The archive front as JSON-ready rows (the byte-comparison unit of
    the bit-identity guarantee)."""
    from ..opt.runner import OptResult
    res = OptResult(archive=optimizer.archive,
                    n_evals=optimizer.evaluator.n_evals,
                    generations=optimizer.generation)
    return res.to_rows(space)


def front_json_bytes(rows: list[dict]) -> bytes:
    """Canonical serialization of a front — every producer (service,
    CLI, solo reference, benchmark) uses THIS, so byte comparison means
    value comparison."""
    return (json.dumps(rows, sort_keys=True, separators=(",", ":"))
            + "\n").encode("utf-8")


def write_front(path: str, rows: list[dict]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(front_json_bytes(rows))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


__all__ = ["BackendChaosError", "JobSpec", "Job", "QUEUED", "RUNNING",
           "DONE", "FAILED", "SUSPENDED", "TERMINAL", "make_job_space",
           "make_job_optimizer", "eval_budget_reached", "run_spec_solo",
           "front_rows", "front_json_bytes", "write_front"]
