# Port of src/repro/serve/__init__.py: the same exports.
"""Design-search-as-a-service: a persistent, fault-isolated multi-job
search server that co-batches concurrent NSGA-II/SA/random jobs into
shared device dispatches. See ``serve.service.SearchService`` (in-process
API) and ``python -m repro_torch.serve`` (CLI/daemon)."""
from .job import (Job, JobSpec, front_json_bytes, front_rows,
                  run_spec_solo, write_front)
from .service import AdmissionError, CoBatchEngine, SearchService

__all__ = ["SearchService", "CoBatchEngine", "AdmissionError", "Job",
           "JobSpec", "run_spec_solo", "front_rows", "front_json_bytes",
           "write_front"]
