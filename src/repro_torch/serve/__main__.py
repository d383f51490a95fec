# Port of src/repro/serve/__main__.py: the same daemon, plus --device (the
# card by default); the entry point runs under the __main__ check.
"""``python -m repro_torch.serve`` — the search service as a daemon.

Runs a ``SearchService`` over a persistent ``--state-dir``: jobs come
from a ``--jobs`` JSON file (a list of ``JobSpec`` dicts) and/or the
optional ``--http`` front-end; every completed job's front lands in the
state dir as ``job-<id>.front.json`` (canonical bytes — see
``serve.job.front_json_bytes``). SIGTERM/SIGINT triggers a graceful
drain: the in-flight round finishes, every running job is checkpointed
(format-2, checksummed), and a server restarted on the same state dir
resumes every job bit-identically. A SIGKILL is also survivable — jobs
checkpoint every generation by default (``REPRO_SERVE_CKPT_EVERY``).

``--device`` picks the shared engine's devices: ``cuda``, the default,
shards every round over every visible card (``CUDA_VISIBLE_DEVICES``
chooses which) and raises without a GPU, or ``cpu`` for the plain PyTorch
path on one host device.

HTTP front-end (stdlib only, enabled with ``--http PORT``)::

    POST /jobs   {JobSpec json}   -> {"job_id": ...} | 429 {"error": reason}
    GET  /jobs/<id>               -> job summary
    GET  /stats                   -> scheduler stats
    POST /drain                   -> begin graceful drain

Example::

    PYTHONPATH=src python -m repro_torch.serve --state-dir serve_state \
        --jobs jobs.json --exit-when-idle
"""
from __future__ import annotations

import argparse
import json
import threading
import time

from ..faults.harness import graceful_shutdown
from ..obs.log import get_logger
from ..utils.device import cli_devices
from .job import TERMINAL, JobSpec
from .service import AdmissionError, SearchService

log = get_logger("serve")


def _parse_tenant_budgets(items: list[str]) -> dict:
    budgets = {}
    for item in items:
        tenant, _, evals = item.partition("=")
        if not evals:
            raise ValueError(f"--tenant-budget wants TENANT=EVALS, "
                             f"got {item!r}")
        budgets[tenant] = int(evals)
    return budgets


def _http_server(service: SearchService, port: int,
                 drain_requested: threading.Event):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):      # route to obs, not stderr
            log.debug(f"[serve.http] {fmt % args}")

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                self._reply(200, service.stats())
                return
            if self.path.startswith("/jobs/"):
                job_id = self.path[len("/jobs/"):]
                try:
                    self._reply(200, service.job(job_id).summary())
                except KeyError:
                    self._reply(404, {"error": f"no job {job_id!r}"})
                return
            self._reply(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):
            if self.path == "/drain":
                drain_requested.set()
                self._reply(200, {"draining": True})
                return
            if self.path == "/jobs":
                length = int(self.headers.get("Content-Length", 0))
                try:
                    spec = JobSpec.from_dict(
                        json.loads(self.rfile.read(length)))
                    self._reply(200, {"job_id": service.submit(spec)})
                except AdmissionError as err:
                    self._reply(429, {"error": err.reason,
                                      "detail": str(err)})
                except (TypeError, ValueError,
                        json.JSONDecodeError) as err:
                    self._reply(400, {"error": "bad_spec",
                                      "detail": str(err)})
                return
            self._reply(404, {"error": f"unknown path {self.path!r}"})

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="repro-torch-serve-http", daemon=True)
    thread.start()
    log.info(f"[serve] http front-end on 127.0.0.1:{server.server_port}")
    return server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Persistent multi-job search service with co-batched "
                    "device dispatches, fault isolation, and graceful "
                    "drain/resume.")
    p.add_argument("--state-dir", required=True,
                   help="checkpoint/manifest/front directory; a restarted "
                        "server on the same dir resumes every job")
    p.add_argument("--jobs", type=str, default=None,
                   help="JSON file with a list of JobSpec dicts to submit")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve the HTTP front-end on 127.0.0.1:PORT")
    p.add_argument("--max-jobs", type=int, default=None,
                   help="concurrently running job cap "
                        "(default REPRO_SERVE_MAX_JOBS)")
    p.add_argument("--max-queued", type=int, default=None,
                   help="queued job cap before shedding "
                        "(default REPRO_SERVE_MAX_QUEUED)")
    p.add_argument("--tenant-budget", action="append", default=[],
                   metavar="TENANT=EVALS",
                   help="per-tenant eval budget (repeatable)")
    p.add_argument("--exit-when-idle", action="store_true",
                   help="exit once every submitted job is terminal")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="devices of the shared engine (default cuda: "
                        "every visible GPU; cpu runs the plain PyTorch "
                        "path on the host)")
    args = p.parse_args(argv)

    service = SearchService(
        devices=cli_devices(args.device),
        state_dir=args.state_dir, max_jobs=args.max_jobs,
        max_queued=args.max_queued,
        tenant_budgets=_parse_tenant_budgets(args.tenant_budget))
    if args.jobs:
        with open(args.jobs) as f:
            specs = json.load(f)
        for spec in specs:
            try:
                service.submit(JobSpec.from_dict(spec))
            except AdmissionError as err:
                log.warning(f"[serve] jobs file entry rejected: {err}")
    service.start()

    drain_requested = threading.Event()
    server = (_http_server(service, args.http, drain_requested)
              if args.http is not None else None)

    with graceful_shutdown() as stop:
        while True:
            if stop.requested() or drain_requested.is_set():
                log.warning("[serve] drain requested; checkpointing "
                            "in-flight jobs")
                break
            stats = service.stats()
            idle = (stats["queue_depth"] == 0 and stats["running"] == 0
                    and all(j.status in TERMINAL for j in service.jobs()))
            if args.exit_when_idle and idle:
                log.info("[serve] idle and --exit-when-idle set; draining")
                break
            time.sleep(0.05)
    service.drain()
    if server is not None:
        server.shutdown()
    stats = service.stats()
    log.info(f"[serve] exit: {stats['jobs']} after {stats['rounds']} "
             f"rounds, {stats['evals_total']} evals")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
