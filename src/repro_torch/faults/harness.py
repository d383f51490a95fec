# Port of src/repro/faults/harness.py without the kernel-backend fallback
# ladder (see the docstring).
"""Graceful degradation of the search harness itself.

Long NSGA-II runs die for boring reasons: a NaN genome that poisons the
hypervolume, a probe that wedges, a SIGKILL that truncates the checkpoint
being written. This module concentrates the counter-measures:

* **Non-finite quarantine** — ``quarantine_nonfinite`` swaps NaN/inf
  objective rows for finite penalty scores, forces them infeasible (the
  Pareto archive never sees them), and records the genomes in a bounded
  quarantine list for post-mortems.
* **Watchdog** — ``call_with_retry`` wraps flaky blocking calls with
  bounded retries, exponential backoff, and an optional thread-safe
  monotonic deadline (the call runs on a sacrificial daemon thread; it
  works identically on the main thread and in worker threads).
* **Graceful shutdown** — ``graceful_shutdown()`` converts the first
  SIGTERM/SIGINT into a flag the optimizer loop polls (flush a final
  checkpoint, then exit); a second signal raises ``KeyboardInterrupt``.
* **Checkpoint integrity** — ``json_digest`` / ``file_digest`` and
  ``CheckpointCorruptError`` behind the optimizer's format-2 snapshots.

The reference's kernel-backend fallback ladder (``run_with_fallback``,
``maybe_chaos_fail``, ``chaos_backends``, ``strict_backend``,
``BackendChaosError`` and their ``REPRO_CHAOS_BACKEND_FAIL`` /
``REPRO_STRICT_BACKEND`` knobs) is not here: the port has no ladder. A
CUDA tensor runs the hand-written kernel or raises, and only a CPU tensor
takes the plain PyTorch version, so there is no cheaper rung to fall to.

Everything here is stdlib + numpy + ``repro_torch.obs`` only.
"""
from __future__ import annotations

import hashlib
import json
import signal
import threading
import time
from contextlib import contextmanager

import numpy as np

from ..obs import metrics as _metrics
from ..obs.log import get_logger

log = get_logger("faults")

# Penalty objectives assigned to quarantined genomes: finite (so ranks /
# crowding / SA energies stay well-defined) but strictly dominated by any
# real design.
PENALTY_LATENCY = 1e30
PENALTY_THROUGHPUT = 0.0


# --- non-finite quarantine --------------------------------------------------

_QUARANTINE: list[dict] = []
_QUARANTINE_CAP = 256


def quarantine_nonfinite(genomes: np.ndarray, latency: np.ndarray,
                         throughput: np.ndarray, feasible: np.ndarray,
                         context: str = "eval"
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replace non-finite objective rows with finite penalty scores.

    Returns ``(latency, throughput, feasible)`` copies where every genome
    with a NaN/inf latency or throughput gets ``PENALTY_LATENCY`` /
    ``PENALTY_THROUGHPUT`` and ``feasible=False`` — downstream selection
    math (ranks, crowding, SA energy, hypervolume) stays finite and the
    archive never ingests the row. Offenders land in the quarantine list
    (``drain_quarantine``) and on the ``faults.quarantine`` counter.
    """
    bad = ~(np.isfinite(latency) & np.isfinite(throughput))
    if not bad.any():
        return latency, throughput, feasible
    latency = np.where(bad, PENALTY_LATENCY, latency)
    throughput = np.where(bad, PENALTY_THROUGHPUT, throughput)
    feasible = feasible & ~bad
    n_bad = int(bad.sum())
    _metrics.counter("faults.quarantine", context=context).inc(n_bad)
    log.warning(f"[faults] quarantined {n_bad} non-finite genome(s) "
                f"({context}); archive unaffected")
    for i in np.nonzero(bad)[0][:_QUARANTINE_CAP]:
        if len(_QUARANTINE) >= _QUARANTINE_CAP:
            break
        _QUARANTINE.append({
            "context": context,
            "genome": np.asarray(genomes[i]).tolist(),
            "index": int(i),
        })
    return latency, throughput, feasible


def drain_quarantine() -> list[dict]:
    """Return and clear the quarantined-genome records."""
    out = list(_QUARANTINE)
    _QUARANTINE.clear()
    return out


# --- watchdog ---------------------------------------------------------------

class WatchdogTimeout(RuntimeError):
    """A watched call exceeded its monotonic deadline."""


def _run_with_deadline(fn, args, kwargs, seconds: float | None,
                       describe: str):
    """Run ``fn(*args, **kwargs)``, raising ``WatchdogTimeout`` after
    ``seconds`` of wall time (``time.monotonic``).

    The historical implementation used SIGALRM, which only works on the
    main thread — inside server worker threads the knob silently never
    fired. This version runs the call on a sacrificial daemon thread and
    waits on an event with a monotonic deadline, so it behaves the same
    on every thread. On timeout the daemon thread is abandoned (a wedged
    probe cannot be forcibly killed from Python); it holds no locks and
    its result is discarded if it ever finishes.
    """
    if not seconds:
        return fn(*args, **kwargs)
    box: dict = {}
    done = threading.Event()

    def _target():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as err:  # noqa: BLE001 - re-raised on caller
            box["error"] = err
        finally:
            done.set()

    worker = threading.Thread(
        target=_target, daemon=True,
        name=f"repro-watchdog:{describe or 'call'}")
    worker.start()
    if not done.wait(seconds):
        raise WatchdogTimeout(
            f"{describe or 'watched call'} exceeded {seconds:g}s")
    if "error" in box:
        raise box["error"]
    return box["value"]


def call_with_retry(fn, *args, retries: int = 2, backoff: float = 0.5,
                    timeout_s: float | None = None, describe: str = "",
                    exceptions: tuple = (Exception,), **kwargs):
    """Bounded-retry watchdog around a flaky blocking call.

    Runs ``fn(*args, **kwargs)`` under an optional thread-safe monotonic
    deadline (works on any thread; see ``_run_with_deadline``) and
    retries up to ``retries`` times on ``exceptions``, sleeping
    ``backoff * 2**attempt`` between attempts. Counts
    ``faults.watchdog_retry`` per retry; the final failure is re-raised.
    """
    describe = describe or getattr(fn, "__name__", "call")
    last_err = None
    for attempt in range(retries + 1):
        try:
            return _run_with_deadline(fn, args, kwargs, timeout_s,
                                      describe)
        except exceptions as err:
            last_err = err
            if attempt >= retries:
                break
            _metrics.counter("faults.watchdog_retry",
                             describe=describe).inc()
            log.warning(f"[faults] {describe} failed "
                        f"({type(err).__name__}: {err}); retry "
                        f"{attempt + 1}/{retries} after backoff")
            time.sleep(backoff * (2 ** attempt))
    raise last_err


# --- graceful shutdown ------------------------------------------------------

class ShutdownFlag:
    """Set by the first SIGTERM/SIGINT inside ``graceful_shutdown``."""

    def __init__(self):
        self._event = threading.Event()

    def set(self) -> None:
        self._event.set()

    def requested(self) -> bool:
        return self._event.is_set()


@contextmanager
def graceful_shutdown(signals: tuple = ("SIGTERM", "SIGINT")):
    """Convert the first termination signal into a pollable flag.

    The optimizer loop checks ``flag.requested()`` once per generation and
    exits through its normal checkpoint-flush path; a second signal falls
    through to ``KeyboardInterrupt`` so a hung flush can still be killed.
    Installing handlers only works on the main thread — elsewhere this
    degrades to a never-set flag.
    """
    flag = ShutdownFlag()
    if threading.current_thread() is not threading.main_thread():
        yield flag
        return

    def _handler(signum, frame):
        if flag.requested():       # second signal: give up gracefulness
            raise KeyboardInterrupt
        flag.set()
        _metrics.counter("faults.shutdown_signal", signum=signum).inc()
        log.warning(f"[faults] signal {signum}: finishing generation and "
                    f"flushing checkpoint (send again to force exit)")

    prev = {}
    for name in signals:
        sig = getattr(signal, name, None)
        if sig is None:
            continue
        try:
            prev[sig] = signal.signal(sig, _handler)
        except (ValueError, OSError):   # non-main thread / exotic platform
            continue
    try:
        yield flag
    finally:
        for sig, old in prev.items():
            signal.signal(sig, old)


# --- checkpoint integrity ---------------------------------------------------

class CheckpointCorruptError(RuntimeError):
    """A checkpoint (snapshot envelope or shard file) failed its sha256
    integrity check — the resume ladder falls back to the previous
    snapshot / next-newest step instead of crashing."""


def json_digest(state) -> str:
    """Canonical sha256 of a JSON-serializable object (sorted keys, tight
    separators) — the integrity field of optimizer snapshots."""
    blob = json.dumps(state, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def file_digest(path) -> str:
    """sha256 of a file's bytes (checkpoint shard integrity)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


__all__ = [
    "WatchdogTimeout", "ShutdownFlag", "quarantine_nonfinite",
    "drain_quarantine", "call_with_retry", "graceful_shutdown",
    "json_digest", "file_digest", "CheckpointCorruptError",
    "PENALTY_LATENCY", "PENALTY_THROUGHPUT",
]
