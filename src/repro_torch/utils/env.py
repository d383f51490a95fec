# Trimmed copy of src/repro/utils/env.py: only the knobs repro_torch reads.
"""Central registry of the ``REPRO_*`` environment knobs the port reads.

Every env-var read in ``repro_torch`` goes through this module: the knob's
name, type, default, and doc live in ONE place. Reads stay *dynamic* — the
value is fetched from the process environment at every call — so flipping a
knob mid-process takes effect on the next call.

* ``get_int`` — ``int(os.environ.get(name, default))``;
* ``get_opt_int`` — ``int(v) if v else None`` (unset and ``""`` both mean
  "auto");
* ``get_str`` — the raw string, knob default when unset;
* ``get_bool`` — false for ``"" / "0" / "false" / "off"``.

``override(NAME=value, OTHER=None)`` is a context manager for tests: it
sets (or, for ``None``, unsets) variables and restores the previous state on
exit.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

_FALSY = ("", "0", "false", "off")


@dataclass(frozen=True)
class Knob:
    """One registered environment knob."""
    name: str
    type: str                 # "int" | "str" | "bool" | "path"
    default: object           # None = unset / auto
    doc: str
    choices: tuple | None = None


KNOBS: dict[str, Knob] = {}


def _register(name: str, type: str, default, doc: str,
              choices: tuple | None = None) -> Knob:
    knob = Knob(name, type, default, doc, choices)
    KNOBS[name] = knob
    return knob


# --- kernels ---------------------------------------------------------------
_register(
    "REPRO_LOAD_PROP_FUSED_N", "int", 160,
    "Node count above which the plain (CPU) load propagation switches from "
    "the dense one-hot form to the destination-slab form. The CUDA kernel "
    "takes the slab form at every n.")
_register(
    "REPRO_LOAD_PROP_TILE", "int", None,
    "Pin the destination-slab tile of the plain slab form (auto via "
    "load_prop.pick_tile when unset). The CUDA kernel's slab depends on n "
    "only (load_prop.cuda_tile).")
_register(
    "REPRO_APSP_FUSED_N", "int", 160,
    "Node count above which APSP leaves the fused whole-matrix form for "
    "one blocked min-plus squaring per step (the tiled CUDA kernel on the "
    "card, the row-slab plain form on the CPU).")
_register(
    "REPRO_APSP_TILE", "int", None,
    "Pin the row-slab tile of the plain blocked APSP (auto via "
    "load_prop.pick_tile when unset). The CUDA kernels tile by n only.")

# --- routing ---------------------------------------------------------------
_register(
    "REPRO_ROUTING_BLOCK_N", "int", 160,
    "Node count above which routing-table construction switches to the "
    "destination-blocked scans.")
_register(
    "REPRO_ROUTING_TILE", "int", None,
    "Pin the destination-slab tile of the blocked routing scans (auto via "
    "load_prop.pick_tile when unset).")

# --- faults (simulator probes) ---------------------------------------------
_register(
    "REPRO_SIM_WATCHDOG_S", "int", 0,
    "Deadline in seconds around each FastSim saturation probe (0 = no "
    "watchdog). A probe that exceeds it is retried with backoff "
    "(faults/harness.call_with_retry).")
_register(
    "REPRO_SIM_RETRIES", "int", 1,
    "Bounded retry count for saturation probes that time out or raise "
    "(0 = fail fast).")

# --- sim -------------------------------------------------------------------
_register(
    "REPRO_CKERNEL_DIR", "path", None,
    "Cache directory for the runtime-compiled FastSim C kernel "
    "(default: $XDG_CACHE_HOME/repro_simfast_ckernel, mode 0700).")

# --- search service (repro_torch.serve) ------------------------------------
_register(
    "REPRO_SERVE_MAX_JOBS", "int", 8,
    "Search service: jobs running (co-batched) concurrently; further "
    "admitted jobs queue.")
_register(
    "REPRO_SERVE_MAX_QUEUED", "int", 64,
    "Search service: queued-job bound; submissions beyond it are shed "
    "with reason 'queue_full'.")
_register(
    "REPRO_SERVE_RETRIES", "int", 1,
    "Search service: bounded per-job solo-dispatch retries after a "
    "mega-batch or solo evaluation failure, before the job is FAILED.")
_register(
    "REPRO_SERVE_DEADLINE_S", "int", 0,
    "Search service: default per-job wall deadline in seconds (0 = "
    "none); JobSpec.deadline_s overrides per job.")
_register(
    "REPRO_SERVE_CKPT_EVERY", "int", 1,
    "Search service: checkpoint every running job each N generations "
    "(0 disables periodic snapshots; drain still checkpoints).")
_register(
    "REPRO_SERVE_DRAIN_TIMEOUT_S", "int", 30,
    "Search service: seconds drain() waits for the scheduler to finish "
    "the in-flight round and checkpoint before giving up.")

# --- observability ---------------------------------------------------------
_register(
    "REPRO_TRACE", "bool", "0",
    "Enable the process-wide span tracer at import "
    "('', '0', 'false', 'off' = disabled).")
_register(
    "REPRO_LOG", "str", "info",
    "Process-wide log verbosity of the 'repro_torch' logging root.",
    choices=("debug", "info", "quiet", "warning", "error"))


def _knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"{name} is not a registered REPRO_* knob of repro_torch; add it "
            f"to repro_torch/utils/env.py") from None


def get_str(name: str) -> str | None:
    """Raw string value; the knob default when unset."""
    knob = _knob(name)
    v = os.environ.get(name)
    return knob.default if v is None else v


def get_int(name: str) -> int:
    """``int(value)``; the knob default when unset."""
    knob = _knob(name)
    v = os.environ.get(name)
    return int(knob.default) if v is None else int(v)


def get_opt_int(name: str) -> int | None:
    """``int(value)``, or None when unset/empty (= "auto")."""
    _knob(name)
    v = os.environ.get(name)
    return int(v) if v else None


def get_bool(name: str) -> bool:
    """Truthy unless unset-default/'', '0', 'false', or 'off'."""
    knob = _knob(name)
    v = os.environ.get(name)
    if v is None:
        v = knob.default if knob.default is not None else ""
    return str(v).lower() not in _FALSY


@contextmanager
def override(**values):
    """Temporarily set (value) or unset (None) environment knobs; restores
    the prior environment on exit. Keys must be registered knobs."""
    for name in values:
        _knob(name)
    saved = {name: os.environ.get(name) for name in values}
    try:
        for name, v in values.items():
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = str(v)
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old


def table() -> list[dict]:
    """One row per knob (name, type, default, current, doc) — the
    ``python -m repro_torch.analysis --env`` listing."""
    rows = []
    for name in sorted(KNOBS):
        k = KNOBS[name]
        cur = os.environ.get(name)
        rows.append({
            "name": k.name, "type": k.type,
            "default": "(auto)" if k.default is None else str(k.default),
            "current": "(unset)" if cur is None else cur,
            "doc": k.doc,
            "choices": "|".join(k.choices) if k.choices else "",
        })
    return rows


def format_table() -> str:
    rows = table()
    cols = ("name", "type", "default", "current")
    widths = {c: max(len(c), *(len(r[c]) for r in rows)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols)]
    lines.append("  ".join("-" * widths[c] for c in cols))
    for r in rows:
        lines.append("  ".join(r[c].ljust(widths[c]) for c in cols))
        lines.append(" " * 4 + r["doc"]
                     + (f" [{r['choices']}]" if r["choices"] else ""))
    return "\n".join(lines)


__all__ = ["Knob", "KNOBS", "get_str", "get_int", "get_opt_int", "get_bool",
           "override", "table", "format_table"]
