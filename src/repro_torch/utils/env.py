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
    type: str                 # "int" | "str" | "bool"
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


__all__ = ["Knob", "KNOBS", "get_str", "get_int", "get_opt_int", "get_bool",
           "override"]
