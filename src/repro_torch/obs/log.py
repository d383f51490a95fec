# Copy of src/repro/obs/log.py, kept so repro_torch never imports repro; the
# logging root is named ``repro_torch`` so the two packages never share handlers.
"""The repo's single structured logging root.

Every CLI/engine message that used to be an ad-hoc ``print(...)`` goes
through one ``logging`` root named ``repro_torch``:

* ``REPRO_LOG=debug|info|quiet`` controls verbosity process-wide
  (``quiet`` keeps warnings/errors only);
* at the default ``info`` level the handler writes the bare message to
  stdout — byte-compatible with the prints it replaced;
* loggers returned by ``get_logger`` accept structured fields:
  ``log.info("[opt] gen done", gen=3, evals=48)`` renders the message
  followed by ``gen=3 evals=48`` and keeps the fields machine-readable on
  the record (``record.fields``) for any attached handler.

Messages that used to hide behind ``progress=False`` / ``verbose=False``
flags log at ``debug`` — invisible by default, exactly as before, but one
``REPRO_LOG=debug`` away instead of a code change.
"""
from __future__ import annotations

import logging
import sys

from ..utils import env as _env

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "quiet": logging.WARNING, "warning": logging.WARNING,
           "error": logging.ERROR}


class _StdoutHandler(logging.StreamHandler):
    """Writes to *current* ``sys.stdout`` at emit time (not the object
    captured at configure time), so pytest capture and stream redirection
    behave like the prints this layer replaced."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):   # base __init__ assigns; current stdout wins
        pass


_ROOT = logging.getLogger("repro_torch")
_configured = False


def configure(level: str | None = None, force: bool = False) -> logging.Logger:
    """Idempotent root setup; ``level`` overrides ``REPRO_LOG``."""
    global _configured
    if _configured and not force and level is None:
        return _ROOT
    if level is None:
        level = _env.get_str("REPRO_LOG")
    resolved = _LEVELS.get(str(level).lower())
    if resolved is None:
        raise ValueError(f"unknown log level {level!r}; options: "
                         f"{sorted(set(_LEVELS))}")
    if force or not _ROOT.handlers:
        for h in list(_ROOT.handlers):
            _ROOT.removeHandler(h)
        handler = _StdoutHandler()
        handler.setFormatter(logging.Formatter("%(message)s"))
        _ROOT.addHandler(handler)
    _ROOT.setLevel(resolved)
    _ROOT.propagate = False
    _configured = True
    return _ROOT


class StructuredLogger:
    """Thin wrapper adding ``key=value`` structured fields to a stdlib
    logger. With no fields the output is byte-identical to the message —
    the print-compatibility contract."""

    __slots__ = ("_logger",)

    def __init__(self, logger: logging.Logger):
        self._logger = logger

    def isEnabledFor(self, level: int) -> bool:
        return self._logger.isEnabledFor(level)

    def log(self, level: int | str, msg: str, **fields) -> None:
        if isinstance(level, str):
            level = _LEVELS[level.lower()]
        if not self._logger.isEnabledFor(level):
            return
        if fields:
            msg = msg + " " + " ".join(f"{k}={v}" for k, v in fields.items())
        self._logger.log(level, msg, extra={"fields": fields or None})

    def debug(self, msg: str, **fields) -> None:
        self.log(logging.DEBUG, msg, **fields)

    def info(self, msg: str, **fields) -> None:
        self.log(logging.INFO, msg, **fields)

    def warning(self, msg: str, **fields) -> None:
        self.log(logging.WARNING, msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self.log(logging.ERROR, msg, **fields)


def get_logger(name: str | None = None) -> StructuredLogger:
    """Child of the single ``repro_torch`` root (``get_logger("dse")`` ->
    ``repro_torch.dse``); configures the root from ``REPRO_LOG`` on first use."""
    configure()
    logger = _ROOT if name is None else _ROOT.getChild(name)
    return StructuredLogger(logger)
