# Port of src/repro/utils/version.py: the stamp names torch and its CUDA
# version where the reference names jax.
"""Version identification for checkpoints and telemetry.

``repro_torch`` ships in the same distribution as ``repro``, so the version
lives in the installed distribution metadata; source-tree runs
(PYTHONPATH=src without an install) fall back to the pyproject default.
"""
from __future__ import annotations

_DIST_NAME = "repro-rapidchiplet"
_FALLBACK = "0.1.0"


def repro_version() -> str:
    try:
        from importlib.metadata import version
        return version(_DIST_NAME)
    except Exception:
        return _FALLBACK


def version_stamp(config_hash: str | None = None) -> dict:
    """The {repro, torch, cuda[, config_hash]} stamp embedded in checkpoint
    snapshots so a resume from a different code/config version warns
    instead of silently mixing trajectories. ``cuda`` is the CUDA version
    torch was built with (None for a CPU build)."""
    import torch
    stamp = {"repro": repro_version(), "torch": torch.__version__,
             "cuda": torch.version.cuda}
    if config_hash is not None:
        stamp["config_hash"] = str(config_hash)
    return stamp


def check_version_stamp(stamp: dict | None, config_hash: str | None = None,
                        what: str = "checkpoint") -> list[str]:
    """Mismatch descriptions between a stored stamp and the current
    process (empty == clean). ``None``/missing stamps (snapshots written
    before stamping) report themselves so callers can warn once; a key
    the stored stamp lacks (a reference checkpoint names jax, not torch)
    is no mismatch."""
    if not stamp:
        return [f"{what} predates version stamping (no versions recorded)"]
    current = version_stamp(config_hash)
    out = []
    for key, now in current.items():
        then = stamp.get(key)
        if then is not None and then != now:
            out.append(f"{what} was written with {key}={then}, "
                       f"this process runs {key}={now}")
    return out


__all__ = ["repro_version", "version_stamp", "check_version_stamp"]
