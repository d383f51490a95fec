"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` at the
repository root (``.gitignore`` lists ``build/``), then loaded with
``ctypes``. The hash covers the source and the flags, so an edited source
builds anew and an unchanged one is loaded as it is. Nothing is built at
import: the first launch builds, or ``build_all`` builds every source at
once, one ``nvcc`` process per source, all started together.

No file here includes PyTorch's headers, so a build takes seconds, not the
minutes ``torch.utils.cpp_extension`` needs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}   # name -> nvcc/ptxas output of this process's build


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build repro_torch's kernels")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library exists already."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = SOURCES) -> float:
    """Compile every named source, all nvcc processes at once; returns the
    wall seconds. Sources already built are skipped."""
    t0 = time.perf_counter()
    with _LOCK:
        started = [(name, _start(name)) for name in names]
        try:
            for name, st in started:
                _finish(name, st)
        finally:
            for _, st in started:
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
    return time.perf_counter() - t0


def library(name: str, signatures: dict | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    ``signatures`` ({function: (restype, argtypes)}) applied."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in (signatures or {}).items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def _capability(index: int) -> tuple[int, int]:
    return torch.cuda.get_device_capability(index)


def require_sm90(device, what: str) -> None:
    """Raise unless ``device`` is an sm_90 GPU (the kernels are built for
    sm_90a only). The capability is read once per device and cached:
    every wrapper calls this on every launch."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    cap = _capability(index)
    if cap != (9, 0):
        raise RuntimeError(f"{what} is built for sm_90a; {device} is "
                           f"sm_{cap[0]}{cap[1]}")


__all__ = ["CSRC", "SOURCES", "NVCC_FLAGS", "BUILD_LOGS", "build_dir",
           "build_all", "library", "library_path", "nvcc", "require_sm90"]
