"""Reduction of a ``torch.profiler`` trace of some calls to the device's
busy time, each kernel's time, and the idle gaps by what the host was doing.

The calls run inside one ``bench.window`` range, with the load driver's
steps marked by ``bench.*`` ranges (``bench.queue``, ``bench.repair``,
``bench.dispatch``, ``bench.result``). Every device operation the profiler
recorded (kernels, copies, fills) counts as busy; the window's time outside
their union is idle, and each idle gap is named by the driver's step and
the innermost host operation under way at its midpoint (``python`` where
none is).
"""
from __future__ import annotations

import numpy as np

TOP = 10
LOOK_BACK = 64          # host operations searched for the one around a gap


def _is_device(ev) -> bool:
    return (str(ev.device_type).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("bench."))


def profile(run_calls, *, calls: int, device: str, **shape):
    """Run ``run_calls(annotate)`` under the profiler. Returns (device
    readings or None where no device operation was recorded, breakdown);
    the readings carry ``shape`` (the call's sizes) for the readers."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        with record_function("bench.window"):
            run_calls(record_function)
            if device == "cuda":
                torch.cuda.synchronize()
    return reduce(prof.events(), calls=calls, **shape)


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end] intervals, sorted and disjoint."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.asarray(out)


def reduce(events, *, calls: int, **shape):
    window = [e for e in events if e.name == "bench.window"]
    if not window:
        return None, None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    dev = [e for e in events if _is_device(e)]
    if not dev:
        return None, None
    kernel_us: dict[str, float] = {}
    for e in dev:
        kernel_us[e.name] = kernel_us.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    iv = np.asarray([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                     for e in dev], np.float64)
    iv = _merge(iv[iv[:, 1] > iv[:, 0]])
    busy_us = float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0
    edges = np.concatenate([[w0], iv.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]

    host = [e for e in events if not str(e.device_type).endswith("CUDA")
            and e.name != "bench.window"]
    steps = [e for e in host if e.name.startswith("bench.")]
    ops = sorted((e for e in host if not e.name.startswith("bench.")),
                 key=lambda e: e.time_range.start)
    st_s = np.asarray([e.time_range.start for e in steps])
    st_e = np.asarray([e.time_range.end for e in steps])
    op_s = np.asarray([e.time_range.start for e in ops])
    op_e = np.asarray([e.time_range.end for e in ops])
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        hit = np.nonzero((st_s <= mid) & (st_e >= mid))[0]
        step = (min((steps[i] for i in hit),
                    key=lambda e: e.time_range.end - e.time_range.start).name
                if len(hit) else "outside")
        op = "python"
        j = int(np.searchsorted(op_s, mid, side="right"))
        lo = max(0, j - LOOK_BACK)
        cover = [k for k in range(lo, j) if op_e[k] >= mid]
        if cover:
            op = min((ops[k] for k in cover),
                     key=lambda e: e.time_range.end - e.time_range.start).name
        label = f"{step}/{op}"
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    readings = {"kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
                "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
                "calls": calls, **shape}
    breakdown = {
        "device_ops": [[k[:160], v / 1e6] for k, v in sorted(
            kernel_us.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k[:160], v] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]]}
    return readings, breakdown
