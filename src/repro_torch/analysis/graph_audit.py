# Port of src/repro/analysis/jaxpr_audit.py: the same contracts, checked on
# a record of the aten ops a program runs instead of on its jaxpr.
"""Level 1: contract auditor over recorded programs.

PyTorch runs eagerly, so there is no jaxpr to read: a :class:`Contract`
names one program of the port, a thunk that builds its inputs at
representative bucket shapes on a device and records a run of it, and the
structural properties that run must obey. :func:`record` runs the program
under a ``TorchDispatchMode`` that logs every aten op with the shapes and
dtypes of its tensor operands and outputs. The hand-written kernels are
ctypes calls (``kernels/build.py``), not ``torch.library`` ops, so the
record cannot see inside them: on a CUDA device each contract names the
kernels its run must launch, and their launch counters must advance.

Checks:

* ``forbidden_ops`` — aten ops that must not run anywhere in the program:
  the scatters (``SCATTER_OPS``: ``index_put``, ``scatter*``,
  ``index_add`` and the other indexed writes), the counterpart of the
  reference's ``SCATTER_PRIMITIVES``. Host callbacks have no aten
  counterpart, so the reference's ``CALLBACK_PRIMITIVES`` has none here.
* ``forbid_f64`` — no op may produce a float64 tensor. PyTorch does not
  canonicalize dtypes, so the one record is what the reference had to
  re-trace under ``enable_x64`` to see.
* ``max_transient_elements`` — no op output exceeds this element count:
  the bound that proves a blocked path streams slabs instead of
  materializing the dense intermediate.
* ``forbidden_shapes`` — symbolic shape patterns (``("P", "n", "n")``
  with a ``dims`` mapping chosen so the axes are distinguishable) that no
  op output may have.
* ``gather_index_min_bits`` — every integer index operand of an indexing
  read (``INDEX_OPS``: ``index``, ``index_select``, ``gather``, ``take``,
  ``embedding``; ``take_along_dim`` arrives as ``gather``) is at least
  this wide.
* ``out_dtypes`` — exact dtypes of the program's tensor outputs.
* ``ladder``/``ladder_expected`` — record the program at every raw size of
  a bucket ladder and require exactly the expected number of distinct
  programs (:func:`program_key`): the static proof that padding to buckets
  fixes the shapes the kernels see.
* ``kernels`` — on a CUDA device, the launch counters
  (:func:`launch_counts`) the program must advance: the proof that the
  kernel route ran.
* ``parity`` — on a CUDA device, every recorded run (the contract's own and
  the ladder's) is recorded again on the CPU, which takes the plain forms,
  and each output must agree within ``(rtol, atol)``; ``(0, 0)`` is bit
  equality. This holds the kernels against their plain versions at the
  shapes the contracts give them.

The reference's ``hlo``/``max_hlo_buffer_bytes`` bound reads XLA's
optimized HLO and has no counterpart here; it is dropped.

A program that runs on the host in numpy (``opt.space``'s degree cap) is
recorded by :func:`record_numpy` instead: every ndarray its frames bind,
as an op named ``numpy:<variable>``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding

REGISTRY_PATH = "src/repro_torch/analysis/registry.py"

SCATTER_OPS = ("index_put", "index_put_", "_index_put_impl_", "index_add",
               "index_add_", "index_copy", "index_copy_", "index_fill",
               "index_fill_", "index_reduce", "index_reduce_", "scatter",
               "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
               "scatter_reduce_", "masked_scatter", "masked_scatter_", "put",
               "put_")
INDEX_OPS = ("index", "_unsafe_index", "index_select", "gather", "take",
             "embedding")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One recorded op: its name (the aten overload packet, e.g.
    ``index_put_``), the (shape, dtype) of each tensor operand and output,
    and the dtypes of its integer index operands (``INDEX_OPS`` only)."""

    op: str
    inputs: tuple
    outputs: tuple
    index_dtypes: tuple = ()

    def signature(self) -> str:
        return f"{self.op}{self.inputs}->{self.outputs}"


@dataclasses.dataclass
class Trace:
    """A recorded run: the program's outputs and its ops in order."""

    outputs: Any
    ops: list


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    if isinstance(x, dict):
        return [t for item in x.values() for t in _tensors(item)]
    return []


def _spec(t: torch.Tensor) -> tuple:
    return (tuple(int(d) for d in t.shape), str(t.dtype).removeprefix("torch."))


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        operands = _tensors(args) + _tensors(kwargs)
        index_dtypes = ()
        if name in INDEX_OPS:
            index_dtypes = tuple(
                t.dtype for t in operands[1:]
                if not t.is_floating_point() and t.dtype != torch.bool
                and not t.is_complex())
        self.ops.append(OpRecord(
            op=name, inputs=tuple(_spec(t) for t in operands),
            outputs=tuple(_spec(t) for t in _tensors(out)),
            index_dtypes=index_dtypes))
        return out


def record(fn: Callable, *args) -> Trace:
    """Run ``fn(*args)`` under the recorder, after one unrecorded run, so
    that a cache filled on the first call (a built kernel library, a
    memoized table) does not make the first record differ from every later
    one."""
    with torch.no_grad():
        fn(*args)
        rec = _Recorder()
        with rec:
            out = fn(*args)
    return Trace(outputs=out, ops=rec.ops)


def record_numpy(fn: Callable, *args, function: str, module: str) -> Trace:
    """Run the host program ``fn(*args)`` with a line tracer on the frames
    of ``function`` in files ending in ``module``: every ndarray those
    frames bind is recorded once per (variable, shape, dtype), as an op
    named ``numpy:<variable>`` with that array as its output."""
    seen: dict[tuple, OpRecord] = {}

    def local(frame, event, arg):
        if event in ("line", "return"):
            for name, v in frame.f_locals.items():
                if isinstance(v, np.ndarray):
                    key = (name, v.shape, v.dtype.name)
                    if key not in seen:
                        seen[key] = OpRecord(
                            op=f"numpy:{name}", inputs=(),
                            outputs=((tuple(int(d) for d in v.shape),
                                      v.dtype.name),))
        return local

    def calls(frame, event, arg):
        code = frame.f_code
        if (event == "call" and code.co_name == function
                and code.co_filename.endswith(module)):
            return local
        return None

    old = sys.gettrace()
    sys.settrace(calls)
    try:
        out = fn(*args)
    finally:
        sys.settrace(old)
    return Trace(outputs=out, ops=list(seen.values()))


def program_key(trace: Trace) -> str:
    """Canonical hash of a recorded program: its distinct op signatures
    (op, operand and output shapes and dtypes) in first-seen order. Two
    runs are one program iff they run the same ops at the same shapes; a
    loop whose trip count follows the data (a BFS to the diameter, a hop
    loop that stops when no load is left) repeats signatures and adds
    none."""
    sigs = dict.fromkeys(op.signature() for op in trace.ops)
    return hashlib.sha1("\n".join(sigs).encode()).hexdigest()


def launch_counts() -> dict[str, int]:
    """The launch counter of every kernel wrapper of the port."""
    from ..kernels import apsp, flow_accum, load_prop, minplus, selective_scan
    fns = (load_prop.load_prop_cuda, apsp.apsp_fused_cuda,
           apsp.apsp_square_cuda, minplus.minplus_cuda,
           flow_accum.flow_accum_cuda, selective_scan.selective_scan_fwd_cuda,
           selective_scan.selective_scan_bwd_cuda)
    return {fn.__name__: fn.launches for fn in fns}


@dataclasses.dataclass
class Contract:
    """One audited program: how to record it and what its record must obey.

    ``trace`` and ``ladder`` are thunks of the device, so building the
    registry stays import-cheap: nothing runs until the audit does.
    ``ladder`` returns one recorded run per raw size of the ladder.
    """

    name: str
    trace: Callable[[torch.device], Trace]
    description: str = ""
    forbidden_ops: tuple[str, ...] = ()
    forbid_f64: bool = False
    max_transient_elements: int | None = None
    forbidden_shapes: tuple[tuple, ...] = ()      # symbolic dim patterns
    dims: dict | None = None                      # symbol -> concrete size
    gather_index_min_bits: int | None = None
    out_dtypes: tuple | None = None
    ladder: Callable[[torch.device], list[Trace]] | None = None
    ladder_expected: int | None = None
    kernels: tuple[str, ...] = ()                 # launch_counts() names
    parity: tuple[float, float] | None = None     # (rtol, atol) vs the CPU
    bench: dict | None = None                     # benchmark variant export

    def checks(self) -> list[str]:
        """The checks this contract declares, as ``--list`` prints them."""
        out = []
        if self.forbidden_ops:
            out.append("ops")
        if self.forbid_f64:
            out.append("f64")
        if self.max_transient_elements is not None:
            out.append(f"transient<={self.max_transient_elements}")
        if self.forbidden_shapes:
            out.append("shapes")
        if self.gather_index_min_bits:
            out.append(f"gather>={self.gather_index_min_bits}b")
        if self.out_dtypes is not None:
            out.append("out-dtypes")
        if self.ladder is not None:
            out.append(f"ladder={self.ladder_expected}")
        if self.kernels:
            out.append(f"kernels={'+'.join(self.kernels)}")
        if self.parity is not None:
            out.append("cpu-parity" if self.parity == (0.0, 0.0)
                       else f"cpu-parity<={self.parity[0]:g}r+"
                            f"{self.parity[1]:g}a")
        return out


def output_error(got, want, rtol: float, atol: float) -> tuple[float, bool]:
    """(largest absolute difference, whether every element agrees) of two
    runs' outputs, tensor by tensor in order: shapes and dtypes must match,
    and each element within ``atol + rtol * |want|`` (equal infinities
    agree; ``(0, 0)`` asks for equal values)."""
    gs, ws = _tensors(got), _tensors(want)
    if len(gs) != len(ws):
        return float("inf"), False
    worst, ok = 0.0, True
    for g, w in zip(gs, ws):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        g, w = g.detach().cpu(), w.detach().cpu()
        if not (g.is_floating_point() or g.is_complex()):
            g, w = g.to(torch.int64), w.to(torch.int64)
            same = g == w
        else:
            g, w = g.to(torch.float64), w.to(torch.float64)
            same = torch.isclose(g, w, rtol=rtol, atol=atol)
        diff = torch.where(g == w, 0.0, (g - w).abs().to(torch.float64))
        if diff.numel():
            worst = max(worst, float(diff.max()))
        ok = ok and bool(same.all())
    return worst, ok


def _resolve_shape(pattern: tuple, dims: dict | None) -> tuple:
    return tuple(dims[d] if isinstance(d, str) else d
                 for d in pattern) if dims else tuple(pattern)


def audit_contract(c: Contract, device="cpu",
                   info: dict | None = None) -> list[Finding]:
    """Run every declared check of one contract on ``device``; findings
    carry the contract name and anchor at the registry (the audit is a
    property of the recorded program, not of one source line). When
    ``info`` is a dict it receives ``runs``, every recorded :class:`Trace`
    (the contract's own run, then the ladder's), and on a CUDA device with
    a ``parity`` check ``cpu_max_abs_err``, the largest difference from
    the CPU's runs."""
    dev = torch.device(device)
    findings: list[Finding] = []

    def add(rule: str, message: str) -> None:
        findings.append(Finding(rule=rule, path=REGISTRY_PATH, line=0,
                                message=message, contract=c.name))

    on_cuda = dev.type == "cuda"
    before = launch_counts() if on_cuda else {}
    try:
        trace = c.trace(dev)
    except Exception as e:   # a registry entry that fails to run IS a finding
        add("audit-trace-error", f"recording failed: {e!r}")
        return findings
    runs = [trace]
    if on_cuda:
        after = launch_counts()
        for k in c.kernels:
            if after[k] == before[k]:
                add("audit-kernel-route",
                    f"kernel {k} did not launch on {dev}: the program "
                    "did not take the kernel route")

    forbidden = set(c.forbidden_ops)
    seen_forbidden: dict[str, int] = {}
    f64_ops: dict[str, int] = {}
    max_elems = 0
    max_elems_op = ""
    shape_hits: dict[tuple, str] = {}
    resolved = [(_resolve_shape(p, c.dims), p) for p in c.forbidden_shapes]
    narrow: dict[str, set] = {}

    for op in trace.ops:
        if op.op in forbidden:
            seen_forbidden[op.op] = seen_forbidden.get(op.op, 0) + 1
        if c.gather_index_min_bits:
            for dt in op.index_dtypes:
                if dt.itemsize * 8 < c.gather_index_min_bits:
                    narrow.setdefault(op.op, set()).add(
                        str(dt).removeprefix("torch."))
        for shape, dtype in op.outputs:
            size = 1
            for d in shape:
                size *= d
            if size > max_elems:
                max_elems, max_elems_op = size, op.op
            for concrete, symbolic in resolved:
                if shape == concrete and concrete not in shape_hits:
                    shape_hits[concrete] = op.op
            if c.forbid_f64 and dtype == "float64":
                f64_ops[op.op] = f64_ops.get(op.op, 0) + 1

    for name, count in sorted(seen_forbidden.items()):
        add("audit-forbidden-op",
            f"forbidden op {name!r} runs {count}x in the program")
    for name, count in sorted(f64_ops.items()):
        add("audit-f64",
            f"{name} produces float64 {count}x; the device path runs in "
            "float32: cast explicitly")
    if c.max_transient_elements is not None \
            and max_elems > c.max_transient_elements:
        add("audit-transient-bound",
            f"largest transient is {max_elems} elements (a {max_elems_op} "
            f"output) > bound {c.max_transient_elements}")
    for concrete, name in shape_hits.items():
        sym = next(s for r, s in resolved if r == concrete)
        add("audit-forbidden-shape",
            f"transient of forbidden shape {sym} (= {concrete}, a {name} "
            "output) materialized")
    for name, dts in sorted(narrow.items()):
        add("audit-gather-index",
            f"{name} indexed by {sorted(dts)} (< {c.gather_index_min_bits}"
            "-bit); widen table indices before the gather")

    if c.out_dtypes is not None:
        outs = tuple(t.dtype for t in _tensors(trace.outputs))
        if outs != tuple(c.out_dtypes):
            add("audit-out-dtype",
                f"output dtypes {tuple(str(d) for d in outs)} != expected "
                f"{tuple(str(d) for d in c.out_dtypes)}")

    if c.ladder is not None:
        try:
            traces = c.ladder(dev)
        except Exception as e:
            add("audit-trace-error", f"ladder recording failed: {e!r}")
        else:
            runs.extend(traces)
            keys = [program_key(t) for t in traces]
            distinct = len(set(keys))
            if c.ladder_expected is not None \
                    and distinct != c.ladder_expected:
                add("audit-recompile",
                    f"bucket ladder yields {distinct} distinct programs "
                    f"over {len(keys)} sizes; expected {c.ladder_expected} "
                    "— bucketing is fragmented or over-merged")

    if on_cuda and c.parity is not None:
        cpu = torch.device("cpu")
        try:
            want = [c.trace(cpu)] + (c.ladder(cpu) if c.ladder else [])
        except Exception as e:
            add("audit-trace-error", f"CPU recording failed: {e!r}")
        else:
            rtol, atol = c.parity
            worst, bad = 0.0, []
            for i, (g, w) in enumerate(zip(runs, want)):
                err, ok = output_error(g.outputs, w.outputs, rtol, atol)
                worst = max(worst, err)
                if not ok:
                    bad.append(i)
            if len(runs) != len(want):
                bad.append(len(want))
            if bad:
                add("audit-cpu-parity",
                    f"runs {bad} of {len(runs)} differ from the CPU's plain "
                    f"forms (largest |difference| {worst:g}, allowed "
                    f"rtol {rtol:g} atol {atol:g})")
            if info is not None:
                info["cpu_max_abs_err"] = worst
    if info is not None:
        info["runs"] = runs
    return findings


def audit_all(contracts: list[Contract], device="cpu") -> list[Finding]:
    findings: list[Finding] = []
    for c in contracts:
        findings += audit_contract(c, device)
    return findings


__all__ = ["Contract", "OpRecord", "Trace", "record", "record_numpy",
           "program_key", "launch_counts", "output_error", "audit_contract",
           "audit_all",
           "SCATTER_OPS", "INDEX_OPS", "REGISTRY_PATH"]
