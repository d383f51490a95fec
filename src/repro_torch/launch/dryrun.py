"""Dry-run of every (architecture x input shape x production mesh): trace
each step on the meta device and record what one device of the mesh would
compute, hold and send; port of ``src/repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  # 2x16x16 only

Artifacts: ``dryrun_out/<arch>__<shape>__<mesh>[__<tag>].json`` at the
repository root (``--out`` for another directory).

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's cost and memory analysis. The port has no compiler and no
partitioner, so a cell here is counted from a shape-only trace:

* ``Model(cfg, device="meta")`` and meta inputs from ``token_spec``: no
  memory is allocated and no weight is drawn (the port's
  ``jax.eval_shape``). The dry-run needs no device at all.
* The step (the train step with AdamW and ``accum_steps_for``'s
  microbatches, ``prefill`` or ``decode_step``) runs once under
  ``FlopCounterMode`` and a dispatch mode that sums each op's input and
  output bytes and follows the live tensor bytes (``StepCounter``). Eager
  PyTorch does not fuse, so those bytes are the traffic the port's program
  makes; they are both ``bytes_per_device`` and
  ``bytes_per_device_unfused``.
* The layer stack is traced at 2 and 3 layers (the encoder-decoder's two
  stacks together; DeepSeek's leading dense layer kept) and extrapolated
  to the full depth: every layer runs the same ops at the same shapes, so
  the counts are affine in the depth, as the reference's HLO analysis
  multiplies a scanned layer body by its trip count. A stack of at most 3
  layers is traced whole.
* Per device: FLOPs and bytes are the totals over ``n_devices`` (an ideal
  split; the partitioned program's redundancy waits for the multi-GPU
  slice), FlopCounterMode counts matrix products only, argument and output
  bytes come exactly from the sharding specs, and collectives are
  ``autoshard.training_collective_demand``'s analytic terms.

The record keeps the reference's keys except those with no torch meaning
(``xla_raw``, ``n_while_loops``, ``memory.code_bytes``, ``compile_s``);
``lower_s`` is the trace's seconds, and ``counted_by`` says how each
number was counted. One trace serves both meshes where the step is the
same (the mesh changes only the division); a train step whose
microbatch count differs between the meshes is traced once for each.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ARCH_IDS, get_config
from ..models import Model, SHAPES_BY_NAME, shape_applicable, token_spec
from ..models.config import ModelConfig
from ..models.inputs import ASSIGNED_SHAPES, ShapeSpec
from ..obs.log import get_logger
from ..sharding import DEFAULT_RULES, LONG_CONTEXT_RULES, SERVING_RULES
from ..sharding.annotate import PartitionSpec, resolve_spec, spec_ways
from ..sharding.autoshard import training_collective_demand
from ..sharding.rules import batch_specs, cache_specs, param_specs
from ..train import adamw_init, make_train_step
from ..train.optimizer import OptConfig
from ..train.state import init_train_state, train_state_specs
from .mesh import make_production_mesh

_LOG = get_logger("launch.dryrun")

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_out")

# traced depths of the layer stack; deeper stacks are extrapolated
_DEPTHS = (2, 3)

COUNTED_BY = {
    "flops": "torch.utils.flop_counter.FlopCounterMode over the meta trace "
             "(matrix products only), / n_devices (an ideal split)",
    "bytes": "every op's input and output bytes over the meta trace (views "
             "and uninitialised allocations excluded; eager runs unfused), "
             "/ n_devices (an ideal split)",
    "depth": "the layer stack traced at 2 and 3 layers and extrapolated "
             "linearly to the full depth",
    "argument_bytes": "sum over leaves of nbytes / the mesh ways of the "
                      "leaf's spec (sharding.rules)",
    "output_bytes": "the same over the step's outputs: the new state, or "
                    "the logits (and the cache)",
    "temp_bytes": "peak live tensor bytes of the trace less its arguments, "
                  "/ n_devices; a replicated f32 accumulation buffer "
                  "counted whole (accum_rs: at the parameter specs)",
    "collectives": "autoshard.training_collective_demand: every term for "
                   "train, the forward terms (TP activations, one FSDP "
                   "gather a layer) for prefill and decode",
}


def _data_ways(mesh) -> int:
    ways = 1
    for a in ("pod", "data"):
        if a in mesh.shape:
            ways *= mesh.shape[a]
    return ways


def _rules_for(spec, mesh) -> tuple:
    # long-context serving with tiny batch: shard the sequence instead
    if spec.global_batch < _data_ways(mesh):
        return LONG_CONTEXT_RULES
    return DEFAULT_RULES


def accum_steps_for(cfg, spec, mesh) -> int:
    """Gradient-accumulation microbatching: bound per-device activation
    memory. Target <= ~4 sequences per device per microbatch, fewer for
    wide models."""
    per_dev = max(spec.global_batch // _data_ways(mesh), 1)
    target = 4
    if cfg.d_model >= 4096:
        target = 2
    if cfg.d_model >= 6144:
        target = 1
    accum = max(per_dev // target, 1)
    while accum > 1 and spec.global_batch % accum != 0:
        accum -= 1
    return max(accum, 1)


def model_flops(cfg, spec) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D = tokens/step."""
    n = cfg.active_params() if cfg.is_moe else cfg.n_params()
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * n * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * spec.global_batch       # decode: 1 token per sequence


# Named deviations from the paper-faithful baseline:
#   serve_tp    decode with the pure-TP param layout (SERVING_RULES)
#   accum_rs    grad-accumulation buffer sharded like params
#   ssm_fused   the fused selective-scan kernel for SSM blocks
#   bf16_gather cast the param tree to bf16 at loss entry
VARIANTS = ("baseline", "serve_tp", "accum_rs", "ssm_fused", "bf16_gather")


def variant_config(cfg: ModelConfig, variant: str) -> ModelConfig:
    if variant == "ssm_fused":
        return cfg.replace(ssm_kernel=True)
    if variant == "bf16_gather":
        return cfg.replace(cast_params_bf16=True)
    return cfg


def ssm_kernel_io_bytes(cfg, spec, mesh, accum: int) -> float:
    """Analytic HBM I/O of the fused selective-scan kernel per train step
    per device (fwd + remat fwd + bwd). The meta trace sees the kernel as
    one shape-only op, so this is its traffic added back."""
    if not cfg.uses_ssm or spec.kind != "train":
        return 0.0
    data_ways = _data_ways(mesh)
    model_ways = mesh.shape["model"] if "model" in mesh.shape else 1
    b = max(spec.global_batch // accum // data_ways, 1)
    s = spec.seq_len
    di = cfg.d_inner // model_ways if cfg.d_inner % model_ways == 0 \
        else cfg.d_inner
    n = cfg.ssm_state
    chunk = cfg.ssm_chunk
    bsd = b * s * di * 4.0
    bsn = b * s * n * 4.0
    ckpt = b * (s // max(chunk, 1)) * di * n * 4.0
    fwd = 3 * bsd + 2 * bsn + ckpt            # xc,dt in; y out; bm,cm; ckpt
    n_d = max(di // 128, 1)
    bwd = 5 * bsd + 2 * bsn * (1 + n_d) + ckpt + 2 * di * n * 4.0
    per_layer = 2 * fwd + bwd                 # fwd + remat-recompute + bwd
    return per_layer * cfg.n_layers * accum


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default}


def _phase() -> str:
    """Which part of a step is running: autograd's backward, a forward
    that records a graph, or the rest (the optimizer, the accumulation,
    serving under no_grad)."""
    if torch._C._current_graph_task_id() != -1:
        return "backward"
    return "forward" if torch.is_grad_enabled() else "other"


class StepCounter(TorchDispatchMode):
    """Bytes every op reads and writes (each tensor argument and output
    once; views and uninitialised allocations move nothing) and the live
    tensor bytes, each storage counted once from its first appearance
    until it is freed. ``peaks`` keeps the most live bytes of each phase
    (``_phase``): each is affine in the depth of the layer stack, their
    maximum is not, so a depth extrapolation takes them one by one."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peaks: dict[str, int] = {}
        self._storages = WeakIdKeyDictionary()

    def _free(self, nbytes: int, _ref) -> None:
        self.live -= nbytes

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[st] = weakref.ref(
            st, lambda ref, n=nbytes: self._free(n, ref))
        self.live += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view and func not in _NO_TRAFFIC:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        for t in outs:
            self.track(t)
        phase = _phase()
        self.peaks[phase] = max(self.peaks.get(phase, 0), self.live)
        return out


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def trace_counts(fn, inputs) -> dict:
    """Run ``fn()`` once under FlopCounterMode and a ``StepCounter``, with
    the tensors of ``inputs`` live from the start; returns flops, bytes,
    the argument bytes ("entry") and each phase's peak live bytes
    ("peak/<phase>")."""
    counter = StepCounter()
    for t in _tensors(inputs):
        counter.track(t)
    entry = counter.live
    flops = FlopCounterMode(display=False)
    with flops, counter:
        fn()
    return {"flops": flops.get_total_flops(), "bytes": counter.bytes,
            "entry": entry,
            **{f"peak/{k}": v for k, v in counter.peaks.items()}}


def peak_bytes(counts: dict) -> int:
    """The most live bytes over every phase of ``trace_counts``' result."""
    return max(v for k, v in counts.items() if k.startswith("peak/"))


def _stack_depth(cfg: ModelConfig) -> int:
    n_dense = cfg.first_dense_layers if cfg.is_moe else 0
    depth = cfg.n_layers - n_dense
    if cfg.family == "encdec" and cfg.n_encoder_layers != depth:
        raise ValueError(f"{cfg.name}: encoder and decoder stacks differ "
                         f"({cfg.n_encoder_layers} vs {depth})")
    return depth


def cut_depth(cfg: ModelConfig, depth: int) -> ModelConfig:
    """``cfg`` with ``depth`` layers in its stack (both stacks of the
    encoder-decoder; DeepSeek's leading dense layers kept)."""
    n_dense = cfg.first_dense_layers if cfg.is_moe else 0
    kw = {"n_layers": n_dense + depth}
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = depth
    return cfg.replace(**kw)


def meta_batch(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in token_spec(cfg, spec).items()}


def step_program(cfg: ModelConfig, spec: ShapeSpec, accum: int = 1,
                 constrain_accum: bool = False):
    """(fn, inputs): the step of ``spec.kind`` on a meta model of ``cfg``,
    ready to run once, and the tensors it takes."""
    model = Model(cfg, device="meta")
    batch = meta_batch(cfg, spec)
    if spec.kind == "train":
        state = init_train_state(model, adamw_init)
        step = make_train_step(model, OptConfig(), accum_steps=accum,
                               constrain_accum=constrain_accum)
        return (lambda: step(state, batch)), (state, batch)
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "pos")}
    if spec.kind == "prefill":
        return (lambda: model.prefill(batch["tokens"], extra=extra)), batch
    cache = model.init_cache(spec.global_batch, spec.seq_len)
    return ((lambda: model.decode_step(cache, batch["tokens"],
                                       spec.seq_len - 1)),
            (dict(model.named_parameters()), cache, batch))


def count_step(cfg: ModelConfig, spec: ShapeSpec, accum: int = 1,
               constrain_accum: bool = False) -> dict:
    """The step's counts at ``cfg``'s full depth, traced on meta at 2 and 3
    layers and extrapolated (whole where the stack has at most 3)."""
    depth = _stack_depth(cfg)

    def at(d):
        fn, inputs = step_program(cut_depth(cfg, d), spec, accum,
                                  constrain_accum)
        return trace_counts(fn, inputs)

    t0 = time.perf_counter()
    if depth <= _DEPTHS[-1]:
        out = at(depth)
    else:
        lo, hi = (at(d) for d in _DEPTHS)
        out = {k: lo[k] + (depth - _DEPTHS[0]) * (hi[k] - lo[k]) for k in lo}
    out["trace_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# per-device accounting
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def sharded_bytes(leaves: dict, specs: dict, mesh) -> int:
    """Sum over leaves of nbytes / the mesh ways of the leaf's spec."""
    return sum(_nbytes(t) // spec_ways(specs[k], mesh)
               for k, t in leaves.items())


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                           PartitionSpec):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def cell_demands(cfg: ModelConfig, spec: ShapeSpec, mesh, rules) -> list:
    """The cell's analytic collectives: every term of the training layout
    for a train step; for prefill and decode the forward terms only (the
    TP activation all-reduces, 2 a layer, and one FSDP gather a layer, none
    where the rules keep the parameters whole on the data axes)."""
    rules_d = dict(rules)
    model_ways = mesh.shape.get("model", 1)

    def ways(logical):
        return spec_ways(resolve_spec((logical,), mesh, rules_d), mesh)

    if spec.kind == "train":
        return training_collective_demand(cfg, spec.global_batch,
                                          spec.seq_len, ways("batch"),
                                          model_ways)
    seq = spec.seq_len if spec.kind == "prefill" else 1
    act = training_collective_demand(cfg, spec.global_batch, seq,
                                     ways("batch"), model_ways)
    out = [dataclasses.replace(d, count_per_step=d.count_per_step // 2)
           for d in act if d.tag == "tp_activations"]
    if ways("fsdp") > 1:
        gather = training_collective_demand(cfg, spec.global_batch, seq,
                                            ways("fsdp"), model_ways)
        out += [dataclasses.replace(d, count_per_step=d.count_per_step // 2)
                for d in gather if d.tag == "fsdp_gather"]
    return out


def _rules_name(rules) -> str:
    return ("serving" if rules is SERVING_RULES else
            "long_context" if rules is LONG_CONTEXT_RULES else "default")


def dry_run_cell(cfg: ModelConfig, spec: ShapeSpec, mesh, *,
                 variant: str = "baseline", accum_override: int = 0,
                 arch: str | None = None, traces: dict | None = None) -> dict:
    """The record of one cell. ``traces`` caches step counts across
    meshes: a step is traced once per (config, shape, microbatch count)."""
    arch = arch or cfg.name
    base = {"arch": arch, "shape": spec.name, "mesh": mesh.name}
    cfg = variant_config(cfg, variant)
    ok, reason = shape_applicable(cfg, spec)
    if not ok:
        return {**base, "skipped": True, "reason": reason}
    rules = _rules_for(spec, mesh)
    if variant == "serve_tp" and spec.kind == "decode":
        rules = SERVING_RULES
    accum = ((accum_override or accum_steps_for(cfg, spec, mesh))
             if spec.kind == "train" else 1)
    key = (cfg, spec, accum, variant == "accum_rs")
    traces = {} if traces is None else traces
    if key not in traces:
        traces[key] = count_step(cfg, spec, accum,
                                 constrain_accum=variant == "accum_rs")
    counts = traces[key]
    n_dev = mesh.size

    # arguments and outputs, exactly from the specs at full depth
    model = Model(cfg, device="meta")
    params = dict(model.named_parameters())
    batch = meta_batch(cfg, spec)
    b_specs = batch_specs(batch, mesh, rules)
    p_specs = param_specs(params, mesh, rules)
    p_bytes = sharded_bytes(params, p_specs, mesh)
    in_bytes = sharded_bytes(batch, b_specs, mesh)
    if spec.kind == "train":
        state = init_train_state(model, adamw_init)
        s_specs = train_state_specs(state, mesh, rules)
        leaves = _flat({"params": state["params"], "opt": state["opt"]})
        specs = _flat({"params": s_specs["params"], "opt": s_specs["opt"]})
        state_bytes = sharded_bytes(leaves, specs, mesh)
        arg_bytes, out_bytes = state_bytes + in_bytes, state_bytes
    else:
        b = spec.global_batch
        logits = torch.empty((b, 1, cfg.vocab_size), device="meta")
        l_spec = resolve_spec(("batch", None, "vocab"), mesh, dict(rules),
                              dims=tuple(logits.shape))
        out_bytes = _nbytes(logits) // spec_ways(l_spec, mesh)
        arg_bytes = p_bytes + in_bytes
        if spec.kind == "decode":
            cache = model.init_cache(b, spec.seq_len)
            c_bytes = sharded_bytes(_flat(cache),
                                    _flat(cache_specs(cache, mesh, rules)),
                                    mesh)
            arg_bytes += c_bytes
            out_bytes += c_bytes

    temp = (peak_bytes(counts) - counts["entry"]) / n_dev
    if spec.kind == "train" and accum > 1:
        # the f32 accumulation buffer: whole on every device, or at the
        # parameter specs under accum_rs
        buf = {k: torch.empty(p.shape, device="meta")
               for k, p in params.items()}
        whole = sum(_nbytes(t) for t in buf.values())
        held = (sharded_bytes(buf, p_specs, mesh) if variant == "accum_rs"
                else whole)
        temp += held - whole / n_dev

    demands = cell_demands(cfg, spec, mesh, rules)
    breakdown, op_counts = {}, {}
    for d in demands:
        breakdown[d.tag] = breakdown.get(d.tag, 0.0) + \
            d.bytes_per_device * d.count_per_step
        op_counts[d.tag] = op_counts.get(d.tag, 0) + d.count_per_step

    bytes_dev = counts["bytes"] / n_dev
    rec = {
        **base,
        "step": spec.kind,
        "n_devices": n_dev,
        "skipped": False,
        "flops_per_device": float(counts["flops"]) / n_dev,
        "bytes_per_device": bytes_dev,
        "bytes_per_device_unfused": bytes_dev,
        "collective_bytes_per_device": float(sum(breakdown.values())),
        "collective_breakdown": breakdown,
        "collective_op_counts": op_counts,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": temp},
        "model_flops_total": model_flops(cfg, spec),
        "model_params": cfg.n_params(),
        "active_params": cfg.active_params(),
        "lower_s": counts["trace_s"],
        "variant": variant,
        "rules": _rules_name(rules),
        "accum_steps": accum,
        "counted_by": COUNTED_BY,
    }
    if variant == "ssm_fused":
        io = ssm_kernel_io_bytes(cfg, spec, mesh, accum)
        rec["ssm_kernel_io_bytes"] = io
        rec["bytes_per_device"] += io
        rec["bytes_per_device_unfused"] += io
    return rec


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline", accum_override: int = 0,
               traces: dict | None = None) -> dict:
    """The record of (arch, shape) on the production mesh."""
    return dry_run_cell(get_config(arch), SHAPES_BY_NAME[shape_name],
                        make_production_mesh(multi_pod=multi_pod),
                        variant=variant, accum_override=accum_override,
                        arch=arch, traces=traces)


def artifact_path(out_dir: str, arch, shape, mesh_name, tag="") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ASSIGNED_SHAPES])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--accum", type=int, default=0,
                    help="override gradient-accumulation steps (0 = auto)")
    ap.add_argument("--tag", default=None,
                    help="artifact tag override (defaults to variant)")
    ap.add_argument("--force", action="store_true",
                    help="recompute even if the artifact exists")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="artifact directory (default: dryrun_out/ at the "
                         "repository root)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else [s.name for s in ASSIGNED_SHAPES]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    tag = args.tag if args.tag is not None else (
        "" if args.variant == "baseline" else args.variant)
    os.makedirs(args.out, exist_ok=True)

    failures = []
    for arch in archs:
        for shape in shapes:
            traces: dict = {}
            for multi in meshes:
                mesh_name = make_production_mesh(multi_pod=multi).name
                path = artifact_path(args.out, arch, shape, mesh_name, tag)
                if os.path.exists(path) and not args.force:
                    _LOG.info(f"[dryrun] SKIP (exists) {arch} {shape} "
                              f"{mesh_name}")
                    continue
                t0 = time.perf_counter()
                try:
                    rec = lower_cell(arch, shape, multi,
                                     variant=args.variant,
                                     accum_override=args.accum,
                                     traces=traces)
                except Exception as e:  # noqa: BLE001 (record and continue)
                    failures.append((arch, shape, mesh_name, repr(e)))
                    _LOG.error(f"[dryrun] {arch} {shape} {mesh_name} FAIL: "
                               f"{e}")
                    traceback.print_exc()
                    continue
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                cell_s = time.perf_counter() - t0
                if rec.get("skipped"):
                    _LOG.info(f"[dryrun] {arch:22s} {shape:12s} "
                              f"{mesh_name:8s} skipped: {rec['reason']}")
                else:
                    _LOG.info(
                        f"[dryrun] {arch:22s} {shape:12s} {mesh_name:8s} "
                        f"{cell_s:.2f}s flops/dev="
                        f"{rec['flops_per_device']:.3e} coll/dev="
                        f"{rec['collective_bytes_per_device']:.3e}B temp="
                        f"{rec['memory']['temp_bytes'] / 2**30:.2f}GiB")
    if failures:
        _LOG.error(f"[dryrun] {len(failures)} failures:")
        for f in failures:
            _LOG.error("    " + " ".join(str(x) for x in f))
        raise SystemExit(1)
    _LOG.info("[dryrun] all requested cells counted")


if __name__ == "__main__":
    main()
