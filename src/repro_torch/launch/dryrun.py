"""Dry-run of every (architecture x input shape x production mesh): trace
one rank's step on the meta device and record what that rank of the mesh
computes, holds and sends; port of ``src/repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi  # 2x16x16

Artifacts: ``dryrun_out/<arch>__<shape>__<mesh>[__<tag>].json`` at the
repository root (``--out`` for another directory).

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's cost and memory analysis of one device's partitioned program.
The port has no compiler and no partitioner: its meshed program is its own
(``sharding/spmd.py``: the model once a rank on a ``DeviceMesh``, its
products split over "model" where the rules split their leaves, its own
all-gathers, all-reduces, reduce-scatters and all-to-alls). A cell here is
rank 0 of that program, counted from a shape-only run:

* ``launch.mesh.counting_world``: a process group of PyTorch's "fake"
  backend as large as the production mesh (256 or 512 ranks), this process
  its rank 0, and the mesh over it; its collectives send nothing and
  return at once. It needs no device, and raises where the process has a
  process group already (a rank of a real world cannot count).
* ``step_program``: the meshed step as the launchers build it, on a meta
  model (``Model(cfg, device="meta")``, meta inputs from ``token_spec``):
  parameters, AdamW's state, the batch (each of ``accum_steps_for``'s
  microbatches on its own) and the cache placed by the sharding rules
  (``_rules_for``), every shard kept on the meta device; then the train
  step, ``prefill`` or ``decode_step`` under those rules.
* The step runs once under ``FlopCounterMode`` and ``StepCounter``, a
  dispatch mode that sums each op's input and output bytes, follows the
  live tensor bytes and counts every collective the rank issues by the
  reference's kinds (``COLLECTIVE_KINDS``) with its result bytes on this
  rank, as ``repro.utils.hlo_cost`` reads an instruction's shape. A
  DTensor (the optimizer's elementwise formulas) counts as its local
  shard. Eager PyTorch does not fuse, so the bytes are the traffic the
  port's program makes: both ``bytes_per_device`` and
  ``bytes_per_device_unfused``.
* The layer stack is traced at 2 and 3 layers (the encoder-decoder's two
  stacks together; DeepSeek's leading dense layer kept) and extrapolated
  to the full depth: every layer runs the same ops and collectives at the
  same shapes, so a rank's counts are affine in the depth, as the
  reference's HLO analysis multiplies a scanned layer body by its trip
  count. A stack of at most 3 layers is traced whole.

What differs in kind from XLA's count: these are eager, unfused ops and
the collectives of the port's program, not of GSPMD's. The port repeats on
every model rank what the rules keep whole over "model" (the norms, the
router, an attention whose KV heads the axis does not divide), gathers
each parameter whole before its block (FSDP) and reduce-scatters its
gradient, where XLA may partition a product otherwise, reshard with
all-to-alls and permutes, or sum gradients with all-reduces. A decode
step whose rows are whole on the data axes (long_500k's batch of 1 under
``LONG_CONTEXT_RULES``) gathers no parameter: each product runs on the
rank's data shard of ``d_model`` and sums or gathers the one token's
activations over "data", where XLA also gathers a few weights there (the
MLP's ``wo`` among them: ``tests/test_torch_mesh_longctx.py``). FLOPs count
matrix products only. Argument and output bytes come exactly from the
sharding specs (a test holds them equal to the traced rank's entry bytes).

The record keeps the reference's keys except those with no torch meaning
(``xla_raw``, ``n_while_loops``, ``memory.code_bytes``, ``compile_s``);
``lower_s`` is the trace's seconds, and ``counted_by`` says how each
number was counted. Each mesh's cells are counted in a counting world of
its own size.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import ARCH_IDS, get_config
from ..models import Model, SHAPES_BY_NAME, shape_applicable, token_spec
from ..models.config import ModelConfig
from ..models.inputs import ASSIGNED_SHAPES, ShapeSpec, make_inputs
from ..obs.log import get_logger
from ..sharding import DEFAULT_RULES, LONG_CONTEXT_RULES, SERVING_RULES
from ..sharding.annotate import PartitionSpec, resolve_spec, spec_ways
from ..sharding.rules import (batch_specs, cache_specs, distribute_batch,
                              distribute_params, param_specs)
from ..train import adamw_init, make_train_step, microbatches
from ..train.optimizer import OptConfig
from ..train.state import (init_train_state, place_train_state,
                           train_state_specs)
from .mesh import counting_world, make_production_mesh

_LOG = get_logger("launch.dryrun")

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_out")

# traced depths of the layer stack; deeper stacks are extrapolated
_DEPTHS = (2, 3)

COUNTED_BY = {
    "rank": "rank 0 of the production mesh running the port's meshed step "
            "(sharding/spmd.py) under the cell's rules, in a counting world "
            "of the fake backend (launch.mesh.counting_world); every count "
            "is that rank's own",
    "flops": "torch.utils.flop_counter.FlopCounterMode over the rank's meta "
             "trace (matrix products only)",
    "bytes": "every op's input and output bytes over the rank's meta trace, "
             "a DTensor at its local shard (views and uninitialised "
             "allocations excluded; eager runs unfused)",
    "depth": "the layer stack traced at 2 and 3 layers and extrapolated "
             "linearly to the full depth",
    "argument_bytes": "sum over leaves of nbytes / the mesh ways of the "
                      "leaf's spec (sharding.rules)",
    "output_bytes": "the same over the step's outputs: the new state, or "
                    "the logits (and the cache)",
    "temp_bytes": "the rank's peak live tensor bytes less its arguments "
                  "(the accumulation buffer in its parameters' layout)",
    "collectives": "every collective the rank issues (torch.distributed's "
                   "c10d and functional ops) by the reference's kinds, its "
                   "result bytes on this rank; none over a group of one",
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

# the reference's collective kinds (``repro.utils.hlo_cost``), in its order
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
# the collectives a rank of the port issues, by that kind: the c10d ops of
# ``sharding/spmd.py`` work in place (their first argument holds the
# result); the functional ops of DTensor's redistribution return it
_C10D_KIND = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
              "_reduce_scatter_base_": "reduce-scatter",
              "alltoall_base_": "all-to-all"}
_FUNCTIONAL_KIND = {"all_reduce": "all-reduce",
                    "all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}
# the functional ops' bookkeeping, which moves nothing
_NOT_COLLECTIVE = {"wait_tensor", "_wrap_tensor_autograd"}


def _phase() -> str:
    """Which part of a step is running: autograd's backward, a forward
    that records a graph, or the rest (the optimizer, the accumulation,
    serving under no_grad)."""
    if torch._C._current_graph_task_id() != -1:
        return "backward"
    return "forward" if torch.is_grad_enabled() else "other"


def _local(t: torch.Tensor) -> torch.Tensor:
    """What a rank holds of ``t``: a DTensor's local tensor, else ``t``."""
    return t._local_tensor if isinstance(t, DTensor) else t


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # a ReduceOp, not a group
                continue
    raise ValueError("a c10d op without a process group")


def _collective(func, args, kwargs, out):
    """(kind, group size, result bytes on this rank) of a collective op,
    None for any other op; raises on a collective it does not know."""
    ns, name = func.namespace, func.overloadpacket.__name__
    if ns not in ("c10d", "_c10d_functional") or name in _NOT_COLLECTIVE:
        return None
    if ns == "c10d" and name in _C10D_KIND:
        return (_C10D_KIND[name], _group_size(args),
                sum(_nbytes(t) for t in _tensors(args[0])))
    if ns == "_c10d_functional" and name in _FUNCTIONAL_KIND:
        bound = func._schema.arguments
        group = dict(zip((a.name for a in bound), args), **(kwargs or {}))
        size = dist.distributed_c10d._resolve_process_group(
            group["group_name"]).size()
        return (_FUNCTIONAL_KIND[name], size,
                sum(_nbytes(t) for t in _tensors(out)))
    raise ValueError(f"{func}: a collective the dry-run does not count")


class StepCounter(TorchDispatchMode):
    """One rank's counts of the ops it runs: the bytes every op reads and
    writes (each tensor argument and output once; views and uninitialised
    allocations move nothing), the live tensor bytes (each storage counted
    once from its first appearance until it is freed), and every
    collective by kind and group size with its result bytes on this rank
    (``collectives``: {(kind, group size): [ops, bytes]}); a collective
    over a group of one moves nothing and is not counted, nor are the ops
    a backend runs to finish a collective. A DTensor
    argument or output counts as its local tensor: pushed outside DTensor,
    the mode sees DTensor's ops (the optimizer's elementwise formulas) at
    their global shapes, while a rank runs them on its shard. ``peaks``
    keeps the most live bytes of each phase (``_phase``): each is affine
    in the depth of the layer stack, their maximum is not, so a depth
    extrapolation takes them one by one. A matrix product on a DTensor
    raises: FlopCounterMode would count it at its global shape."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peaks: dict[str, int] = {}
        self.collectives: dict[tuple, list] = {}
        self._storages = WeakIdKeyDictionary()

    def _free(self, nbytes: int, _ref) -> None:
        self.live -= nbytes

    def track(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        if st in self._storages:
            return
        nbytes = st.nbytes()
        self._storages[st] = weakref.ref(
            st, lambda ref, n=nbytes: self._free(n, ref))
        self.live += nbytes

    def __enter__(self):
        # the ops a backend runs to finish a collective (gloo's reduce-
        # scatter copies this rank's chunk out in ``Work.wait``) are the
        # collective's, counted in its result bytes, not the program's
        self._wait, self._waiting = dist.Work.wait, 0
        original, counter = self._wait, self

        def wait(work, *args, **kwargs):
            counter._waiting += 1
            try:
                return original(work, *args, **kwargs)
            finally:
                counter._waiting -= 1

        dist.Work.wait = wait
        return super().__enter__()

    def __exit__(self, *exc):
        dist.Work.wait = self._wait
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._waiting:
            return func(*args, **(kwargs or {}))
        ins = _tensors((args, kwargs))
        if func.overloadpacket in flop_registry and any(
                isinstance(t, DTensor) for t in ins):
            raise ValueError(f"{func} on a DTensor: its FLOPs would be "
                             f"counted at the global shape")
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(_local(t)) for t in ins + outs)
        coll = _collective(func, args, kwargs, out)
        if coll is not None and coll[1] > 1:
            entry = self.collectives.setdefault(coll[:2], [0, 0])
            entry[0] += 1
            entry[1] += coll[2]
        for t in outs:
            self.track(t)
        phase = _phase()
        self.peaks[phase] = max(self.peaks.get(phase, 0), self.live)
        return out


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts (an op's arguments
    or outputs, a step's inputs), in order; a pytree walk costs more than
    the ops it would count."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def trace_counts(fn, inputs) -> dict:
    """Run ``fn()`` once under FlopCounterMode and a ``StepCounter``, with
    the tensors of ``inputs`` live from the start; returns flops, bytes,
    the argument bytes ("entry"), each phase's peak live bytes
    ("peak/<phase>") and each collective's ops and result bytes
    ("ops/<kind>/<group size>", "coll/<kind>/<group size>")."""
    counter = StepCounter()
    for t in _tensors(inputs):
        counter.track(t)
    entry = counter.live
    flops = FlopCounterMode(display=False)
    with flops, counter:
        fn()
    out = {"flops": flops.get_total_flops(), "bytes": counter.bytes,
           "entry": entry,
           **{f"peak/{k}": v for k, v in counter.peaks.items()}}
    for (kind, n), (ops, nbytes) in sorted(counter.collectives.items()):
        out[f"ops/{kind}/{n}"] = ops
        out[f"coll/{kind}/{n}"] = nbytes
    return out


def collectives_by_kind(counts: dict) -> tuple[dict, dict]:
    """({kind: result bytes}, {kind: ops}) of ``trace_counts``' result
    over every group size, each of the reference's kinds present."""
    nbytes = {k: 0 for k in COLLECTIVE_KINDS}
    ops = {k: 0 for k in COLLECTIVE_KINDS}
    for key, v in counts.items():
        what, _, rest = key.partition("/")
        if what in ("ops", "coll"):
            kind = rest.rpartition("/")[0]
            (ops if what == "ops" else nbytes)[kind] += v
    return nbytes, ops


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
                 constrain_accum: bool = False, mesh=None,
                 rules=DEFAULT_RULES, device="meta"):
    """(fn, inputs): the step of ``spec.kind`` on a model of ``cfg``, ready
    to run once, and the tensors it takes (the train state and the batch;
    the parameters, the cache and the batch in serving). ``device`` "meta"
    builds a shape-only model and inputs; another device draws the weights
    from seed 0 and the inputs from ``make_inputs``' seed 0 there.

    On a ``DeviceMesh`` ``mesh`` it is this rank's part of the meshed step,
    built as the launchers build it: the parameters placed by
    ``distribute_params(rules)``, AdamW's state by ``place_train_state``,
    the batch by ``distribute_batch`` (each of ``accum`` microbatches on
    its own), the cache by ``init_cache(rules=)``, and ``prefill`` /
    ``decode_step`` under ``rules``."""
    model = Model(cfg, seed=0, device=device)
    batch = (meta_batch(cfg, spec) if device == "meta"
             else make_inputs(cfg, spec, device=device))
    if mesh is not None:
        distribute_params(model, mesh, rules)

    def placed(b):
        return b if mesh is None else distribute_batch(b, mesh, rules)

    if spec.kind == "train":
        state = init_train_state(model, adamw_init)
        if mesh is not None:
            state = place_train_state(state, mesh, rules)
        step = make_train_step(model, OptConfig(), accum_steps=accum,
                               constrain_accum=constrain_accum)
        batch = ([placed(b) for b in microbatches(batch, accum)]
                 if mesh is not None and accum > 1 else placed(batch))
        return (lambda: step(state, batch)), (state, batch)
    params = dict(model.named_parameters())
    batch = placed(batch)
    if spec.kind == "prefill":
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        return ((lambda: model.prefill(batch["tokens"], extra=extra,
                                       rules=rules)),
                (params, batch))
    cache = model.init_cache(spec.global_batch, spec.seq_len, rules=rules)
    return ((lambda: model.decode_step(cache, batch["tokens"],
                                       spec.seq_len - 1, rules=rules)),
            (params, cache, batch))


def count_step(cfg: ModelConfig, spec: ShapeSpec, accum: int = 1,
               constrain_accum: bool = False, mesh=None,
               rules=DEFAULT_RULES) -> dict:
    """The step's counts (``trace_counts``) at ``cfg``'s full depth, traced
    on meta at 2 and 3 layers and extrapolated (whole where the stack has
    at most 3): one device's, or on a ``DeviceMesh`` of a counting world
    (``launch.mesh.counting_world``) its rank's."""
    depth = _stack_depth(cfg)

    def at(d):
        fn, inputs = step_program(cut_depth(cfg, d), spec, accum,
                                  constrain_accum, mesh, rules)
        return trace_counts(fn, inputs)

    t0 = time.perf_counter()
    if depth <= _DEPTHS[-1]:
        out = at(depth)
    else:
        lo, hi = (at(d) for d in _DEPTHS)
        out = {k: lo.get(k, 0) + (depth - _DEPTHS[0]) *
               (hi.get(k, 0) - lo.get(k, 0))
               for k in sorted(set(lo) | set(hi))}
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


def spec_bytes(cfg: ModelConfig, spec: ShapeSpec, mesh, rules) -> tuple:
    """(argument bytes, output bytes) of a rank of ``mesh`` at ``cfg``'s
    full depth, exactly from the sharding specs: the train state and the
    batch in, the new state out; or the parameters, the batch (and the
    cache) in, the logits (and the cache) out."""
    model = Model(cfg, device="meta")
    params = dict(model.named_parameters())
    batch = meta_batch(cfg, spec)
    in_bytes = sharded_bytes(batch, batch_specs(batch, mesh, rules), mesh)
    if spec.kind == "train":
        state = init_train_state(model, adamw_init)
        s_specs = train_state_specs(state, mesh, rules)
        leaves = _flat({"params": state["params"], "opt": state["opt"]})
        specs = _flat({"params": s_specs["params"], "opt": s_specs["opt"]})
        state_bytes = sharded_bytes(leaves, specs, mesh)
        return state_bytes + in_bytes, state_bytes
    b = spec.global_batch
    logits = torch.empty((b, 1, cfg.vocab_size), device="meta")
    l_spec = resolve_spec(("batch", None, "vocab"), mesh, dict(rules),
                          dims=tuple(logits.shape))
    out_bytes = _nbytes(logits) // spec_ways(l_spec, mesh)
    arg_bytes = sharded_bytes(params, param_specs(params, mesh, rules),
                              mesh) + in_bytes
    if spec.kind == "decode":
        cache = model.init_cache(b, spec.seq_len)
        c_bytes = sharded_bytes(_flat(cache),
                                _flat(cache_specs(cache, mesh, rules)), mesh)
        arg_bytes += c_bytes
        out_bytes += c_bytes
    return arg_bytes, out_bytes


def _rules_name(rules) -> str:
    return ("serving" if rules is SERVING_RULES else
            "long_context" if rules is LONG_CONTEXT_RULES else "default")


def dry_run_cell(cfg: ModelConfig, spec: ShapeSpec, mesh, *,
                 variant: str = "baseline", accum_override: int = 0,
                 arch: str | None = None, rank: int = 0) -> dict:
    """The record of one cell: rank ``rank`` of the ``MeshShape`` ``mesh``
    running the port's meshed step, counted in a counting world of the
    mesh's size (``launch.mesh.counting_world``; raises where the process
    has a process group)."""
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
    with counting_world(mesh, rank) as device_mesh:
        counts = count_step(cfg, spec, accum, variant == "accum_rs",
                            device_mesh, rules)
    arg_bytes, out_bytes = spec_bytes(cfg, spec, mesh, rules)
    breakdown, op_counts = collectives_by_kind(counts)
    rec = {
        **base,
        "step": spec.kind,
        "n_devices": mesh.size,
        "skipped": False,
        "flops_per_device": float(counts["flops"]),
        "bytes_per_device": float(counts["bytes"]),
        "bytes_per_device_unfused": float(counts["bytes"]),
        "collective_bytes_per_device": float(sum(breakdown.values())),
        "collective_breakdown": {k: float(v) for k, v in breakdown.items()},
        "collective_op_counts": op_counts,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": peak_bytes(counts) - counts["entry"]},
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
               variant: str = "baseline", accum_override: int = 0) -> dict:
    """The record of (arch, shape): rank 0 of the production mesh."""
    return dry_run_cell(get_config(arch), SHAPES_BY_NAME[shape_name],
                        make_production_mesh(multi_pod=multi_pod),
                        variant=variant, accum_override=accum_override,
                        arch=arch)


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
                                     accum_override=args.accum)
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
