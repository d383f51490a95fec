"""The dry-run's count of one rank of the port's meshed program
(``repro_torch.launch.dryrun`` in a ``launch.mesh.counting_world``) on
the CPU.

One spawned world of 4 gloo ranks on a (2, 2) ("data", "model") "cpu" mesh
runs every case below for real at ``reduced`` widths: qwen2.5-3b,
deepseek-v2-lite-16b, hymba-1.5b and whisper-medium, a train step of two
microbatches under ``DEFAULT_RULES`` and a prefill and a decode step under
each of the three rule sets. Ranks 0 and 3 count their own run with
FlopCounterMode and ``StepCounter`` (bytes, collectives by kind and group
size); each count must equal exactly the meta count of the same rank in a
fake world of 4, which the main process takes while the world runs.

In the main process: a (1, 1) mesh counts no collective and one device's
FLOPs, its bytes differing only by the ops named in ``MESH_ONLY_OPS``; a
rank's counts are affine in the depth (an extrapolation to 5 layers equals
a whole 5-layer trace); the traced entry bytes equal the specs'
``argument_bytes``; no process group is left after a count, and a count
inside a process group raises. A subprocess compiles the reference's
train step on 4 forced host devices and holds its per-device FLOPs and
collectives beside the port's rank 0 (ROADMAP Queue C).
"""
from __future__ import annotations

import collections
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch.distributed as dist  # noqa: E402

import repro_torch.core  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import counting_world  # noqa: E402
from repro_torch.models import ShapeSpec, reduced  # noqa: E402
from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,  # noqa
                                  SERVING_RULES, MeshShape)
from test_torch_mesh_train import run_world  # noqa: E402

ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "hymba-1.5b",
         "whisper-medium")
RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES,
         "long": LONG_CONTEXT_RULES}
# (arch, step kind, rule set): a train step under the default rules, and
# prefill and decode under each rule set
CASES = tuple((a, "train", "default") for a in ARCHS) + tuple(
    (a, k, r) for a in ARCHS for k in ("prefill", "decode") for r in RULES)
RANKS = (0, 3)
MESH = MeshShape(("data", "model"), (2, 2))
SEQ = 64
# ops a (1, 1) mesh runs beyond one device's step: a Partial loss and
# metric summed over groups of one (clone, allreduce_; no collective is
# counted over a group of one) and AdamW's bias corrections as DTensor
# scalars (div); views move nothing
MESH_ONLY_OPS = {"aten.clone.default", "aten.div.Tensor",
                 "c10d.allreduce_.default"}

WORLD = r'''
import json
import torch
import torch.distributed as dist
import repro_torch.core
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import ShapeSpec, reduced
from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                  SERVING_RULES)

torch.set_num_threads(1)
rules = {"default": DEFAULT_RULES, "serving": SERVING_RULES,
         "long": LONG_CONTEXT_RULES}
mesh = make_device_mesh((2, 2), device_type="cpu")
out = {}
for arch, kind, rules_name, spec, accum in CASES:
    fn, inputs = D.step_program(reduced(get_config(arch)), ShapeSpec(*spec),
                                accum, mesh=mesh, rules=rules[rules_name],
                                device="cpu")
    counts = D.trace_counts(fn, inputs)
    every = [None] * world
    dist.all_gather_object(every, counts)
    out["|".join((arch, kind, rules_name))] = {r: every[r] for r in RANKS}
if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


def case_spec(kind: str, rules_name: str) -> tuple[ShapeSpec, int]:
    """The step's shape (batch 1 under the long-context rules) and its
    microbatch count."""
    rows = 1 if rules_name == "long" else 8 if kind == "train" else 4
    return ShapeSpec(kind, SEQ, rows, kind), 2 if kind == "train" else 1


def meta_counts(arch: str, kind: str, rules_name: str, rank: int,
                mesh: MeshShape = MESH, depth: int | None = None) -> dict:
    cfg = reduced(get_config(arch))
    if depth is not None:
        cfg = D.cut_depth(cfg, depth)
    spec, accum = case_spec(kind, rules_name)
    with counting_world(mesh, rank) as m:
        fn, inputs = D.step_program(cfg, spec, accum, mesh=m,
                                    rules=RULES[rules_name])
        return D.trace_counts(fn, inputs)


def _counted(c: dict) -> dict:
    """FLOPs, op bytes, argument bytes and the collectives' ops and
    result bytes of a count (peaks left out: gloo's own buffers)."""
    return {k: v for k, v in c.items() if not k.startswith("peak/")}


def rank_meta_counts(rank: int) -> dict:
    """Every case's meta count of ``rank`` (in a worker process)."""
    torch.set_num_threads(1)
    return {(a, k, r, rank): meta_counts(a, k, r, rank) for a, k, r in CASES}


@pytest.fixture(scope="module")
def counts():
    """{(arch, kind, rules, rank): (gloo count, meta count)}: the meta
    counts are taken, a process a rank, while the gloo world runs."""
    world_cases = []
    for a, k, r in CASES:
        spec, accum = case_spec(k, r)
        world_cases.append((a, k, r, (spec.name, spec.seq_len,
                                      spec.global_batch, spec.kind), accum))
    with ThreadPoolExecutor(1) as thread, ProcessPoolExecutor(
            len(RANKS), mp_context=multiprocessing.get_context("spawn")
    ) as procs:
        real = thread.submit(run_world, WORLD, CASES=world_cases,
                             RANKS=RANKS)
        meta = {}
        for part in procs.map(rank_meta_counts, RANKS):
            meta.update(part)
        real = real.result()
    return {key: (real["|".join(key[:3])][str(key[3])], m)
            for key, m in meta.items()}


@pytest.mark.parametrize("arch,kind,rules_name", CASES)
def test_a_real_rank_counts_what_its_meta_count_says(counts, arch, kind,
                                                     rules_name):
    for rank in RANKS:
        real, meta = counts[(arch, kind, rules_name, rank)]
        assert _counted(real) == _counted(meta), rank
        assert real["flops"] > 0 and real["bytes"] > 0
        # a rank of a (2, 2) mesh sends something in every step
        assert any(k.startswith("coll/") for k in meta), rank


def test_ranks_differ_only_where_their_shards_do(counts):
    """Ranks 0 and 3 hold different shards of the same shapes: their
    FLOPs and collectives are the same, and so are their bytes, but where
    a decode step writes the new token into a cache split over "model" on
    its slots (``SERVING_RULES``): only the rank holding that slot
    writes."""
    for a, k, r in CASES:
        zero, three = (_counted(counts[(a, k, r, rank)][1])
                       for rank in RANKS)
        if k == "decode" and r == "serving":
            assert zero.pop("bytes") < three.pop("bytes"), a
        assert zero == three, (a, k, r)


def _logged_count(cfg, spec, accum, mesh=None):
    """(``count_step``'s counts, {(op, bytes): times}) of one trace."""
    seen = collections.Counter()
    inner = D.StepCounter.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        before = self.bytes
        out = inner(self, func, types, args, kwargs)
        seen[(str(func), self.bytes - before)] += 1
        return out

    D.StepCounter.__torch_dispatch__ = spy
    try:
        return D.count_step(cfg, spec, accum, mesh=mesh), seen
    finally:
        D.StepCounter.__torch_dispatch__ = inner


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_one_by_one_mesh_counts_one_device(kind):
    cfg = reduced(get_config("qwen2.5-3b"))
    spec, accum = case_spec(kind, "default")
    one, one_ops = _logged_count(cfg, spec, accum)
    with counting_world(MeshShape(("data", "model"), (1, 1))) as m:
        meshed, mesh_ops = _logged_count(cfg, spec, accum, m)
    assert not any(k.startswith(("ops/", "coll/")) for k in meshed)
    assert meshed["flops"] == one["flops"] > 0
    assert meshed["entry"] == one["entry"]
    extra, missing = mesh_ops - one_ops, one_ops - mesh_ops
    moved = {op for (op, b) in extra + missing if b}
    assert moved <= MESH_ONLY_OPS, moved
    assert meshed["bytes"] - one["bytes"] == sum(
        b * n for (_, b), n in extra.items()) - sum(
        b * n for (_, b), n in missing.items())
    # at each peak, a few bytes of scalars at most
    for k, v in one.items():
        if k.startswith("peak/"):
            assert 0 <= meshed[k] - v <= 16, k


@pytest.mark.parametrize("arch,kind", [("qwen2.5-3b", "train"),
                                       ("deepseek-v2-lite-16b", "decode"),
                                       ("whisper-medium", "prefill"),
                                       ("hymba-1.5b", "decode")])
def test_a_rank_extrapolates_exactly_in_depth(arch, kind):
    cfg = D.cut_depth(reduced(get_config(arch)), 5)
    spec, accum = case_spec(kind, "default")
    with counting_world(MESH) as m:
        ext = D.count_step(cfg, spec, accum, mesh=m)
    full = meta_counts(arch, kind, "default", 0, depth=5)
    ext.pop("trace_s")
    assert _counted(ext) == _counted(full)
    assert D.peak_bytes(ext) == D.peak_bytes(full)


@pytest.mark.parametrize("arch,kind,rules_name", CASES)
def test_traced_entry_bytes_are_the_specs_argument_bytes(counts, arch, kind,
                                                         rules_name):
    cfg = reduced(get_config(arch))
    spec, _ = case_spec(kind, rules_name)
    args, _ = D.spec_bytes(cfg, spec, MESH, RULES[rules_name])
    for rank in RANKS:
        assert counts[(arch, kind, rules_name, rank)][1]["entry"] == args > 0


def test_a_count_leaves_no_process_group_and_refuses_inside_one():
    cfg = reduced(get_config("qwen2.5-3b"))
    rec = D.dry_run_cell(cfg, ShapeSpec("d", SEQ, 4, "decode"), MESH)
    assert rec["collective_op_counts"]["all-gather"] > 0
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            D.dry_run_cell(cfg, ShapeSpec("e", SEQ, 4, "decode"), MESH)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b",
                                  "falcon-mamba-7b"])
def test_one_device_flops_do_not_depend_on_the_microbatch_count(arch):
    """The ideal split a rank's FLOPs are set against (``chip_smoke.py``
    phase 23) is one device's step traced as one microbatch: its products
    are those of the step in two."""
    cfg = reduced(get_config(arch))
    spec = ShapeSpec("t", 32, 4, "train")
    assert D.count_step(cfg, spec)["flops"] == D.count_step(
        cfg, spec, 2)["flops"] > 0


@pytest.mark.parametrize("start,end,kind", [
    ("partial", "replicate", "all-reduce"),
    ("shard", "replicate", "all-gather"),
    ("partial", "shard", "reduce-scatter")])
def test_a_dtensor_redistribution_counts_as_its_collective(start, end, kind):
    """DTensor's own collectives (functional ops, as a redistribution
    issues them) count by the same kinds, at their result bytes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    layout = {"partial": Partial(), "replicate": Replicate(),
              "shard": Shard(0)}
    with counting_world(MeshShape(("data",), (4,))) as m:
        x = DTensor.from_local(torch.empty((8, 16), device="meta"), m,
                               [layout[start]], run_check=False)
        c = D.trace_counts(lambda: x.redistribute(m, [layout[end]]), [x])
    rows = 32 if end == "replicate" and start == "shard" else (
        8 if end == "replicate" else 2)
    assert {k: v for k, v in c.items() if k.startswith(("ops/", "coll/"))
            } == {f"ops/{kind}/4": 1, f"coll/{kind}/4": rows * 16 * 4}


REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join({root!r}, "src"))
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model, ShapeSpec, reduced, token_spec
    from repro.sharding import DEFAULT_RULES, logical_axis_rules
    from repro.sharding.rules import batch_specs
    from repro.train import adamw_init, make_train_step
    from repro.train.optimizer import OptConfig
    from repro.train.state import train_state_specs
    from repro.utils.hlo_cost import analyze
    from repro.utils.jaxcompat import make_auto_mesh

    mesh = make_auto_mesh((2, 2), ("data", "model"))
    nm = lambda t: jax.tree.map(
        lambda s: jax.sharding.NamedSharding(mesh, s), t)
    cfg = reduced(get_config("qwen2.5-3b"))
    model = Model(cfg)
    spec = ShapeSpec("train", {seq}, 8, "train")
    with mesh, logical_axis_rules(mesh, DEFAULT_RULES):
        batch = token_spec(cfg, spec)
        state = jax.eval_shape(
            lambda k: {{"params": model.init_params(k),
                       "opt": adamw_init(jax.eval_shape(model.init_params,
                                                        k)),
                       "step": jnp.zeros((), jnp.int32)}},
            jax.random.PRNGKey(0))
        st = train_state_specs(state, mesh, DEFAULT_RULES)
        step = make_train_step(model, OptConfig(), accum_steps=2)
        hlo = jax.jit(step, in_shardings=(nm(st), nm(batch_specs(
            batch, mesh, DEFAULT_RULES))), out_shardings=(nm(st), None)
            ).lower(state, batch).compile().as_text()
    cost = analyze(hlo)
    print("RESULT " + json.dumps({{"flops": cost.flops,
                                  "ops": cost.collective_ops,
                                  "bytes": cost.collective_breakdown}}))
""")


def test_rank_zero_beside_the_reference_partitioned_step():
    """The reference's per-device dot FLOPs of the qwen2.5-3b reduced
    train step on a (2, 2) mesh equal the port's rank 0's; the
    collectives differ in kind (ROADMAP Queue C): XLA sums the gradients
    with all-reduces and moves the batch and the attention's layouts with
    all-to-alls and permutes, where the port gathers each parameter whole
    (FSDP), reduce-scatters its gradient and all-reduces the
    tensor-parallel products' outputs."""
    res = subprocess.run([sys.executable, "-c",
                          REFERENCE.format(root=ROOT, seq=SEQ)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads([ln for ln in res.stdout.splitlines()
                      if ln.startswith("RESULT ")][-1][len("RESULT "):])
    cfg = reduced(get_config("qwen2.5-3b"))
    rec = D.dry_run_cell(cfg, ShapeSpec("train", SEQ, 8, "train"), MESH,
                         accum_override=2)
    assert rec["flops_per_device"] == ref["flops"] > 0
    used = {k for k, n in rec["collective_op_counts"].items() if n}
    assert used == {"all-reduce", "all-gather", "reduce-scatter"}
    assert {k for k, n in ref["ops"].items() if n} == {
        "all-reduce", "all-gather", "all-to-all", "collective-permute"}
    assert rec["collective_bytes_per_device"] / sum(
        ref["bytes"].values()) == pytest.approx(REF_COLLECTIVE_RATIO,
                                                rel=1e-9)


# the port's rank 0 collective bytes over the reference's, for the step
# above (ROADMAP Queue C)
REF_COLLECTIVE_RATIO = 1338912 / 2829924
