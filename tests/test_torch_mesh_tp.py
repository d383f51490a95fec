"""Tensor parallelism over the "model" axis of a ``torch.distributed``
device mesh in training (``src/repro_torch``): MLA's heads, the routed
experts, the Mamba mixer's channels, whisper's encoder and
cross-attention, and the vocabulary-parallel cross-entropy, each computed
from a rank's "model" shard of its leaves, against one device and against
the reference's own meshed train step.

Every meshed check runs in one spawned world of 4 gloo ranks on a (2, 2)
("data", "model") "cpu" mesh at ``reduced(cfg, dtype="float32")``; rank 0
prints the world's findings as one JSON line. A gradient leaf is held
within 1e-5 of one device relative to the largest magnitude of that leaf
or, for a leaf whose gradient is rounding noise on both sides (a key
bias, which the softmax does not see), of the largest gradient of the
model. The reference runs in a subprocess with four forced host devices,
its AdamW step jitted with the train state's specs
(``tests/test_torch_mesh_layers.py``'s pattern); its parameters reach the
port through ``models/convert.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_mesh_train import run_world  # noqa: E402

GRAD_TOL = 1e-5
STEP_TOL = 1e-5
REF_TOL = 1e-4
LR = 5e-5
FAMILIES = ("qwen2.5-3b", "hymba-1.5b", "falcon-mamba-7b", "olmoe-1b-7b",
            "deepseek-v2-lite-16b", "llava-next-34b", "whisper-medium",
            "glm4-9b", "nemotron-4-15b", "codeqwen1.5-7b")
# the reference's three meshed steps: the families whose products this
# file splits (MLA and experts, experts, channels, encoder and cross)
REF_ARCHS = ("deepseek-v2-lite-16b", "olmoe-1b-7b", "falcon-mamba-7b",
             "whisper-medium")
REF_STEPS = 3
REF_LR = 1e-3
BATCH, SEQ = 4, 32
# the edges: (case id, arch, reduced() overrides)
EDGES = (("overflow", "olmoe-1b-7b", {"capacity_factor": 0.5}),
         ("odd_vocab", "qwen2.5-3b", {"vocab_size": 257}),
         ("odd_vocab_whisper", "whisper-medium", {"vocab_size": 257}))

REFERENCE = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(ROOT, "src"))
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import Model, reduced
from repro.models.inputs import ShapeSpec, make_inputs
from repro.sharding import DEFAULT_RULES, logical_axis_rules
from repro.train import adamw_init, make_train_step
from repro.train.optimizer import OptConfig
from repro.train.state import train_state_specs
from repro.utils.jaxcompat import make_auto_mesh
from repro_torch.models.convert import flatten_reference

mesh = make_auto_mesh((2, 2), ("data", "model"))
ocfg = OptConfig(learning_rate=REF_LR, warmup_steps=1, decay_steps=10)
out = {}
for i, arch in enumerate(REF_ARCHS):
    cfg = reduced(get_config(arch), dtype="float32")
    model = Model(cfg)
    params = model.init_params(jax.random.PRNGKey(i))
    # the stub embeddings are bf16 values: exact in float32
    batch = {k: np.asarray(v, np.int32 if v.dtype == jnp.int32
                           else np.float32)
             for k, v in make_inputs(
                 cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=i).items()}
    np.savez(os.path.join(TMP, f"{arch}-params.npz"),
             **flatten_reference(jax.tree.map(np.asarray, params)))
    np.savez(os.path.join(TMP, f"{arch}-batch.npz"), **batch)
    with mesh, logical_axis_rules(mesh, DEFAULT_RULES):
        state = {"params": params, "opt": adamw_init(params),
                 "step": jnp.zeros((), jnp.int32)}
        sh = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                          train_state_specs(state, mesh, DEFAULT_RULES))
        state = jax.tree.map(jax.device_put, state, sh)
        step = jax.jit(make_train_step(model, ocfg, "adamw"),
                       in_shardings=(sh, None), out_shardings=(sh, None))
        losses = []
        for _ in range(REF_STEPS):
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            losses.append(float(m["loss"]))
    out[arch] = losses
with open(os.path.join(TMP, "ref.json"), "w") as f:
    json.dump(out, f)
'''

WORLD = r'''
import json, os, time
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
import repro_torch.models.layers as L
import repro_torch.models.mla as MLA
import repro_torch.models.model as MM
import repro_torch.models.moe as MOE
import repro_torch.models.ssm as SSM
import repro_torch.sharding.spmd as SP
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.train import build_state
from repro_torch.models import Model, reduced
from repro_torch.models.convert import load_reference_params
from repro_torch.models.inputs import ShapeSpec, make_inputs
from repro_torch.sharding.rules import distribute_batch, distribute_params
from repro_torch.sharding.spmd import full_value
from repro_torch.train import OptConfig, make_train_step, place_train_state

torch.set_num_threads(1)
mesh = make_device_mesh((2, 2), device_type="cpu")
out = {}

# every leaf split over "model" that a forward gathers over "model" (by the
# data pointer of its local shard), and what each split product receives
seen = {"on": False, "gathered": [], "calls": {}}
real_whole = SP._WholeParam.forward


def whole_spy(ctx, local, mesh_, layout, rows, keep=None):
    m = mesh_.mesh_dim_names.index("model")
    if seen["on"] and isinstance(layout[m], Shard) and keep != m \
            and mesh_.size(m) > 1:
        seen["gathered"].append(local.data_ptr())
    return real_whole(ctx, local, mesh_, layout, rows, keep)


SP._WholeParam.forward = staticmethod(whole_spy)


def spy(module, name, record):
    real = getattr(module, name)

    def wrapped(*a, **k):
        if seen["on"]:
            seen["calls"].setdefault(name, []).append(record(*a, **k))
        return real(*a, **k)
    setattr(module, name, wrapped)


spy(MLA, "mla_attention", lambda p, cfg, x, pos, causal=True, split=False:
    [split, list(p["wq"].shape) if "wq" in p else list(p["wq_b"].shape)])
spy(MOE, "moe_ffn", lambda p, cfg, x, shared_split=False,
    experts_split=False: [experts_split, shared_split, list(p["wi"].shape)])
spy(SSM, "mamba_forward", lambda p, cfg, x, split=False:
    [split, list(p["in_proj"].shape), list(p["x_proj"].shape)])
spy(MM, "_cross_attention", lambda p, cfg, h, pos, enc, split=False,
    enc_blocked=False: [split, list(p["wq"].shape)])
spy(L, "attention", lambda p, cfg, x, pos, causal=True, split=False:
    [split, causal, list(p["wq"].shape)])
spy(MM, "_vocab_parallel_ce", lambda p, cfg, x, labels:
    [list(p["w"].shape)])
spy(SSM, "halves_over_model", lambda x, dim: [list(x.shape), dim])


def cfg_of(arch, **kw):
    return reduced(get_config(arch), dtype="float32", **kw)


def rel(a, b, scale):
    return float((a - b).abs().max()) / max(scale, 1e-30)


def grads(model, batch, meshed):
    """(loss, {name: whole gradient}) of one loss of ``batch``"""
    if meshed:
        batch = distribute_batch(batch, mesh)
    names, leaves = zip(*model.named_parameters())
    loss, _ = model.loss(batch)
    own = loss.to_local() if isinstance(loss, DTensor) else loss
    g = torch.autograd.grad(own, leaves)
    return float(full_value(loss)), {n: full_value(t) for n, t in
                                     zip(names, g)}


def held(arch, **kw):
    """two AdamW steps on (2, 2) against one device: each step's loss,
    gradient norm and gradient leaves (taken before the step, on the same
    parameters), and what the meshed forwards gathered and called"""
    cfg = cfg_of(arch, **kw)
    batch = make_inputs(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=3,
                        device="cpu")
    ocfg = OptConfig(learning_rate=LR, warmup_steps=1, decay_steps=10)
    runs = []
    for meshed in (False, True):
        model = Model(cfg, seed=0, device="cpu")
        if meshed:
            distribute_params(model, mesh)
            names = {p.to_local().data_ptr(): k
                     for k, p in model.named_parameters()}
        state = build_state(model, "adamw")
        if meshed:
            state = place_train_state(state, mesh)
        step = make_train_step(model, ocfg, "adamw")
        b = distribute_batch(batch, mesh) if meshed else batch
        metrics, leaves = [], []
        for _ in range(2):
            seen.update(on=meshed, gathered=[], calls={})
            leaves.append(grads(model, batch, meshed)[1])
            if meshed and not metrics:
                calls, gathered = dict(seen["calls"]), list(seen["gathered"])
            seen["on"] = False
            state, mt = step(state, b)
            metrics.append([float(mt["loss"]), float(mt["grad_norm"])])
        runs.append((metrics, leaves))
    (m1, g1), (m2, g2) = runs
    worst, where = 0.0, None
    for s1, s2 in zip(g1, g2):
        top = max(float(g.abs().max()) for g in s1.values())
        for k in s1:
            e = rel(s2[k], s1[k], max(float(s1[k].abs().max()), 1e-3 * top))
            if e > worst:
                worst, where = e, k
    return {"steps": [m1, m2], "grad_worst": worst, "grad_worst_leaf": where,
            "gathered_over_model": sorted({names.get(p, "?")
                                           for p in gathered}),
            "calls": calls}


for arch in FAMILIES:
    out[arch] = held(arch)
for case_id, arch, over in EDGES:
    out[case_id] = held(arch, **over)

# a vocabulary-parallel chunk recomputed in backward ("full", "dots")
# against the plain one ("none"), all on the mesh
cfg = cfg_of("qwen2.5-3b")
batch = make_inputs(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=4,
                    device="cpu")
remat = {}
for policy in ("none", "full", "dots"):
    model = distribute_params(Model(cfg.replace(remat=policy), seed=0,
                                    device="cpu"), mesh)
    seen.update(on=True, calls={})
    loss, g = grads(model, batch, True)
    seen["on"] = False
    remat[policy] = (loss, g, len(seen["calls"].get("_vocab_parallel_ce",
                                                    [])))
out["remat"] = {p: {"loss_err": abs(remat[p][0] - remat["none"][0]),
                    "grad_err": max(float((remat[p][1][k] - g0).abs().max())
                                    for k, g0 in remat["none"][1].items()),
                    "vp_calls": remat[p][2]} for p in remat}

# in_proj's exchange on model axes of 2 and 4: this rank's block of the
# [x | z] columns in, its channels of x and of z out; the gradient back
exchange = {}
for sizes in ((2, 2), (1, 4)):
    m = mesh if sizes == (2, 2) else make_device_mesh(sizes,
                                                      device_type="cpu")
    tp, r = sizes[1], m.get_local_rank("model")
    whole = torch.arange(3 * 2 * 8 * tp, dtype=torch.float32).reshape(
        3, 2 * 8 * tp)
    block = whole[:, r * 16:(r + 1) * 16].clone().requires_grad_()
    with SP.spmd(m, 4):
        got = SP.halves_over_model(block, 1)
        (g,) = torch.autograd.grad((got * got).sum(), [block])
    x, z = whole.chunk(2, dim=1)
    want = torch.cat([x[:, r * 8:(r + 1) * 8], z[:, r * 8:(r + 1) * 8]], 1)
    exchange[str(tp)] = bool(torch.equal(got, want)) and bool(
        torch.equal(g, 2 * block.detach()))
flags = [None] * dist.get_world_size()
dist.all_gather_object(flags, exchange)
out["exchange"] = {k: all(f[k] for f in flags) for k in exchange}

# three meshed steps from the reference's parameters and batches (its
# subprocess runs beside this world; its files are complete once "done"
# exists)
deadline = time.monotonic() + 600
while not os.path.exists(os.path.join(TMP, "done")):
    if time.monotonic() > deadline:
        raise TimeoutError("the reference's subprocess never finished")
    time.sleep(0.2)
ocfg = OptConfig(learning_rate=REF_LR, warmup_steps=1, decay_steps=10)
for arch in REF_ARCHS:
    cfg = cfg_of(arch)
    model = Model(cfg, seed=0, device="cpu")
    load_reference_params(model, dict(np.load(
        os.path.join(TMP, f"{arch}-params.npz"))))
    distribute_params(model, mesh)
    state = place_train_state(build_state(model, "adamw"), mesh)
    step = make_train_step(model, ocfg, "adamw")
    host = {k: torch.from_numpy(v) for k, v in np.load(
        os.path.join(TMP, f"{arch}-batch.npz")).items()}
    host = {k: v.long() if k in ("tokens", "labels") else v
            for k, v in host.items()}
    b = distribute_batch(host, mesh)
    losses = []
    for _ in range(REF_STEPS):
        state, mt = step(state, b)
        losses.append(float(mt["loss"]))
    out["ref_" + arch] = losses

if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


@pytest.fixture(scope="module")
def reference_and_world(tmp_path_factory):
    """(the reference's losses, the world's findings): the reference's
    subprocess runs beside the world, which reads its files last."""
    tmp = str(tmp_path_factory.mktemp("mesh_tp"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    head = "".join(f"{k} = {v!r}\n" for k, v in dict(
        ROOT=ROOT, TMP=tmp, REF_ARCHS=REF_ARCHS, REF_STEPS=REF_STEPS,
        REF_LR=REF_LR, BATCH=BATCH, SEQ=SEQ).items())
    body = "try:\n    exec(compile(REFERENCE_SRC, '<reference>', 'exec'))\n" \
           "finally:\n    open(os.path.join(TMP, 'done'), 'w').close()\n"
    log = os.path.join(tmp, "reference.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", head + "import os\n" +
             f"REFERENCE_SRC = {REFERENCE!r}\n" + body], env=env,
            stdout=out, stderr=subprocess.STDOUT)
    try:
        found = run_world(WORLD, TMP=tmp, FAMILIES=FAMILIES, EDGES=EDGES,
                          LR=LR, REF_ARCHS=REF_ARCHS, REF_STEPS=REF_STEPS,
                          REF_LR=REF_LR, BATCH=BATCH, SEQ=SEQ)
        proc.wait(timeout=600)
        with open(log) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(tmp, "ref.json")) as f:
        return json.load(f), found


@pytest.fixture(scope="module")
def world(reference_and_world):
    return reference_and_world[1]


def _held(rec):
    assert rec["grad_worst"] <= GRAD_TOL, rec["grad_worst_leaf"]
    for (a0, g0), (a1, g1) in zip(*rec["steps"]):
        assert a1 == pytest.approx(a0, rel=STEP_TOL)
        assert g1 == pytest.approx(g0, rel=STEP_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_meshed_gradients_and_steps_match_one_device(world, arch):
    """Two AdamW steps on (2, 2) against one device: each step's loss,
    gradient norm and every gradient leaf."""
    _held(world[arch])


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_gathers_no_leaf_split_over_model(world, arch):
    """A meshed forward computes with each rank's "model" shard of every
    leaf the rules split there (the reduced configs' heads, experts,
    channels and vocabulary all divide the axis of 2)."""
    assert world[arch]["gathered_over_model"] == []


def test_mla_heads_run_tensor_parallel(world):
    calls = world["deepseek-v2-lite-16b"]["calls"]["mla_attention"]
    cfg_heads = 4
    # each layer's forward and its recomputation in backward
    assert calls and all(c[0] and c[1][1] == cfg_heads // 2 for c in calls)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_routed_experts_run_expert_parallel(world, arch):
    calls = world[arch]["calls"]["moe_ffn"]
    shared = arch.startswith("deepseek")
    # 8 experts, 4 a rank; deepseek's shared expert on its hidden units
    assert calls and all(c[0] and c[1] is shared and c[2][0] == 4
                         for c in calls)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_mamba_projections_run_on_each_ranks_channels(world, arch):
    rec = world[arch]["calls"]
    d, di = 64, 128        # reduced: d_model 64, ssm_expand 2
    assert rec["mamba_forward"] and all(
        c[0] and c[1] == [d, di] and c[2][0] == di // 2
        for c in rec["mamba_forward"])
    # in_proj's columns exchanged into this rank's x and z channels
    assert rec["halves_over_model"] and all(
        c == [[d, di], 1] for c in rec["halves_over_model"])


def test_whisper_encoder_and_cross_attention_run_tensor_parallel(world):
    calls = world["whisper-medium"]["calls"]
    # the encoder's self-attention (not causal) and the decoder's, each on
    # its two heads of four
    assert any(not c[1] for c in calls["attention"])
    assert all(c[0] and c[2][1] == 2 for c in calls["attention"])
    assert calls["_cross_attention"] and all(
        c[0] and c[1][1] == 2 for c in calls["_cross_attention"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_cross_entropy_is_vocabulary_parallel(world, arch):
    calls = world[arch]["calls"]["_vocab_parallel_ce"]
    assert calls and all(c[0][1] == 128 for c in calls)   # 256 / 2


def test_expert_overflow_drops_what_one_device_drops(world):
    """``capacity_factor=0.5``: tokens overflow their experts' capacity
    and are dropped; under expert parallelism the same ones."""
    _held(world["overflow"])
    assert world["overflow"]["calls"]["moe_ffn"][0][0]


@pytest.mark.parametrize("case", ["odd_vocab", "odd_vocab_whisper"])
def test_vocabulary_the_axis_does_not_divide_stays_whole(world, case):
    """257 rows (as whisper's 51865 and hymba's 32001 are odd): the
    resolver leaves the vocabulary whole, the cross-entropy takes the whole
    path, and the step still equals one device."""
    _held(world[case])
    assert "_vocab_parallel_ce" not in world[case]["calls"]


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_recomputed_vocabulary_parallel_chunk_equals_the_plain_one(world,
                                                                 policy):
    got = world["remat"][policy]
    assert got["vp_calls"] > world["remat"]["none"]["vp_calls"] > 0
    assert got["loss_err"] <= 1e-6 and got["grad_err"] <= 1e-6


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_three_meshed_steps_match_the_reference_meshed_steps(
        reference_and_world, arch):
    ref, world = reference_and_world
    np.testing.assert_allclose(world["ref_" + arch], ref[arch], rtol=REF_TOL)


def test_in_proj_exchange_gives_each_rank_its_channels_of_x_and_z(world):
    """``halves_over_model`` on model axes of 2 and 4: a rank's block of
    ``[x | z]``'s columns becomes its run of x's and of z's channels, and
    the reverse exchange brings each gradient back to its block."""
    assert world["exchange"] == {"2": True, "4": True}
