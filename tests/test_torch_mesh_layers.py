"""The port's layers under a ``torch.distributed`` device mesh
(``src/repro_torch``): the context-parallel flash attention under the
reference's exact condition, the selective scan run once a shard, and the
meshed train step against the reference's own meshed step.

The meshed checks run in one spawned world of 4 gloo ranks on a (2, 2)
("data", "model") "cpu" mesh, at the configuration of the reference's
``tests/test_pipeline.py::test_context_parallel_attention_subprocess``
(hymba-1.5b reduced to 5 heads of 5 KV heads, d_model 80, window 48,
chunks 32 / 32 / 64, float32) on 2 x 256 tokens. The reference runs in a
subprocess with four forced host devices; its parameters reach the port
through ``models/convert.py``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CP_CFG = dict(n_heads=5, n_kv_heads=5, d_model=80, attn_chunk_q=32,
              attn_chunk_kv=32, attn_chunk_threshold=64, window=48,
              dtype="float32", ssm_kernel=True)
TOKENS = (2, 256)
REF_STEPS = 3

REFERENCE = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(ROOT, "src"))
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import Model, reduced
from repro.sharding import DEFAULT_RULES, logical_axis_rules
from repro.train import adafactor_init, adamw_init, make_train_step
from repro.train.optimizer import OptConfig
from repro.train.state import train_state_specs
from repro.utils.jaxcompat import make_auto_mesh
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.models.convert import flatten_reference

cfg = reduced(get_config("hymba-1.5b"), **CP_CFG)
model = Model(cfg)
params = model.init_params(jax.random.PRNGKey(0))
tok = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (TOKENS[0], TOKENS[1] + 1)).astype(np.int32)
batch = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
x_plain, _ = model.forward(params, batch["tokens"])
np.savez(os.path.join(TMP, "params.npz"),
         **flatten_reference(jax.tree.map(np.asarray, params)))
np.save(os.path.join(TMP, "tokens.npy"), tok)
np.save(os.path.join(TMP, "x_plain.npy"), np.asarray(x_plain, np.float32))
mesh = make_auto_mesh((2, 2), ("data", "model"))
ocfg = OptConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
losses = {}
for opt, init in (("adamw", adamw_init), ("adafactor", adafactor_init)):
    with mesh, logical_axis_rules(mesh, DEFAULT_RULES):
        state = {"params": params, "opt": init(params),
                 "step": jnp.zeros((), jnp.int32)}
        sh = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                          train_state_specs(state, mesh, DEFAULT_RULES))
        state = jax.tree.map(jax.device_put, state, sh)
        step = jax.jit(make_train_step(model, ocfg, opt),
                       in_shardings=(sh, None), out_shardings=(sh, None))
        losses[opt] = []
        for _ in range(REF_STEPS):
            state, m = step(state, batch)
            losses[opt].append(float(m["loss"]))
with open(os.path.join(TMP, "ref.json"), "w") as f:
    json.dump({"losses": losses}, f)
'''

WORLD = r'''
import contextlib, json, os
import numpy as np
import torch
import repro_torch.sharding.spmd as SP
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
import repro_torch.models.layers as L
import repro_torch.models.ssm as S
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import Model, reduced
from repro_torch.models.convert import load_reference_params
from repro_torch.sharding.rules import distribute_batch, distribute_params
from repro_torch.sharding.spmd import place
from repro_torch.sharding.annotate import NamedSharding, PartitionSpec as P
from repro_torch.train import OptConfig, make_train_step, place_train_state
from repro_torch.launch.train import build_state

torch.set_num_threads(1)
mesh = make_device_mesh((2, 2), device_type="cpu")
out = {}
spied = {"cp": 0, "flash_q": [], "scan": []}
real_cp, real_flash, real_scan = (L._context_parallel_flash,
                                  L.flash_attention, S.selective_scan)


def cp_spy(*a, **k):
    spied["cp"] += 1
    return real_cp(*a, **k)


def flash_spy(q, *a, **k):
    spied["flash_q"].append([list(q.shape), k.get("q_block_start", 0),
                             k.get("block_q")])
    return real_flash(q, *a, **k)


def scan_spy(xc, dt, bm, cm, a, h0, chunk):
    spied["scan"].append([list(t.shape) for t in (xc, dt, bm, cm, a)])
    return real_scan(xc, dt, bm, cm, a, h0, chunk)


L._context_parallel_flash, L.flash_attention = cp_spy, flash_spy
S.selective_scan = scan_spy
params = dict(np.load(os.path.join(TMP, "params.npz")))
tok = np.load(os.path.join(TMP, "tokens.npy"))
batch = {"tokens": torch.from_numpy(tok[:, :-1]).long(),
         "labels": torch.from_numpy(tok[:, 1:]).long()}


def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def model_of(cfg, meshed):
    m = Model(cfg, seed=0, device="cpu")
    if cfg == CP:
        load_reference_params(m, params)
    return distribute_params(m, mesh) if meshed else m


def forward_and_grads(cfg, tokens, meshed):
    """the hidden states and every parameter's gradient of a fixed random
    projection of them"""
    model = model_of(cfg, meshed)
    t = place(tokens, NamedSharding(mesh, P("data", None))) if meshed \
        else tokens
    x, _ = model(t)
    w = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, tuple(x.shape)).astype(np.float32))
    names, leaves = zip(*model.named_parameters())
    with implicit_replication():
        grads = torch.autograd.grad((x * w).sum(), leaves, allow_unused=True)
    return whole(x), {n: whole(g) for n, g in zip(names, grads)
                      if g is not None}


def rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


CP = reduced(get_config("hymba-1.5b"), **CP_CFG)
# the branch, taken: forward and gradients against one device
x1, g1 = forward_and_grads(CP, batch["tokens"], False)
spied.update(cp=0, flash_q=[], scan=[])
xm, gm = forward_and_grads(CP, batch["tokens"], True)
every_rank = [None] * 4
torch.distributed.all_gather_object(every_rank, spied["flash_q"])
out["cp"] = {"calls": spied["cp"], "flash_q": every_rank,
             "scan": list(spied["scan"]), "x_rel": rel(xm, x1),
             "x_ref_err": float((xm - torch.from_numpy(np.load(
                 os.path.join(TMP, "x_plain.npy")))).abs().max()),
             "g_rel": max(rel(gm[k], g1[k]) for k in g1)}
# not taken: heads dividing the model axis, no window, 64 positions a shard
for name, cfg, tokens in (
        ("heads_divide", CP.replace(n_heads=4, n_kv_heads=4),
         batch["tokens"]),
        ("no_window", CP.replace(window=0), batch["tokens"]),
        ("short_shards", CP, batch["tokens"][:, :128])):
    spied["cp"] = 0
    x_one, _ = forward_and_grads(cfg, tokens, False)
    x_mesh, _ = forward_and_grads(cfg, tokens, True)
    out[name] = {"calls": spied["cp"], "x_rel": rel(x_mesh, x_one)}

# the scan once a shard: a Mamba layer on this rank's rows with its
# channels of every leaf on "model" (the part ``block_params`` keeps), B
# and C whole; their gradients (each model rank's part) summed over
# "model", which x_proj's gradient (B's and C's columns) and x's show
rng = np.random.default_rng(4)
b_, s_, n = 4, 32, 8
scfg = reduced(get_config("falcon-mamba-7b"), d_model=12, ssm_state=n,
               ssm_chunk=8, ssm_kernel=True)
layer = S.init_mamba(torch.Generator().manual_seed(4), scfg)
x_all = torch.tensor(rng.normal(0, 1, (b_, s_, 12)), dtype=torch.float32)
dy = torch.tensor(rng.normal(0, 1, (b_, s_, 12)), dtype=torch.float32)
rows = slice(mesh.get_local_rank("data") * 2,
             mesh.get_local_rank("data") * 2 + 2)
model_rank = mesh.get_local_rank("model")


def channels(k, t):
    """this model rank's block of a leaf along its SSM_SPLIT dim"""
    dim = S.SSM_SPLIT[k]
    size = t.shape[dim] // 2
    return t.narrow(dim, model_rank * size, size)


scan_out = {}
for meshed in (False, True):
    spied["scan"] = []
    ps = {k: (channels(k, v) if meshed else v).clone().requires_grad_()
          for k, v in layer.items()}
    xs = x_all[rows].clone().requires_grad_()
    ctx = SP.spmd(mesh, b_) if meshed else contextlib.nullcontext()
    with ctx:
        y = S.mamba_forward(ps, scfg, xs, split=meshed)
        grads = torch.autograd.grad((y * dy[rows]).sum(),
                                    [xs, *ps.values()])
    scan_out[meshed] = (y.detach(), dict(zip(["x", *ps], grads)),
                        list(spied["scan"]))
(y0, g0, _), (y1, g1_, shapes) = scan_out[False], scan_out[True]
out["scan"] = {"shapes": shapes, "y_err": float((y1 - y0).abs().max()),
               "grad_err": {k: rel(g1_[k], g0[k] if k == "x" else
                                   channels(k, g0[k])) for k in g0}}

# three meshed steps of each optimizer from the reference's parameters
ocfg = OptConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
b = distribute_batch(batch, mesh)
out["steps"] = {}
for opt in ("adamw", "adafactor"):
    model = model_of(CP, True)
    state = place_train_state(build_state(model, opt), mesh)
    step = make_train_step(model, ocfg, opt)
    out["steps"][opt] = []
    for _ in range(REF_STEPS):
        state, m = step(state, b)
        out["steps"][opt].append(float(m["loss"]))

if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(body: str, world: int = 4, timeout: float = 600, **consts
              ) -> dict:
    """Run ``body`` in ``world`` spawned gloo ranks (``rank``, ``world``
    and the upper-case ``consts`` bound) and return the JSON object rank 0
    printed after ``RESULT``."""
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    code = textwrap.dedent("""
        import os, sys
        sys.path.insert(0, os.path.join({root!r}, "src"))
        import torch.distributed as dist
        rank, world = int(sys.argv[1]), int(sys.argv[2])
        dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            exec(compile({src!r}, "<world>", "exec"))
        finally:
            dist.destroy_process_group()
    """).format(root=ROOT, port=_free_port(), src=head + body)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    line = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")]
    assert line, outs[0][-2000:]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cp"))
    code = "".join(f"{k} = {v!r}\n" for k, v in dict(
        ROOT=ROOT, TMP=tmp, CP_CFG=CP_CFG, TOKENS=TOKENS,
        REF_STEPS=REF_STEPS).items()) + REFERENCE
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(os.path.join(tmp, "ref.json")) as f:
        return tmp, json.load(f)


@pytest.fixture(scope="module")
def world(ref):
    tmp, _ = ref
    return run_world(WORLD, TMP=tmp, CP_CFG=CP_CFG, REF_STEPS=REF_STEPS)


def test_context_parallel_branch_is_taken_on_each_attention_layer(world):
    got = world["cp"]
    # hymba's two layers, each run again in backward under remat "full"
    assert got["calls"] == 4
    # each rank's q shard: batch / 2, 256 / 2 positions, blocks of 32
    # numbered from its rank on "model" (rank % 2) times 4 blocks a shard
    for rank, calls in enumerate(got["flash_q"]):
        assert calls == [[[1, 128, 5, 16], (rank % 2) * 4, 32]] * 4


def test_context_parallel_forward_and_gradients_equal_one_device(world):
    got = world["cp"]
    assert got["x_rel"] <= 1e-5
    assert got["g_rel"] <= 1e-5


def test_context_parallel_forward_equals_the_reference_plain_forward(world):
    assert world["cp"]["x_ref_err"] <= 1e-4


@pytest.mark.parametrize("case", ["heads_divide", "no_window",
                                  "short_shards"])
def test_context_parallel_branch_is_not_taken_off_its_condition(world, case):
    assert world[case]["calls"] == 0
    assert world[case]["x_rel"] <= 1e-5


def test_scan_runs_once_a_shard_on_its_local_tensors(world):
    # xc, dt [B/2, S, Di/2]; B, C [B/2, S, N]; A [Di/2, N]; each layer of
    # the CP model too (Di = 160, N = 8)
    assert world["scan"]["shapes"] == [[[2, 32, 12], [2, 32, 12],
                                        [2, 32, 8], [2, 32, 8], [12, 8]]]
    assert world["cp"]["scan"] and all(
        s == [[1, 256, 80], [1, 256, 80], [1, 256, 8], [1, 256, 8],
              [80, 8]] for s in world["cp"]["scan"])


def test_scan_gradients_of_b_and_c_are_summed_over_the_model_axis(world):
    """B and C come out of ``x_proj`` (their columns): its gradient and the
    input's hold one device's only where B's and C's are summed over
    "model"; every other leaf's too."""
    got = world["scan"]
    assert got["y_err"] <= 1e-6
    assert got["grad_err"]["x_proj"] <= 1e-6 and got["grad_err"]["x"] <= 1e-6
    assert max(got["grad_err"].values()) <= 1e-6


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_three_meshed_steps_match_the_reference_meshed_steps(world, ref,
                                                            opt):
    _, want = ref
    assert len(world["steps"][opt]) == REF_STEPS
    np.testing.assert_allclose(world["steps"][opt], want["losses"][opt],
                               rtol=1e-4)
