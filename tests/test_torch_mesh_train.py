"""Sharded training of the port over a ``torch.distributed`` device mesh
(``src/repro_torch``): parameters, optimizer state and batches placed by
the sharding rules as DTensors, the meshed train step against one device,
elastic checkpoint restores and a resume under a mesh.

Every meshed check runs in one spawned world of 4 gloo ranks on "cpu"
meshes ((2, 2) and (4, 1) ("data", "model")), at ``reduced(cfg,
dtype="float32")``; rank 0 prints the world's findings as one JSON line,
which the tests below read. Parameters after two AdamW / Adafactor steps
are held elementwise within 1e-5 of max(1, the leaf's largest magnitude):
a key bias's gradient is zero but for rounding (the softmax does not see
it), and both optimizers scale such a gradient up to a step of about the
learning rate (5e-5 here), so its leaf moves by rounding noise times the
learning rate on either side.
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
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (make_device_mesh,  # noqa: E402
                                     make_production_device_mesh)
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import reduced  # noqa: E402

STEP_TOL = 1e-5
LR = 5e-5
# (arch, mesh, optimizer, accum_steps, remat): every value of each axis on
# each of the three models
STEP_CASES = (
    ("qwen2.5-3b", (2, 2), "adamw", 1, "full"),
    ("qwen2.5-3b", (4, 1), "adafactor", 2, "dots"),
    ("hymba-1.5b", (2, 2), "adafactor", 1, "dots"),
    ("hymba-1.5b", (4, 1), "adamw", 2, "full"),
    ("falcon-mamba-7b", (2, 2), "adamw", 2, "dots"),
    ("falcon-mamba-7b", (4, 1), "adafactor", 1, "full"),
)
OTHER_FAMILIES = ("olmoe-1b-7b", "deepseek-v2-lite-16b", "llava-next-34b",
                  "whisper-medium", "glm4-9b", "nemotron-4-15b",
                  "codeqwen1.5-7b")
PLACED = ("qwen2.5-3b", "hymba-1.5b", "olmoe-1b-7b")
TP_ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "deepseek-v2-lite-16b")

WORLD = r'''
import json, os, signal
import torch
import repro_torch.launch.train as T
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_device_mesh, make_host_mesh
from repro_torch.launch.train import build_state, train
from repro_torch.models import Model, reduced
from repro_torch.models.inputs import ShapeSpec, make_inputs
from repro_torch.sharding.annotate import spec_ways
from repro_torch.sharding.rules import (distribute_batch, distribute_params,
                                        param_specs)
from repro_torch.sharding.spmd import local_shard
from repro_torch.train import (OptConfig, make_train_step, microbatches,
                               place_train_state, train_state_shardings)

torch.set_num_threads(1)
out = {}
meshes = {(2, 2): make_device_mesh((2, 2), device_type="cpu"),
          (4, 1): make_device_mesh((4, 1), device_type="cpu")}
m22 = meshes[(2, 2)]
host = make_host_mesh("cpu")
out["host_mesh"] = [list(host.mesh_dim_names), list(host.shape)]


def cfg_of(arch, **kw):
    return reduced(get_config(arch), dtype="float32", **kw)


def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


# -- placement and per-rank bytes --
for arch in PLACED:
    cfg = cfg_of(arch)
    full = {k: p.detach().clone()
            for k, p in Model(cfg, seed=0, device="cpu").named_parameters()}
    model = distribute_params(Model(cfg, seed=0, device="cpu"), m22)
    specs = param_specs(full, m22)
    bad_shape, bad_bits, bad_cut, held, want, n_split = [], [], [], 0, 0.0, 0
    for k, p in model.named_parameters():
        shape = list(full[k].shape)
        for i, entry in enumerate(specs[k]):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                shape[i] //= m22.shape[m22.mesh_dim_names.index(a)]
        if list(p.to_local().shape) != shape:
            bad_shape.append(k)
        if not torch.equal(p.full_tensor(), full[k]):
            bad_bits.append(k)
        if not torch.equal(local_shard(full[k], m22, p.placements),
                           p.to_local()):
            bad_cut.append(k)
        held += p.to_local().numel() * p.to_local().element_size()
        want += full[k].numel() * full[k].element_size() / spec_ways(
            specs[k], m22)
        n_split += spec_ways(specs[k], m22) > 1
    total = sum(t.numel() * t.element_size() for t in full.values())
    heldall = [None] * 4
    torch.distributed.all_gather_object(heldall, held)
    state = place_train_state(build_state(model, "adamw"), m22)
    fac = place_train_state(build_state(model, "adafactor"), m22)
    out["placed_" + arch] = {
        "bad_shape": bad_shape, "bad_bits": bad_bits, "bad_cut": bad_cut,
        "held": heldall,
        "want": want, "total": total, "n_split": n_split,
        "moments_like_params": all(
            tuple(state["opt"][m][k].placements) == tuple(p.placements)
            for m in ("m", "v") for k, p in model.named_parameters()),
        "factored_replicated": all(
            all(pl == Replicate() for pl in leaf.placements)
            for f in fac["opt"]["f"].values() for leaf in f.values()),
        "step": [type(state["step"]).__name__, state["step"]]}


# -- which sublayers run tensor-parallel over "model" --
import repro_torch.models.model as MM
real_block_params, seen = MM.block_params, []


def spy(p, cfg, moe):
    got, split = real_block_params(p, cfg, moe)
    seen.append({k: [split[k], [list(t.shape) for t in got[k].values()
                                if torch.is_tensor(t)]]
                 for k in split if k in got})
    return got, split


MM.block_params = spy
for arch in TP_ARCHS:
    cfg = cfg_of(arch)
    for sizes in ((2, 2), (4, 1)):
        model = distribute_params(Model(cfg, seed=0, device="cpu"),
                                  meshes[sizes])
        seen.clear()
        with torch.no_grad():
            model.loss(distribute_batch(make_inputs(
                cfg, ShapeSpec("t", 64, 4, "train"), seed=3,
                device="cpu"), meshes[sizes]))
        out[f"tp_{arch}_{sizes[1]}"] = {
            "blocks": seen[:], "d_ff": cfg.d_ff, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "d_model": cfg.d_model}
MM.block_params = real_block_params


# -- one meshed train step against one device --
def two_steps(arch, mesh, opt, accum, remat):
    cfg = cfg_of(arch, remat=remat, ssm_kernel=True)
    batch = make_inputs(cfg, ShapeSpec("t", 64, 4, "train"), seed=3,
                        device="cpu")
    ocfg = OptConfig(learning_rate=LR, warmup_steps=1, decay_steps=10)
    runs = []
    for meshed in (False, True):
        model = Model(cfg, seed=0, device="cpu")
        if meshed:
            distribute_params(model, meshes[mesh])
        state = build_state(model, opt)
        if meshed:
            state = place_train_state(state, meshes[mesh])
        step = make_train_step(model, ocfg, opt, accum_steps=accum)
        b = batch
        if meshed:
            b = distribute_batch(batch, meshes[mesh]) if accum == 1 else [
                distribute_batch(m, meshes[mesh])
                for m in microbatches(batch, accum)]
        metrics = []
        for _ in range(2):
            state, m = step(state, b)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        runs.append((metrics, {k: whole(p) for k, p in
                               state["params"].items()}))
    (m0, p0), (m1, p1) = runs
    worst = max(float(((p1[k] - p0[k]).abs().max()) /
                      max(1.0, float(p0[k].abs().max()))) for k in p0)
    return {"one": m0, "mesh": m1, "worst_param": worst}


for case in STEP_CASES:
    out["step_" + "|".join(map(str, case))] = two_steps(*case)
for arch in OTHER_FAMILIES:
    out["family_" + arch] = two_steps(arch, (2, 2), "adamw", 1, "full")


# -- elastic restore: one device -> (2, 2) and (2, 2) -> one device --
cfg = cfg_of("qwen2.5-3b")
batch = make_inputs(cfg, ShapeSpec("t", 64, 4, "train"), seed=5,
                    device="cpu")
one = Model(cfg, seed=7, device="cpu")
with torch.no_grad():
    one_loss = float(one.loss(batch)[0])
d1, d2 = os.path.join(TMP, "one"), os.path.join(TMP, "mesh")
if torch.distributed.get_rank() == 0:
    save_checkpoint(d1, 3, {"params": dict(one.named_parameters())})
torch.distributed.barrier()
model = distribute_params(Model(cfg, seed=0, device="cpu"), m22)
tree = {"params": dict(model.named_parameters())}
sh = {"params": train_state_shardings(
    {"params": tree["params"], "opt": {}}, m22)["params"]}
restored, step = restore_checkpoint(d1, tree, shardings=sh)
same_objects = all(restored["params"][k] is p for k, p in
                   tree["params"].items())
with torch.no_grad():
    mesh_loss = float(model.loss(distribute_batch(batch, m22))[0]
                      .full_tensor())
out["elastic_up"] = {"one": one_loss, "mesh": mesh_loss, "step": step,
                     "same_objects": same_objects}
save_checkpoint(d2, 4, {"params": dict(model.named_parameters())})
back = Model(cfg, seed=0, device="cpu")
restore_checkpoint(d2, {"params": dict(back.named_parameters())})
out["elastic_down"] = all([
    torch.equal(p, whole(dict(model.named_parameters())[k]))
    for k, p in back.named_parameters()])
names = sorted(os.listdir(os.path.join(d2, "step_4")))
out["elastic_files"] = [n for n in names if not n.endswith(".npz")] + \
    [str(sum(n.endswith(".npz") for n in names))]


# -- resume under a mesh --
cfg = cfg_of("hymba-1.5b", ssm_kernel=True)
kw = dict(steps=4, batch=4, seq_len=32, lr=1e-3, mesh=(2, 2), device="cpu",
          log_every=100)
full_state, full_losses = train(cfg, ckpt_dir=os.path.join(TMP, "a"), **kw)
real = T.make_train_step


def preempted_after_two(*args, **kw_):
    """rank 0 alone is sent SIGTERM after its second step"""
    step_fn, calls = real(*args, **kw_), []

    def step(state, batch):
        got = step_fn(state, batch)
        calls.append(1)
        if rank == 0 and len(calls) == 2:
            signal.raise_signal(signal.SIGTERM)
        return got
    return step


T.make_train_step = preempted_after_two
_, first = train(cfg, ckpt_dir=os.path.join(TMP, "b"), **kw)
T.make_train_step = real
resumed_state, rest = train(cfg, ckpt_dir=os.path.join(TMP, "b"), **kw)
out["resume"] = {
    "full": full_losses, "split": first + rest, "first": len(first),
    "params_equal": all([torch.equal(whole(p), whole(
        resumed_state["params"][k])) for k, p in
        full_state["params"].items()]),
    "moments_equal": all([torch.equal(whole(v), whole(
        resumed_state["opt"][m][k])) for m in ("m", "v")
        for k, v in full_state["opt"][m].items()]),
    "step": resumed_state["step"]}

# -- microbatches: the launcher cuts the host batch and places each --
kw_acc = dict(kw, steps=2)
out["accum"] = {"one": train(cfg, accum=1, **kw_acc)[1],
                "two": train(cfg, accum=2, **kw_acc)[1]}
try:
    microbatches(distribute_batch(make_inputs(
        cfg, ShapeSpec("t", 32, 4, "train"), seed=3, device="cpu"), m22), 2)
    out["placed_batch_cut"] = "no error"
except ValueError as e:
    out["placed_batch_cut"] = str(e)

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
def world(tmp_path_factory):
    return run_world(WORLD, TMP=str(tmp_path_factory.mktemp("mesh")),
                     LR=LR, PLACED=PLACED, STEP_CASES=STEP_CASES,
                     OTHER_FAMILIES=OTHER_FAMILIES, TP_ARCHS=TP_ARCHS)


@pytest.mark.parametrize("arch", PLACED)
def test_every_leaf_has_its_specs_local_shape_and_gathers_back(world, arch):
    got = world["placed_" + arch]
    assert got["bad_shape"] == [] and got["bad_bits"] == []
    assert got["n_split"] > 0


@pytest.mark.parametrize("arch", PLACED)
def test_a_host_leaf_is_cut_into_its_dtensor_shard(world, arch):
    """``local_shard`` (how ``place`` cuts a host leaf for the card) gives
    each rank the shard ``distribute_tensor`` keeps."""
    assert world["placed_" + arch]["bad_cut"] == []


@pytest.mark.parametrize("arch", PLACED)
def test_no_rank_holds_the_model_whole(world, arch):
    """Each rank's parameter bytes are the sum of each leaf's bytes over
    its spec's ways, far below the model's."""
    got = world["placed_" + arch]
    assert got["held"] == [got["want"]] * 4
    assert got["want"] < 0.5 * got["total"]


@pytest.mark.parametrize("arch", PLACED)
def test_train_state_is_placed_like_the_reference_specs(world, arch):
    got = world["placed_" + arch]
    assert got["moments_like_params"] and got["factored_replicated"]
    assert got["step"] == ["int", 0]


def _held(rec):
    for (l0, g0), (l1, g1) in zip(rec["one"], rec["mesh"]):
        assert l1 == pytest.approx(l0, rel=STEP_TOL)
        assert g1 == pytest.approx(g0, rel=STEP_TOL)
    assert rec["worst_param"] <= STEP_TOL


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=["-".join(map(str, c)) for c in STEP_CASES])
def test_meshed_steps_match_one_device(world, case):
    _held(world["step_" + "|".join(map(str, case))])


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_other_families_train_under_a_mesh(world, arch):
    _held(world["family_" + arch])


def test_host_mesh_is_the_world_as_data(world):
    assert world["host_mesh"] == [["data", "model"], [4, 1]]


def test_one_device_checkpoint_restores_onto_the_mesh(world):
    got = world["elastic_up"]
    assert got["step"] == 3 and got["same_objects"]
    assert got["mesh"] == pytest.approx(got["one"], rel=1e-6)


def test_mesh_checkpoint_restores_on_one_device_bit_for_bit(world):
    assert world["elastic_down"]
    # the same unsharded files as a one-device save
    assert world["elastic_files"] == ["manifest.json", "1"]


def test_resume_under_a_mesh_equals_the_uninterrupted_run(world):
    got = world["resume"]
    assert got["first"] == 2    # every rank stopped after rank 0's SIGTERM
    assert got["split"] == got["full"] and len(got["full"]) == 4
    assert got["params_equal"] and got["moments_equal"]
    assert got["step"] == 4


def test_device_mesh_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="runs on a CUDA device by "
                                           "default"):
        make_device_mesh((1, 1))


def test_production_mesh_raises_below_256_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_device_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        train_main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                    "--steps", "1", "--production-mesh"])
    assert reduced(get_config("qwen2.5-3b")).n_layers == 2


def test_launcher_places_each_microbatch_of_the_host_batch(world):
    """``train(..., accum=2)`` under a mesh cuts the host batch into
    microbatches and places each; its losses equal the whole batch's
    within the step tolerance. A placed batch is not cut again."""
    got = world["accum"]
    np.testing.assert_allclose(got["two"], got["one"], rtol=STEP_TOL)
    assert "cut the host batch" in world["placed_batch_cut"]


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_attention_and_dense_mlp_run_tensor_parallel_over_model(world,
                                                                arch):
    """On (2, 2) every block's attention (its heads dividing "model"; MLA's
    too, its ``wkv_a`` whole) and dense MLP hold half their heads / hidden
    units and are marked split, and a MoE layer (olmoe, deepseek's routed
    layers) holds half its experts; on (4, 1) nothing is split."""
    got = world[f"tp_{arch}_2"]
    d, ff, h, hk = got["d_model"], got["d_ff"], got["heads"], got["kv_heads"]
    mla = arch.startswith("deepseek")
    for i, block in enumerate(got["blocks"]):
        split, shapes = block["attn"]
        assert split
        if mla:     # wq, wkv_a, wk_b, wv_b, wo
            assert [s[:2] for s in shapes] == [[d, h // 2], [d, shapes[1][1]],
                                               [shapes[2][0], h // 2],
                                               [shapes[3][0], h // 2],
                                               [h // 2, shapes[4][1]]]
        else:
            assert shapes[:4] == [[d, h // 2, d // h], [d, hk // 2, d // h],
                                  [d, hk // 2, d // h], [h // 2, d // h, d]]
        split, shapes = block["mlp"]
        dense = arch == "qwen2.5-3b" or (mla and i == 0)
        assert split is dense
        if dense:
            assert shapes[0] == [d, ff // 2] and shapes[-1] == [ff // 2, d]
        else:       # router, wi, wg, wo: half the 8 experts
            assert shapes[0] == [d, 8] and [s[0] for s in shapes[1:]] == [4] * 3
    assert not any(split for block in world[f"tp_{arch}_1"]["blocks"]
                   for split, _ in block.values())
