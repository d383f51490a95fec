"""Whisper's meshed serving (``src/repro_torch``): ``Model.prefill``,
``Model.encode``, ``Model.cross_kv``, ``Model.init_cache`` and
``Model.decode_step`` once a rank on a ``torch.distributed`` device mesh,
the parameters placed by ``param_specs``, the frames and tokens by
``batch_specs`` and the caches (the cross cache included) by
``cache_specs`` under each of the reference's three rule sets, against one
device and against the reference's own sharded prefill and decode step.

Every meshed check runs in one spawned world of 4 gloo ranks on "cpu"
meshes ((2, 2) and (4, 1)) at ``reduced(whisper-medium, dtype="float32")``
(batch 1 under ``LONG_CONTEXT_RULES``); rank 0 prints the world's findings
as one JSON line. Logits are held within rtol and atol 1e-5. The cross
cache takes a layout of its own under each rule set: its heads on "model"
(``DEFAULT_RULES``, ``LONG_CONTEXT_RULES``), its frames on "model"
(``SERVING_RULES``' "seq_kv"), whole on a model axis of 1. The reference
runs in a subprocess with four forced host devices, its prefill and decode
step jitted with the dry-run's shardings (``repro/launch/dryrun.py``), its
cross cache computed from its encoder output as its smoke test does and
placed by ``cache_specs``.
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

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "whisper-medium"
BATCH, PREFILL_SEQ, STEPS = 4, 16, 8
# (case id, mesh, rule set, reduced() overrides)
CASES = tuple((f"{rules}-{'x'.join(map(str, mesh))}", mesh, rules, {})
              for mesh in ((2, 2), (4, 1))
              for rules in ("default", "serving", "long")) + (
    # 72 frames: the encoder's flash attention pads its keys (Queue C)
    ("frames72-default-2x2", (2, 2), "default", {"n_audio_frames": 72}),
    ("frames72-serving-2x2", (2, 2), "serving", {"n_audio_frames": 72}))
# the cross cache's layer-local dim split over "model" in each case
CROSS_DIMS = {"default-2x2": 2, "serving-2x2": 1, "long-2x2": 2,
              "default-4x1": None, "serving-4x1": None, "long-4x1": None}
REF_RULES = ("default", "serving", "long")

REFERENCE = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(ROOT, "src"))
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import Model, reduced
from repro.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES, SERVING_RULES,
                            batch_specs, cache_specs, logical_axis_rules,
                            param_specs)
from repro.utils.jaxcompat import make_auto_mesh
from repro_torch.models.convert import flatten_reference

RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES,
         "long": LONG_CONTEXT_RULES}
mesh = make_auto_mesh((2, 2), ("data", "model"))


def nm(tree):
    return jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s), tree)


cfg = reduced(get_config(ARCH), dtype="float32")
model = Model(cfg)
params = model.init_params(jax.random.PRNGKey(0))
np.savez(os.path.join(TMP, "params.npz"),
         **flatten_reference(jax.tree.map(np.asarray, params)))
out = {}
for rules_name in REF_RULES:
    rules = RULES[rules_name]
    b = 1 if rules_name == "long" else BATCH
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (b, PREFILL_SEQ)).astype(np.int32)
    frames = rng.normal(0, 1, (b, cfg.n_audio_frames, cfg.d_model)).astype(
        np.float32)
    teacher = rng.integers(0, cfg.vocab_size, (b, STEPS)).astype(np.int32)
    np.savez(os.path.join(TMP, f"{rules_name}-inputs.npz"), tokens=tok,
             frames=frames, teacher=teacher)
    with mesh, logical_axis_rules(mesh, rules):
        p_sh = nm(param_specs(params, mesh, rules))
        batch = {"tokens": jnp.asarray(tok), "frames": jnp.asarray(frames)}
        b_sh = nm(batch_specs(batch, mesh, rules))
        p = jax.device_put(params, p_sh)
        prefill = jax.jit(lambda p_, b_: model.prefill(
            p_, b_["tokens"], extra={"frames": b_["frames"]}),
            in_shardings=(p_sh, b_sh))
        pre = np.asarray(prefill(p, jax.device_put(batch, b_sh)), np.float32)
        # the cross cache from the encoder output, as the reference's smoke
        # test computes it
        enc, _ = model._encode(params, jnp.asarray(frames))
        ks = jnp.einsum("btd,ldhk->lbthk", enc,
                        params["blocks"]["cross"]["wk"])
        vs = jnp.einsum("btd,ldhk->lbthk", enc,
                        params["blocks"]["cross"]["wv"])
        cache = model.init_cache(b, STEPS)
        cache["cross_k"], cache["cross_v"] = ks, vs
        c_sh = nm(cache_specs(cache, mesh, rules))
        t_sh = nm(batch_specs({"tokens": jnp.asarray(teacher[:, :1])}, mesh,
                              rules))["tokens"]
        step = jax.jit(model.decode_step,
                       in_shardings=(p_sh, c_sh, t_sh, None),
                       out_shardings=(None, c_sh))
        cache = jax.device_put(cache, c_sh)
        logits = []
        for t in range(STEPS):
            lg, cache = step(p, cache, jnp.asarray(teacher[:, t:t + 1]),
                             jnp.asarray(t, jnp.int32))
            logits.append(np.asarray(lg, np.float32))
    np.save(os.path.join(TMP, f"{rules_name}-prefill.npy"), pre)
    np.save(os.path.join(TMP, f"{rules_name}-logits.npy"), np.stack(logits))
    out[rules_name] = str(cache["cross_k"].sharding.spec)
with open(os.path.join(TMP, "ref.json"), "w") as f:
    json.dump(out, f)
'''

WORLD = r'''
import json, os, time
import numpy as np
import torch
from torch.distributed.tensor import Shard
import repro_torch.models.layers as L
import repro_torch.sharding.spmd as SP
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import Model, reduced
from repro_torch.models.convert import load_reference_params
from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                  SERVING_RULES)
from repro_torch.sharding.annotate import placements
from repro_torch.sharding.rules import (cache_specs, distribute_batch,
                                        distribute_params)
from repro_torch.sharding.spmd import full_value, local_shape

torch.set_num_threads(1)
RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES,
         "long": LONG_CONTEXT_RULES}
meshes = {(2, 2): make_device_mesh((2, 2), device_type="cpu"),
          (4, 1): make_device_mesh((4, 1), device_type="cpu")}
out = {}

seen = {"on": False, "gathered": [], "cross_dims": []}
real_whole, real_cross = SP._WholeParam.forward, L.cross_decode_attention


def whole_spy(ctx, local, mesh, layout, rows, keep=None):
    m = mesh.mesh_dim_names.index("model")
    if seen["on"] and isinstance(layout[m], Shard) and keep != m \
            and mesh.size(m) > 1:
        seen["gathered"].append(local.data_ptr())
    return real_whole(ctx, local, mesh, layout, rows, keep)


def cross_spy(*a, cache_dim=None, **k):
    if seen["on"]:
        seen["cross_dims"].append(cache_dim)
    return real_cross(*a, cache_dim=cache_dim, **k)


SP._WholeParam.forward = staticmethod(whole_spy)
L.cross_decode_attention = cross_spy


def err(a, b):
    return float((a - b).abs().max())


def close(a, b):
    return bool(torch.allclose(a, b, **TOL))


def served(one, model, mesh, rules, tok, frames, teacher):
    """(prefill logits, every teacher-forced decode step's logits, the
    cross cache) of one device and of the mesh; the mesh's decode steps
    recorded by the spies"""
    b = tok.shape[0]
    want = one.prefill(tok, extra={"frames": frames})
    placed = distribute_batch({"tokens": tok, "frames": frames}, mesh, rules)
    got = full_value(model.prefill(placed["tokens"],
                                   extra={"frames": placed["frames"]},
                                   rules=rules))
    c1 = one.init_cache(b, teacher.shape[1])
    c1["cross_k"], c1["cross_v"] = one.cross_kv(one.encode(frames))
    c2 = model.init_cache(b, teacher.shape[1], rules=rules)
    c2["cross_k"], c2["cross_v"] = model.cross_kv(
        model.encode(placed["frames"], rules=rules), rules=rules)
    specs = cache_specs(c1, mesh, rules)
    rec = {"prefill": [err(got, want), close(got, want)],
           "cross_shapes": all(
               tuple(c2[k].to_local().shape) == local_shape(
                   c1[k].shape, mesh, placements(specs[k], mesh))
               and tuple(c2[k].placements) == tuple(placements(specs[k],
                                                               mesh))
               for k in ("cross_k", "cross_v")),
           "cross": max(err(full_value(c2[k]), c1[k])
                        for k in ("cross_k", "cross_v"))}
    steps1, steps2 = [], []
    seen.update(on=False, gathered=[], cross_dims=[])
    for t in range(teacher.shape[1]):
        col = teacher[:, t:t + 1]
        steps1.append(one.decode_step(c1, col, t)[0])
        seen["on"] = True
        lg, _ = model.decode_step(c2, distribute_batch(
            {"tokens": col}, mesh, rules)["tokens"], t, rules=rules)
        seen["on"] = False
        steps2.append(full_value(lg))
    return rec, torch.stack(steps1), torch.stack(steps2)


for case_id, sizes, rules_name, over in CASES:
    mesh, rules = meshes[tuple(sizes)], RULES[rules_name]
    cfg = reduced(get_config(ARCH), dtype="float32", **over)
    b = 1 if rules_name == "long" else BATCH
    one = Model(cfg, seed=0, device="cpu")
    model = distribute_params(Model(cfg, seed=0, device="cpu"), mesh, rules)
    names = {p.to_local().data_ptr(): k for k, p in model.named_parameters()}
    rng = np.random.default_rng(1)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, PREFILL_SEQ)))
    frames = torch.as_tensor(rng.normal(0, 1, (
        b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    teacher = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, STEPS)))
    rec, s1, s2 = served(one, model, mesh, rules, tok, frames, teacher)
    rec["decode"] = [err(s2, s1), close(s2, s1)]
    rec["greedy_equal"] = bool(torch.equal(s1.argmax(-1), s2.argmax(-1)))
    rec["cross_dims"] = sorted(set(seen["cross_dims"]),
                               key=lambda d: -1 if d is None else d)
    rec["gathered_over_model"] = sorted({names.get(p, "?")
                                         for p in seen["gathered"]})
    out[case_id] = rec

# the reference's sharded prefill and decode, carried across (its
# subprocess runs beside this world; its files are complete once "done"
# exists)
deadline = time.monotonic() + 600
while not os.path.exists(os.path.join(TMP, "done")):
    if time.monotonic() > deadline:
        raise TimeoutError("the reference's subprocess never finished")
    time.sleep(0.2)
cfg = reduced(get_config(ARCH), dtype="float32")
ref_params = dict(np.load(os.path.join(TMP, "params.npz")))
for rules_name in REF_RULES:
    rules, mesh = RULES[rules_name], meshes[(2, 2)]
    model = Model(cfg, seed=0, device="cpu")
    load_reference_params(model, ref_params)
    one = Model(cfg, seed=0, device="cpu")
    load_reference_params(one, ref_params)
    distribute_params(model, mesh, rules)
    x = np.load(os.path.join(TMP, f"{rules_name}-inputs.npz"))
    tok, teacher = (torch.as_tensor(x[k]).long() for k in ("tokens",
                                                           "teacher"))
    frames = torch.as_tensor(x["frames"])
    rec, _, s2 = served(one, model, mesh, rules, tok, frames, teacher)
    want_pre = torch.as_tensor(np.load(os.path.join(
        TMP, f"{rules_name}-prefill.npy")))
    want = torch.as_tensor(np.load(os.path.join(
        TMP, f"{rules_name}-logits.npy")))
    got_pre = full_value(model.prefill(
        distribute_batch({"tokens": tok}, mesh, rules)["tokens"],
        extra={"frames": distribute_batch({"frames": frames}, mesh,
                                          rules)["frames"]}, rules=rules))
    out["ref_" + rules_name] = {
        "prefill": [err(got_pre, want_pre), close(got_pre, want_pre)],
        "decode": [err(s2, want), close(s2, want)]}

if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


@pytest.fixture(scope="module")
def reference_and_world(tmp_path_factory):
    """(the reference's cache specs, the world's findings): the reference's
    subprocess runs beside the world, which reads its files last."""
    tmp = str(tmp_path_factory.mktemp("mesh_encdec"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    consts = dict(ROOT=ROOT, TMP=tmp, ARCH=ARCH, BATCH=BATCH,
                  PREFILL_SEQ=PREFILL_SEQ, STEPS=STEPS, REF_RULES=REF_RULES)
    head = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    body = "try:\n    exec(compile(REFERENCE_SRC, '<reference>', 'exec'))\n" \
           "finally:\n    open(os.path.join(TMP, 'done'), 'w').close()\n"
    log = os.path.join(tmp, "reference.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", head + "import os\n" +
             f"REFERENCE_SRC = {REFERENCE!r}\n" + body], env=env,
            stdout=out, stderr=subprocess.STDOUT)
    try:
        found = run_world(WORLD, TOL=TOL, CASES=CASES,
                          **{k: v for k, v in consts.items() if k != "ROOT"})
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


IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", IDS)
def test_meshed_whisper_prefill_matches_one_device(world, case):
    assert world[case]["prefill"][1], world[case]["prefill"]


@pytest.mark.parametrize("case", IDS)
def test_meshed_whisper_decode_steps_match_one_device(world, case):
    got = world[case]
    assert got["decode"][1], got["decode"]
    assert got["greedy_equal"]


@pytest.mark.parametrize("case", IDS)
def test_cross_cache_has_its_specs_local_shapes_and_gathers_back(world,
                                                                  case):
    got = world[case]
    assert got["cross_shapes"]
    assert got["cross"] <= TOL["atol"]


@pytest.mark.parametrize("case", sorted(CROSS_DIMS))
def test_cross_attention_reads_the_layout_of_its_cache(world, case):
    """Heads on "model" under the default and long-context rules, the
    frames under the serving rules, the whole cache on a model axis of
    1."""
    assert world[case]["cross_dims"] == [CROSS_DIMS[case]]


@pytest.mark.parametrize("case", [c for c in IDS if "2x2" in c])
def test_whisper_decode_gathers_no_parameter_split_over_model(world, case):
    assert world[case]["gathered_over_model"] == []


@pytest.mark.parametrize("rules", REF_RULES)
def test_meshed_whisper_matches_the_reference_sharded_prefill_and_decode(
        reference_and_world, rules):
    ref, world = reference_and_world
    assert "model" in ref[rules], ref[rules]     # the cross cache split
    got = world["ref_" + rules]
    assert got["prefill"][1], got["prefill"]
    assert got["decode"][1], got["decode"]
