"""Serving on a ``torch.distributed`` device mesh (``src/repro_torch``):
``Model.prefill``, ``Model.decode_step`` and ``launch.serve.generate`` once
a rank, with the parameters placed by ``param_specs``, the caches by
``cache_specs`` and the tokens by ``batch_specs`` under each of the
reference's three rule sets (``DEFAULT_RULES``, ``SERVING_RULES``,
``LONG_CONTEXT_RULES`` at batch 1), against one device and against the
reference's own sharded decode.

Every meshed check runs in one spawned world of 4 gloo ranks on "cpu"
meshes ((2, 2) for every case, (4, 1) for qwen2.5-3b and hymba-1.5b) at
``reduced(cfg, dtype="float32")``; rank 0 prints the world's findings as
one JSON line. Logits are held within rtol and atol 1e-5 of one device: the
meshed step sums partial products and combines softmax statistics over
"model" in another order. The reference runs in a subprocess with four
forced host devices, its decode step jitted with the dry-run's in- and
out-shardings (``repro/launch/dryrun.py``); its parameters reach the port
through ``models/convert.py``.
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
PROMPT, STEPS, BATCH, PREFILL_SEQ = 4, 8, 4, 32
# hymba-1.5b as published puts 25 query and 5 KV heads on a model axis of
# 2, which divides neither: the reduced config keeps that (5 heads of 5)
HYMBA5 = dict(n_heads=5, n_kv_heads=5, d_model=80)
RING = dict(window=16)
RING_STEPS = 24
# (case id, arch, mesh, rule set, reduced() overrides, decode steps)
CASES = tuple(
    (f"{arch}-{rules}-{'x'.join(map(str, mesh))}", arch, mesh, rules, {},
     STEPS)
    for arch in ("qwen2.5-3b", "hymba-1.5b", "falcon-mamba-7b",
                 "olmoe-1b-7b", "deepseek-v2-lite-16b", "llava-next-34b")
    for mesh in ((2, 2), (4, 1))
    if mesh == (2, 2) or arch in ("qwen2.5-3b", "hymba-1.5b")
    for rules in ("default", "serving", "long")) + tuple(
    (f"hymba5-{rules}", "hymba-1.5b", (2, 2), rules, HYMBA5, STEPS)
    for rules in ("default", "serving", "long")) + tuple(
    (f"hymba-ring-{rules}", "hymba-1.5b", (2, 2), rules, RING, RING_STEPS)
    for rules in ("default", "serving")) + tuple(
    (f"olmoe-1b-7b-default-{'x'.join(map(str, mesh))}", "olmoe-1b-7b", mesh,
     "default", {}, STEPS) for mesh in ((4, 1), (2, 2, 1)))
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
# which layout each attention's decode takes on (2, 2) (the cache's dim
# split over "model": 2 heads, 3 head dim, 1 slots, None whole)
CACHE_DIMS = {"qwen2.5-3b-default-2x2": [2], "qwen2.5-3b-serving-2x2": [1],
              "qwen2.5-3b-long-2x2": [2], "hymba5-default": [3],
              "hymba5-serving": [1], "hymba5-long": [3],
              "hymba-ring-serving": [1], "qwen2.5-3b-default-4x1": [None]}
# the reference's sharded decode: (arch, reduced() overrides, rule set)
REF_CASES = (("qwen2.5-3b", {}, "default"), ("qwen2.5-3b", {}, "serving"),
             ("hymba-1.5b", HYMBA5, "default"),
             ("hymba-1.5b", HYMBA5, "serving"))
REF_STEPS = 4

REFERENCE = r'''
import os, sys, json, functools
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(ROOT, "src"))
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import Model, reduced
from repro.sharding import (DEFAULT_RULES, SERVING_RULES, logical_axis_rules,
                            param_specs, cache_specs, batch_specs)
from repro.utils.jaxcompat import make_auto_mesh
from repro_torch.models.convert import cache_arrays, flatten_reference

RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES}
mesh = make_auto_mesh((2, 2), ("data", "model"))


def nm(tree):
    return jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s), tree)


out = {}
for i, (arch, over, rules_name) in enumerate(REF_CASES):
    rules = RULES[rules_name]
    cfg = reduced(get_config(arch), dtype="float32", **over)
    model = Model(cfg)
    params = model.init_params(jax.random.PRNGKey(i))
    tok = np.random.default_rng(i).integers(
        0, cfg.vocab_size, (BATCH, REF_STEPS)).astype(np.int32)
    tag = f"{arch}-{rules_name}"
    np.savez(os.path.join(TMP, f"{tag}-params.npz"),
             **flatten_reference(jax.tree.map(np.asarray, params)))
    np.save(os.path.join(TMP, f"{tag}-tokens.npy"), tok)
    try:
        with mesh, logical_axis_rules(mesh, rules):
            cache = model.init_cache(BATCH, REF_STEPS)
            c_specs = cache_specs(cache, mesh, rules)
            p_sh = nm(param_specs(params, mesh, rules))
            c_sh = nm(c_specs)
            t_sh = nm(batch_specs({"tokens": jnp.asarray(tok[:, :1])}, mesh,
                                  rules))["tokens"]
            step = jax.jit(model.decode_step,
                           in_shardings=(p_sh, c_sh, t_sh, None),
                           out_shardings=(None, c_sh))
            p = jax.device_put(params, p_sh)
            cache = jax.device_put(cache, c_sh)
            logits = []
            for t in range(REF_STEPS):
                lg, cache = step(p, cache, jnp.asarray(tok[:, t:t + 1]),
                                 jnp.asarray(t, jnp.int32))
                logits.append(np.asarray(lg, np.float32))
        np.save(os.path.join(TMP, f"{tag}-logits.npy"), np.stack(logits))
        np.savez(os.path.join(TMP, f"{tag}-cache.npz"),
                 **cache_arrays(jax.tree.map(np.asarray, cache)))
        out[tag] = {"sharded": True,
                    "cache_sharded": str(cache["scan"]["k"].sharding.spec)}
    except Exception as e:   # recorded: the port is then held to one device
        out[tag] = {"sharded": False, "error": repr(e)[:500]}
with open(os.path.join(TMP, "ref.json"), "w") as f:
    json.dump(out, f)
'''

WORLD = r'''
import json, os, time
import numpy as np
import torch
import torch.distributed as dist
import repro_torch.models.layers as L
import repro_torch.models.moe as MOE
import repro_torch.sharding.spmd as SP
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.serve import generate, main as serve_main
from repro_torch.models import Model, reduced
from repro_torch.models.convert import cache_arrays, load_reference_params
from repro_torch.models.inputs import ShapeSpec, make_inputs
from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                  SERVING_RULES)
from repro_torch.sharding.annotate import placements
from repro_torch.sharding.rules import (cache_specs, distribute_batch,
                                        distribute_params, param_specs)
from repro_torch.sharding.spmd import full_value, local_shape

torch.set_num_threads(1)
RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES,
         "long": LONG_CONTEXT_RULES}
meshes = {(2, 2): make_device_mesh((2, 2), device_type="cpu"),
          (4, 1): make_device_mesh((4, 1), device_type="cpu"),
          (2, 2, 1): make_device_mesh((2, 2, 1), ("pod", "data", "model"),
                                      device_type="cpu")}
out = {}

# every decode attention's cache layout, every parameter a decode step
# gathers over "model" (recorded by the data pointer of its local shard),
# the experts each top-k of a decode step picks (one device's and the
# mesh's), and every all-gather of a meshed decode step's MoE layer (its
# group's ranks, its output's elements)
seen = {"cache_dims": [], "gathered": [], "on": False, "mode": None,
        "one": [], "mesh": [], "moe": False, "moe_gathers": []}
real_attn, real_whole = L.decode_attention, SP._WholeParam.forward
real_top_k, real_gather = MOE._top_k, dist.all_gather_into_tensor
real_parts, real_ffn = MOE.moe_parts, MOE.moe_ffn


def attn_spy(*a, cache_dim=None, **k):
    if seen["on"]:
        seen["cache_dims"].append(cache_dim)
    return real_attn(*a, cache_dim=cache_dim, **k)


def whole_spy(ctx, local, mesh, layout, rows, keep=None):
    m = mesh.mesh_dim_names.index("model")
    if seen["on"] and isinstance(layout[m], Shard) and keep != m \
            and mesh.size(m) > 1:
        seen["gathered"].append(local.data_ptr())
    return real_whole(ctx, local, mesh, layout, rows, keep)


def top_k_spy(probs, k):
    vals, idx = real_top_k(probs, k)
    if seen["mode"]:
        seen[seen["mode"]].append(idx.tolist())
    return vals, idx


def gather_spy(out_t, t, group=None, **kw):
    if seen["on"] and seen["moe"]:
        seen["moe_gathers"].append([dist.get_process_group_ranks(group),
                                    out_t.numel()])
    return real_gather(out_t, t, group=group, **kw)


def in_moe(fn):
    def run(*a, **k):
        seen["moe"] = True
        try:
            return fn(*a, **k)
        finally:
            seen["moe"] = False
    return run


L.decode_attention = attn_spy
SP._WholeParam.forward = staticmethod(whole_spy)
MOE._top_k = top_k_spy
dist.all_gather_into_tensor = gather_spy
MOE.moe_parts, MOE.moe_ffn = in_moe(real_parts), in_moe(real_ffn)


def close(a, b):
    return bool(torch.allclose(a, b, **TOL))


def err(a, b):
    return float((a - b).abs().max())


def run_case(arch, sizes, rules_name, over, steps):
    mesh, rules = meshes[tuple(sizes)], RULES[rules_name]
    cfg = reduced(get_config(arch), dtype="float32", **over)
    b = 1 if rules_name == "long" else BATCH
    one = Model(cfg, seed=0, device="cpu")
    model = distribute_params(Model(cfg, seed=0, device="cpu"), mesh, rules)
    rec = {"serving_repeats_over_data": all(
        p.placements[0] == Replicate() for p in model.parameters())}
    names = {p.to_local().data_ptr(): k for k, p in model.named_parameters()}

    # prefill
    batch = make_inputs(cfg, ShapeSpec("p", PREFILL_SEQ, b, "prefill"),
                        seed=1, device="cpu")
    placed = distribute_batch(batch, mesh, rules)
    tokens, placed_tokens = batch.pop("tokens"), placed.pop("tokens")
    want = one.prefill(tokens, extra=batch)
    got = model.prefill(placed_tokens, extra=placed, rules=rules)
    rec["prefill"] = [err(full_value(got), want),
                      close(full_value(got), want)]
    rec["prefill_layout"] = [str(p) for p in got.placements]

    # decode steps, each on its own greedy tokens
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (b, PROMPT))
    c1 = one.init_cache(b, PROMPT + steps)
    c2 = model.init_cache(b, PROMPT + steps, rules=rules)
    specs = cache_specs(c1, mesh, rules)
    rec["cache_shapes"] = all(
        tuple(c2[g][k].to_local().shape) == local_shape(
            c1[g][k].shape, mesh, placements(specs[g][k], mesh))
        for g in ("scan",) for k in c1["scan"])
    errs, same, t1, t2 = [], True, None, None
    for k in ("cache_dims", "gathered", "one", "mesh", "moe_gathers"):
        seen[k].clear()
    for t in range(PROMPT + steps):
        col = torch.as_tensor(prompts[:, t:t + 1]) if t < PROMPT else None
        seen["mode"] = "one"
        l1, _ = one.decode_step(c1, col if t1 is None else t1[:, None], t)
        tok2 = col if t2 is None else t2[:, None]
        seen.update(on=True, mode="mesh")
        l2, _ = model.decode_step(c2, distribute_batch(
            {"tokens": tok2}, mesh, rules)["tokens"], t, rules=rules)
        seen.update(on=False, mode=None)
        l2 = full_value(l2)
        if t >= PROMPT - 1:
            errs.append([err(l2, l1), close(l2, l1)])
            t1, t2 = l1[:, -1].argmax(-1), l2[:, -1].argmax(-1)
            same = same and torch.equal(t1, t2)
    rec["decode"] = errs
    rec["decode_greedy_equal"] = same
    rec["cache_dims"] = sorted(set(seen["cache_dims"]),
                               key=lambda d: -1 if d is None else d)
    rec["gathered_over_model"] = sorted({names.get(p, "?")
                                         for p in seen["gathered"]})
    # the top-k choices, and the elements of each all-gather over a data
    # axis in the MoE layer against those of the tokens' activation
    # [b, 1, d_model] and its output columns (over "data" inside "pod",
    # the pod's half of them)
    rec["experts"] = [seen["one"] == seen["mesh"], len(seen["mesh"])]
    data = [dist.get_process_group_ranks(mesh.get_group(n))
            for n in mesh.mesh_dim_names if n != "model"]
    rec["moe_data_gathers"] = sorted({n for g, n in seen["moe_gathers"]
                                      if g in data})
    rec["want_moe_gathers"] = sorted({b * cfg.d_model, b * cfg.d_model //
                                      mesh.size(0) ** (len(data) - 1)})
    a1, a2 = cache_arrays(c1), cache_arrays(c2)
    rec["cache"] = [max(float(np.abs(a2[k] - a1[k]).max()) for k in a1),
                    all(np.allclose(a2[k], a1[k], **TOL) for k in a1)]

    if steps != STEPS:      # the ring's long run: its decode steps only
        return rec
    # generate: greedy tokens, and temperature draws on every rank
    g1 = generate(one, prompts, steps)
    g2 = generate(model, prompts, steps, mesh=mesh, rules=rules)
    rec["generate_equal"] = bool((g1 == g2).all())
    draw = generate(model, prompts, 2, temperature=1.0, seed=5, mesh=mesh,
                    rules=rules)
    draws = [None] * dist.get_world_size()
    dist.all_gather_object(draws, draw.tolist())
    rec["draws_agree"] = all(d == draws[0] for d in draws)
    return rec


for case_id, arch, sizes, rules_name, over, steps in CASES:
    out[case_id] = run_case(arch, sizes, rules_name, over, steps)


# -- a MoE decode step under a data split routes one device's group --
cfg = reduced(get_config("olmoe-1b-7b"), dtype="float32", capacity_factor=0.5)
p = Model(cfg, seed=0, device="cpu").blocks[0].mlp.tree()
x = torch.randn(16, 1, cfg.d_model, generator=torch.Generator().manual_seed(4))
with torch.no_grad():
    want, _ = MOE.moe_ffn(p, cfg, x)
    with SP.spmd(meshes[(2, 2)], 16, DEFAULT_RULES):
        rows, want_rows = SP.take_rows(x), SP.take_rows(want)
        got, _ = MOE.moe_ffn(p, cfg, rows)
    alone, _ = MOE.moe_ffn(p, cfg, rows)      # the rows as a group of their own
flags = [None] * dist.get_world_size()
dist.all_gather_object(flags, [bool(torch.equal(got, want_rows)),
                               not torch.allclose(alone, want_rows)])
# the second data rank's tokens queue behind the first's in one group
out["moe_rows"] = {"equal": all(f[0] for f in flags),
                   "alone_differs": any(f[1] for f in flags)}

# the same tokens with the parameters placed by DEFAULT_RULES and taken
# through the meshed moe_parts of a decode step: each leaf keeps its data
# shard of d_model, and the router's logits and the experts' hidden units
# are summed over "data"
placed = distribute_params(Model(cfg, seed=0, device="cpu"), meshes[(2, 2)],
                           DEFAULT_RULES).blocks[0].mlp.tree()
for k in ("one", "mesh"):
    seen[k].clear()
with torch.no_grad():
    seen["mode"] = "one"
    MOE.moe_ffn(p, cfg, x)
    with SP.spmd(meshes[(2, 2)], 16, DEFAULT_RULES):
        parts, split = MOE.moe_parts(placed, decode=True,
                                     gathered=MOE.gathers_rows(cfg, 8))
        seen["mode"] = "mesh"
        got, _ = MOE.moe_ffn(parts, cfg, rows, split["shared"],
                             split["experts"])
    seen["mode"] = None
flags = [None] * dist.get_world_size()
dist.all_gather_object(flags, [
    bool(torch.allclose(got, want_rows, **TOL)),
    seen["one"] == seen["mesh"] and len(seen["mesh"]) > 0,
    list(parts["wi"].shape) == [cfg.n_experts // 2, cfg.d_model // 2,
                                cfg.moe_d_ff]])
out["moe_parts_rows"] = {"close": all(f[0] for f in flags),
                         "experts_equal": all(f[1] for f in flags),
                         "data_shards": all(f[2] for f in flags)}


# -- the reference's sharded decode, carried across (its subprocess runs
# beside this world; its files are complete once "done" exists) --
deadline = time.monotonic() + 600
while not os.path.exists(os.path.join(TMP, "done")):
    if time.monotonic() > deadline:
        raise TimeoutError("the reference's subprocess never finished")
    time.sleep(0.2)
with open(os.path.join(TMP, "ref.json")) as f:
    ref = json.load(f)
for arch, over, rules_name in REF_CASES:
    tag = f"{arch}-{rules_name}"
    cfg = reduced(get_config(arch), dtype="float32", **over)
    model = Model(cfg, seed=0, device="cpu")
    # the file holds the port's names, a tree of one level
    load_reference_params(model, dict(np.load(
        os.path.join(TMP, f"{tag}-params.npz"))))
    distribute_params(model, meshes[(2, 2)], RULES[rules_name])
    tok = torch.as_tensor(np.load(os.path.join(TMP, f"{tag}-tokens.npy")),
                          dtype=torch.int64)
    cache = model.init_cache(BATCH, REF_STEPS, rules=RULES[rules_name])
    logits = []
    for t in range(REF_STEPS):
        lg, _ = model.decode_step(cache, distribute_batch(
            {"tokens": tok[:, t:t + 1]}, meshes[(2, 2)],
            RULES[rules_name])["tokens"], t, rules=RULES[rules_name])
        logits.append(full_value(lg).numpy())
    rec = {"sharded": ref[tag]["sharded"], "logits": np.stack(
        logits).tolist()}
    if ref[tag]["sharded"]:
        rc = dict(np.load(os.path.join(TMP, f"{tag}-cache.npz")))
        mine = cache_arrays(cache)
        rec["cache"] = max(float(np.abs(mine[k] - rc[k]).max()) for k in rc)
    out["ref_" + tag] = rec


# -- main under a 4-rank process group: the host mesh (4, 1) --
cfg = reduced(get_config("qwen2.5-3b"))
got = serve_main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                  "--batch", "4", "--prompt-len", "4", "--max-new", "6"])
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 4))
out["main"] = {"equal": bool((got == generate(
    Model(cfg, seed=0, device="cpu"), prompts, 6)).all()),
    "shape": list(got.shape)}

if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


@pytest.fixture(scope="module")
def reference_and_world(tmp_path_factory):
    """(the reference's directory, its ref.json, the world's findings):
    the reference's subprocess runs beside the world, which reads its
    files last."""
    tmp = str(tmp_path_factory.mktemp("mesh_serve"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    head = f"ROOT = {ROOT!r}\nTMP = {tmp!r}\nBATCH = {BATCH!r}\n" \
           f"REF_STEPS = {REF_STEPS!r}\nREF_CASES = {REF_CASES!r}\n"
    body = "try:\n    exec(compile(REFERENCE_SRC, '<reference>', 'exec'))\n" \
           "finally:\n    open(os.path.join(TMP, 'done'), 'w').close()\n"
    # its output goes to a file: a full pipe would stall it while the
    # world waits for its files
    log = os.path.join(tmp, "reference.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", head + "import os\n" +
             f"REFERENCE_SRC = {REFERENCE!r}\n" + body], env=env,
            stdout=out, stderr=subprocess.STDOUT)
    try:
        found = run_world(WORLD, TMP=tmp, TOL=TOL, PROMPT=PROMPT,
                          BATCH=BATCH, PREFILL_SEQ=PREFILL_SEQ, CASES=CASES,
                          STEPS=STEPS, REF_CASES=REF_CASES,
                          REF_STEPS=REF_STEPS)
        proc.wait(timeout=600)
        with open(log) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(tmp, "ref.json")) as f:
        return tmp, json.load(f), found


@pytest.fixture(scope="module")
def world(reference_and_world):
    return reference_and_world[2]


IDS = [c[0] for c in CASES]


MESHES = {c[0]: c[2] for c in CASES}


@pytest.mark.parametrize("case", IDS)
def test_meshed_prefill_matches_one_device(world, case):
    got = world[case]
    assert got["prefill"][1], got["prefill"]
    # split by rows where the rules split the batch, whole over "model"
    assert got["prefill_layout"] == ["R" if "-long" in case else "S(0)"] * (
        len(MESHES[case]) - 1) + ["R"]


@pytest.mark.parametrize("case", IDS)
def test_meshed_decode_steps_match_one_device(world, case):
    got = world[case]
    assert all(ok for _, ok in got["decode"]), got["decode"]
    assert got["decode_greedy_equal"]
    assert got.get("generate_equal", "ring" in case)


@pytest.mark.parametrize("case", IDS)
def test_meshed_cache_has_its_specs_local_shapes_and_gathers_back(world,
                                                                  case):
    got = world[case]
    assert got["cache_shapes"]
    assert got["cache"][1], got["cache"]


@pytest.mark.parametrize("case", [c for c in IDS if "ring" not in c])
def test_temperature_draws_agree_on_every_rank(world, case):
    """Every model rank of a data group draws the same tokens (the ranks'
    gathered rows are the same on all four)."""
    assert world[case]["draws_agree"]


@pytest.mark.parametrize("case", sorted(CACHE_DIMS))
def test_decode_attention_takes_the_layout_of_its_cache(world, case):
    """Head-parallel where the KV heads divide "model", the head-dim
    fallback where they do not (hymba's 5 heads), the slots under
    ``SERVING_RULES``, the whole cache on a model axis of 1."""
    assert world[case]["cache_dims"] == CACHE_DIMS[case]


@pytest.mark.parametrize("case", [c for c in IDS if "-serving" in c])
def test_serving_decode_gathers_no_parameter_split_over_model(world, case):
    """Under ``SERVING_RULES`` the parameters are repeated over "data"
    (fsdp -> None) and a decode step gathers none of those split over
    "model": MLA's heads and the routed experts included."""
    got = world[case]
    assert got["serving_repeats_over_data"]
    assert got["gathered_over_model"] == [], got["gathered_over_model"]


@pytest.mark.parametrize("arch,over,rules", REF_CASES,
                         ids=[f"{a}-{r}" for a, _, r in REF_CASES])
def test_meshed_decode_matches_the_reference_sharded_decode(
        reference_and_world, arch, over, rules):
    tmp, ref, world = reference_and_world
    tag = f"{arch}-{rules}"
    assert ref[tag]["sharded"], ref[tag]
    got = world["ref_" + tag]
    want = np.load(os.path.join(tmp, f"{tag}-logits.npy"))
    np.testing.assert_allclose(np.asarray(got["logits"]), want, **TOL)
    assert got["cache"] <= TOL["atol"]


def test_moe_decode_under_a_data_split_drops_what_one_device_drops(world):
    """A rank's 8 of 16 decode tokens are fewer than one device's group of
    16: routed as a group of their own, the second data rank's tokens
    would not queue behind the first's and other tokens would be dropped
    (the outputs differ); gathered over "data" every rank gets one
    device's rows bit for bit."""
    assert world["moe_rows"] == {"equal": True, "alone_differs": True}


def test_moe_decode_on_the_meshed_parts_drops_what_one_device_drops(world):
    """The same 8 of 16 tokens a rank, with the layer's parameters taken
    through ``moe_parts(..., decode=True)`` under ``DEFAULT_RULES``: each
    leaf keeps its data shard of ``d_model`` (the router's logits and the
    experts' hidden units summed over "data" in another order), every
    top-k choice is one device's and the output is one device's rows
    within 1e-5, the tokens that overflow one device's capacity dropped
    as there."""
    assert world["moe_parts_rows"] == {"close": True, "experts_equal": True,
                                       "data_shards": True}


MOE_IDS = [c[0] for c in CASES if c[1] in MOE_ARCHS]


@pytest.mark.parametrize("case", MOE_IDS)
def test_meshed_moe_decode_picks_one_devices_experts(world, case):
    """Every top-k choice of every decode step equals one device's: the
    gathered tokens are routed whole, from the router's data shards
    summed over "data" under ``DEFAULT_RULES``."""
    equal, calls = world[case]["experts"]
    assert equal and calls > 0


@pytest.mark.parametrize("case", MOE_IDS)
def test_meshed_moe_decode_gathers_no_moe_leaf_over_data(world, case):
    """In a decode step's MoE layer every all-gather over a data axis is
    the tokens' activation ([b, 1, d_model]) or the output columns (over
    "data" inside "pod", the pod's half of either): no router, routed
    expert or shared expert leaf is gathered there."""
    assert world[case]["moe_data_gathers"] == \
        world[case]["want_moe_gathers"]


def test_main_serves_on_the_host_mesh_under_a_process_group(world):
    assert world["main"] == {"equal": True, "shape": [4, 6]}
