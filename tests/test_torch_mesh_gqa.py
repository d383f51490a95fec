"""A meshed attention split by its query heads where the key-value
projections stay whole over "model" (``src/repro_torch``): the KV heads do
not divide the model axis (qwen2.5-3b's 2 on 4 ranks) or
``SERVING_RULES`` keeps ``wk`` / ``wv`` whole. Each model rank projects K
and V whole and attends with its own query heads, as the reference's
partitioned program does (``models.layers.split_queries``).

Every meshed check runs in one spawned world of 4 gloo ranks on "cpu"
meshes (1, 4) and (2, 2) ("data", "model") at ``reduced(cfg,
dtype="float32")`` with random attention biases; rank 0 prints the world's
findings as one JSON line. Prefill logits, a train step's loss and
gradient norm and every gradient leaf are held within 1e-5 of one device
(a leaf relative to its largest magnitude or, where its gradient is
rounding noise on both sides, a key bias, to 1e-3 of the model's largest
gradient). The cases: qwen2.5-3b under ``DEFAULT_RULES`` and
``SERVING_RULES``, codeqwen1.5-7b's prefill and whisper-medium's (the
encoder and the cross-attention) under ``SERVING_RULES``, and 12 query
heads on 3 KV heads, where a rank's heads straddle two groups.

The same world counts a new-path step of ranks 0, 1 and 3 with the
dry-run's counter; each count must equal exactly that rank's meta count
in a counting world (``launch.mesh.counting_world``). In the main process
the dry-run's per-device FLOPs of rank 0 are held beside the reference's
partitioned program (a subprocess compiling it on 8 forced host devices,
read with ``repro.utils.hlo_cost.analyze``): the prefills equal, the train
step on (1, 4) within 1.05x, and the whole gap on one device one
recomputed unembedding product.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import repro_torch.core  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import counting_world  # noqa: E402
from repro_torch.models import ShapeSpec, reduced  # noqa: E402
from repro_torch.sharding import (DEFAULT_RULES, SERVING_RULES,  # noqa: E402
                                  MeshShape)
from test_torch_mesh_train import run_world  # noqa: E402

TOL = 1e-5
BATCH, SEQ = 4, 32
RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES}
# 12 query heads on 3 KV heads: on 4 ranks rank 1's heads 3, 4, 5 meet KV
# heads 0, 1, 1 (on 2 ranks, rank 0's six heads meet 0, 0, 0, 0, 1, 1)
STRADDLE = dict(n_heads=12, n_kv_heads=3)
# (case id, arch, reduced() overrides, mesh, rule set, train too)
CASES = tuple(
    (f"qwen-{r}-{'x'.join(map(str, m))}", "qwen2.5-3b", {}, m, r, True)
    for r in ("default", "serving") for m in ((1, 4), (2, 2))) + tuple(
    (f"codeqwen-serving-{'x'.join(map(str, m))}", "codeqwen1.5-7b", {}, m,
     "serving", False) for m in ((1, 4), (2, 2))) + tuple(
    (f"whisper-serving-{'x'.join(map(str, m))}", "whisper-medium", {}, m,
     "serving", True) for m in ((1, 4), (2, 2))) + tuple(
    (f"straddle-default-{'x'.join(map(str, m))}", "qwen2.5-3b", STRADDLE, m,
     "default", True) for m in ((1, 4), (2, 2)))
# the attention's form in each case: "queries" (query heads split, K/V
# whole), "heads" (every head leaf split: qwen's 2 KV heads on 2 ranks)
FORMS = {c[0]: "queries" for c in CASES}
FORMS["qwen-default-2x2"] = "heads"
# the new path's steps each rank of a (1, 4) world counts: (case, arch,
# reduced() overrides, rule set, step kind)
COUNT_CASES = (("qwen-serving-prefill", "qwen2.5-3b", {}, "serving",
                "prefill"),
               ("qwen-default-train", "qwen2.5-3b", {}, "default", "train"),
               ("straddle-default-prefill", "qwen2.5-3b", STRADDLE,
                "default", "prefill"))
COUNT_RANKS = (0, 1, 3)
COUNT_MESH = (1, 4)

WORLD = r'''
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
import repro_torch.core
import repro_torch.models.layers as L
import repro_torch.models.model as MM
import repro_torch.sharding.spmd as SP
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.train import build_state
from repro_torch.models import Model, ShapeSpec, reduced
from repro_torch.models.inputs import make_inputs
from repro_torch.sharding import DEFAULT_RULES, SERVING_RULES
from repro_torch.sharding.rules import distribute_batch, distribute_params
from repro_torch.sharding.spmd import full_value
from repro_torch.train import OptConfig, make_train_step, place_train_state

torch.set_num_threads(1)
RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES}
meshes = {tuple(m): make_device_mesh(tuple(m), device_type="cpu")
          for m in ((1, 4), (2, 2))}
out = {}

# the attention's forms, the KV heads each rank's queries meet, and every
# leaf split over "model" that a forward gathers over "model"
seen = {"on": False, "forms": [], "kv": [], "gathered": []}
real_whole, real_kv = SP._WholeParam.forward, L.rank_kv_heads


def whole_spy(ctx, local, mesh_, layout, rows, keep=None):
    m = mesh_.mesh_dim_names.index("model")
    if seen["on"] and isinstance(layout[m], Shard) and keep != m \
            and mesh_.size(m) > 1:
        seen["gathered"].append(local.data_ptr())
    return real_whole(ctx, local, mesh_, layout, rows, keep)


def kv_spy(k, v, n_heads, dim=2):
    got = real_kv(k, v, n_heads, dim)
    if seen["on"]:
        seen["kv"].append([k.shape[dim], got[0].shape[dim]])
    return got


SP._WholeParam.forward = staticmethod(whole_spy)
L.rank_kv_heads = kv_spy


def form_spy(module, name):
    real = getattr(module, name)

    def wrapped(*a, split=False, **k):
        if seen["on"]:
            seen["forms"].append(
                "queries" if isinstance(split, tuple) else
                "heads" if split else "whole")
        return real(*a, split=split, **k)
    setattr(module, name, wrapped)


form_spy(L, "attention")
form_spy(MM, "_cross_attention")


def model_of(cfg, mesh=None, rules=DEFAULT_RULES):
    """the model at seed 0 with seeded random attention biases (the same on
    every rank), placed on ``mesh`` by ``rules``"""
    model = Model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model if mesh is None else distribute_params(model, mesh, rules)


def grads(model, batch):
    names, leaves = zip(*model.named_parameters())
    loss, _ = model.loss(batch)
    own = loss.to_local() if isinstance(loss, DTensor) else loss
    g = torch.autograd.grad(own, leaves)
    return {n: full_value(t) for n, t in zip(names, g)}


def held(case, arch, over, sizes, rules_name, train):
    cfg = reduced(get_config(arch), dtype="float32", **over)
    mesh, rules = meshes[tuple(sizes)], RULES[rules_name]
    batch = make_inputs(cfg, ShapeSpec("t", SEQ, BATCH, "train"), seed=3,
                        device="cpu")
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    one, meshed = model_of(cfg), model_of(cfg, mesh, rules)
    names = {p.to_local().data_ptr(): k for k, p in meshed.named_parameters()}
    rec = {}
    with torch.no_grad():
        want = one.prefill(batch["tokens"], extra=extra)
        seen.update(on=True, forms=[], kv=[], gathered=[])
        placed = distribute_batch(batch, mesh, rules)
        got = full_value(meshed.prefill(
            placed["tokens"], rules=rules,
            extra={k: placed[k] for k in extra}))
        seen["on"] = False
    rec["prefill_err"] = float((got - want).abs().max())
    rec["prefill_scale"] = float(want.abs().max())
    rec["forms"] = sorted(set(seen["forms"]))
    every = [None] * world
    dist.all_gather_object(every, sorted({tuple(x) for x in seen["kv"]}))
    rec["kv"] = every
    gathered = set(seen["gathered"])
    if train:
        g1 = grads(one, batch)
        seen.update(on=True, gathered=[])
        g2 = grads(meshed, distribute_batch(batch, mesh, rules))
        seen["on"] = False
        gathered |= set(seen["gathered"])
        top = max(float(g.abs().max()) for g in g1.values())
        errs = {}
        for k in g1:
            scale = max(float(g1[k].abs().max()), 1e-3 * top)
            errs[k] = float((g2[k] - g1[k]).abs().max()) / scale
        rec["grad_errs"] = errs
        ocfg = OptConfig(learning_rate=5e-5, warmup_steps=1, decay_steps=10)
        metrics = []
        for model, on in ((one, None), (meshed, mesh)):
            state = build_state(model, "adamw")
            if on is not None:
                state = place_train_state(state, on, rules)
            b = batch if on is None else distribute_batch(batch, on, rules)
            _, mt = make_train_step(model, ocfg, "adamw")(state, b)
            metrics.append([float(mt["loss"]), float(mt["grad_norm"])])
        rec["step"] = metrics
    rec["gathered_over_model"] = sorted({names.get(p, "?") for p in gathered})
    return rec


for case in CASES:
    out[case[0]] = held(*case)

# each rank's count of a new-path step, as the dry-run counts it
counts = {}
for case, arch, over, rules_name, kind in COUNT_CASES:
    cfg = reduced(get_config(arch), **over)
    rows = 8 if kind == "train" else 4
    fn, inputs = D.step_program(
        cfg, ShapeSpec(kind, 64, rows, kind), 2 if kind == "train" else 1,
        mesh=meshes[tuple(COUNT_MESH)], rules=RULES[rules_name],
        device="cpu")
    c = D.trace_counts(fn, inputs)
    every = [None] * world
    dist.all_gather_object(every, c)
    counts[case] = {str(r): every[r] for r in COUNT_RANKS}
out["counts"] = counts
if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


def _meta_count(case: str, rank: int) -> dict:
    _, arch, over, rules_name, kind = next(c for c in COUNT_CASES
                                           if c[0] == case)
    cfg = reduced(get_config(arch), **over)
    rows = 8 if kind == "train" else 4
    with counting_world(MeshShape(("data", "model"), COUNT_MESH),
                        rank) as m:
        fn, inputs = D.step_program(
            cfg, ShapeSpec(kind, 64, rows, kind),
            2 if kind == "train" else 1, mesh=m, rules=RULES[rules_name])
        return D.trace_counts(fn, inputs)


@pytest.fixture(scope="module")
def world():
    """The world's findings, and each counted step's meta counts, taken
    in this process while the world runs."""
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_world, WORLD, CASES=CASES, SEQ=SEQ,
                              BATCH=BATCH, COUNT_CASES=COUNT_CASES,
                              COUNT_RANKS=COUNT_RANKS, COUNT_MESH=COUNT_MESH)
        meta = {(c[0], r): _meta_count(c[0], r) for c in COUNT_CASES
                for r in COUNT_RANKS}
        found = running.result()
    found["meta"] = meta
    return found


def _counted(c: dict) -> dict:
    """FLOPs, op bytes, argument bytes and the collectives (peaks left
    out: gloo's own buffers)."""
    return {k: v for k, v in c.items() if not k.startswith("peak/")}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_meshed_prefill_matches_one_device(world, case):
    rec = world[case]
    assert rec["prefill_err"] <= TOL * max(rec["prefill_scale"], 1.0)


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[5]])
def test_meshed_train_step_and_gradients_match_one_device(world, case):
    """The loss and gradient norm of an AdamW step, and every gradient
    leaf (the attention's ``wq``, ``wk``, ``wv``, ``bq``, ``bk``, ``bv``
    and ``wo`` among them) within 1e-5 of one device."""
    rec = world[case]
    (l1, g1), (l2, g2) = rec["step"]
    assert l2 == pytest.approx(l1, rel=TOL)
    assert g2 == pytest.approx(g1, rel=TOL)
    worst = max(rec["grad_errs"], key=rec["grad_errs"].get)
    assert rec["grad_errs"][worst] <= TOL, worst
    attn = {k.rsplit(".", 1)[-1] for k in rec["grad_errs"]
            if ".attn." in k or ".cross." in k}
    assert {"wq", "wk", "wv", "wo"} <= attn


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_the_attention_takes_the_form_its_layout_gives(world, case):
    """Query heads split where the K/V projections are whole over "model"
    (no fallback to the whole attention), every head leaf split where the
    KV heads divide the axis; no leaf the rules split over "model" is
    gathered there."""
    assert world[case]["forms"] == [FORMS[case]]
    assert world[case]["gathered_over_model"] == []


@pytest.mark.parametrize("case,want", [
    # 2 KV heads, a query head a rank: each rank's own KV head
    ("qwen-default-1x4", [[[2, 1]]] * 4),
    ("qwen-serving-1x4", [[[2, 1]]] * 4),
    # 4 KV heads whole (SERVING_RULES), 2 query heads a rank on 2 ranks
    ("codeqwen-serving-2x2", [[[4, 2]]] * 4),
    # 3 KV heads of 12 query heads: ranks 0 and 3 slice one, ranks 1 and 2
    # (heads 3-5 meet KV heads 0, 1, 1; heads 6-8 meet 1, 1, 2) gather one
    # a query head
    ("straddle-default-1x4", [[[3, 1]], [[3, 3]], [[3, 3]], [[3, 1]]]),
    # on 2 model ranks each rank's six heads straddle two groups
    ("straddle-default-2x2", [[[3, 6]]] * 4)])
def test_each_query_head_meets_its_own_kv_head(world, case, want):
    """The KV heads each rank's queries meet ([whole, taken], rank by
    rank): a slice where each serves an equal run of the rank's heads,
    else one gathered a query head; the logits and gradients above hold
    the pairing."""
    assert world[case]["kv"] == want


@pytest.mark.parametrize("case", [c[0] for c in COUNT_CASES])
def test_a_real_new_path_rank_counts_what_its_meta_count_says(world, case):
    for rank in COUNT_RANKS:
        real = world["counts"][case][str(rank)]
        meta = world["meta"][(case, rank)]
        assert _counted(real) == _counted(meta), rank
        assert real["flops"] > 0


REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join({root!r}, "src"))
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import Model, ShapeSpec, reduced, token_spec
    from repro.sharding import (DEFAULT_RULES, SERVING_RULES,
                                logical_axis_rules, param_specs)
    from repro.sharding.rules import batch_specs
    from repro.train import adamw_init, make_train_step
    from repro.train.optimizer import OptConfig
    from repro.train.state import train_state_specs
    from repro.utils.hlo_cost import analyze
    from repro.utils.jaxcompat import make_auto_mesh

    RULES = {{"default": DEFAULT_RULES, "serving": SERVING_RULES}}
    out = {{}}
    for key, arch, kind, sizes, rules_name, seq, rows, over in {cells!r}:
        n = sizes[0] * sizes[1]
        mesh = make_auto_mesh(tuple(sizes), ("data", "model"),
                              devices=jax.devices()[:n])
        nm = lambda t: jax.tree.map(
            lambda s: jax.sharding.NamedSharding(mesh, s), t)
        cfg = reduced(get_config(arch)).replace(**over)
        model, rules = Model(cfg), RULES[rules_name]
        spec = ShapeSpec(kind, seq, rows, kind)
        with mesh, logical_axis_rules(mesh, rules):
            batch = token_spec(cfg, spec)
            b_sh = nm(batch_specs(batch, mesh, rules))
            if kind == "train":
                state = jax.eval_shape(
                    lambda k: {{"params": model.init_params(k),
                               "opt": adamw_init(jax.eval_shape(
                                   model.init_params, k)),
                               "step": jnp.zeros((), jnp.int32)}},
                    jax.random.PRNGKey(0))
                st = nm(train_state_specs(state, mesh, rules))
                step = make_train_step(model, OptConfig(), accum_steps=2)
                low = jax.jit(step, in_shardings=(st, b_sh),
                              out_shardings=(st, None)).lower(state, batch)
            else:
                params = jax.eval_shape(model.init_params,
                                        jax.random.PRNGKey(0))
                low = jax.jit(lambda p, b: model.prefill(
                    p, b["tokens"], extra={{k: v for k, v in b.items()
                                           if k != "tokens"}}),
                    in_shardings=(nm(param_specs(params, mesh, rules)),
                                  b_sh)).lower(params, batch)
            out[key] = analyze(low.compile().as_text()).flops
    print("RESULT " + json.dumps(out))
""")

# (key, arch, step kind, mesh, rule set, sequence, rows, config overrides):
# the prefills at 4 x 256, the train step at 8 x 64 in two microbatches
REF_CELLS = tuple(
    (f"{a}|prefill|{'x'.join(map(str, m))}|{r}", a, "prefill", m, r, 256,
     4, {})
    for a, m, r in (("qwen2.5-3b", (1, 1), "default"),
                    ("qwen2.5-3b", (1, 4), "default"),
                    ("qwen2.5-3b", (1, 4), "serving"),
                    ("codeqwen1.5-7b", (1, 4), "default"),
                    ("codeqwen1.5-7b", (1, 4), "serving"),
                    ("whisper-medium", (1, 4), "serving"))) + tuple(
    (f"qwen2.5-3b|train|{'x'.join(map(str, m))}|default{tag}",
     "qwen2.5-3b", "train", m, "default", 64, 8, over)
    for m, tag, over in (((1, 4), "", {}), ((1, 1), "", {}),
                         ((1, 1), "|no-remat", {"remat": "none"})))
# the per-device FLOPs of rank 0 of each prefill, and of one device:
# equal to the reference's partitioned program, digit for digit
PREFILL_FLOPS = {"qwen2.5-3b|prefill|1x1|default": 285_343_744,
                 "qwen2.5-3b|prefill|1x4|default": 83_918_848,
                 "qwen2.5-3b|prefill|1x4|serving": 83_918_848,
                 "codeqwen1.5-7b|prefill|1x4|default": 75_530_240,
                 "codeqwen1.5-7b|prefill|1x4|serving": 100_696_064}


@pytest.fixture(scope="module")
def reference_flops():
    res = subprocess.run([sys.executable, "-c", REFERENCE.format(
        root=ROOT, cells=REF_CELLS)], capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads([ln for ln in res.stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])


def _port_flops(key: str) -> int:
    _, arch, kind, sizes, rules_name, seq, rows, over = next(
        c for c in REF_CELLS if c[0] == key)
    cfg = reduced(get_config(arch)).replace(**over)
    spec = ShapeSpec(kind, seq, rows, kind)
    accum = 2 if kind == "train" else 1
    if sizes == (1, 1):
        return D.count_step(cfg, spec, accum)["flops"]
    with counting_world(MeshShape(("data", "model"), sizes)) as m:
        return D.count_step(cfg, spec, accum, mesh=m,
                            rules=RULES[rules_name])["flops"]


@pytest.mark.parametrize("key", [c[0] for c in REF_CELLS
                                 if "|prefill|" in c[0]])
def test_rank_zero_prefill_flops_equal_the_reference_partitioned_program(
        reference_flops, key):
    """Query heads split, K and V projected whole on every model rank:
    rank 0's FLOPs are the reference's (one device's over 4 plus 3/4 of
    the whole K/V projections where they are whole over "model"); whisper's
    encoder and cross-attention too."""
    port = _port_flops(key)
    assert port == reference_flops[key] > 0
    if key in PREFILL_FLOPS:
        assert port == PREFILL_FLOPS[key]


def test_rank_zero_train_step_within_five_percent_of_the_reference(
        reference_flops):
    key = "qwen2.5-3b|train|1x4|default"
    port = _port_flops(key)
    assert reference_flops[key] <= port <= 1.05 * reference_flops[key]


def test_the_one_device_train_gap_is_one_recomputed_unembedding(
        reference_flops):
    """One device's train step (8 x 64, one cross-entropy chunk) counts
    one unembedding product (2 x 512 tokens x d_model x vocab) more than
    the reference's compiled step: the port's remat recomputes the chunk's
    logits in backward, which XLA's program of a one-chunk loss does not;
    without remat the two count alike, and on (1, 4), whose vocabulary is
    split 4 ways, the gap is that product's quarter."""
    cfg = reduced(get_config("qwen2.5-3b"))
    unembed = 2 * 8 * 64 * cfg.d_model * cfg.vocab_size
    base = "qwen2.5-3b|train|1x1|default"
    assert _port_flops(base) - reference_flops[base] == unembed
    assert _port_flops(base + "|no-remat") == reference_flops[
        base + "|no-remat"]
    key = "qwen2.5-3b|train|1x4|default"
    assert _port_flops(key) - reference_flops[key] == unembed // 4


@pytest.mark.parametrize("arch,kind,rules_name,want", [
    # every head leaf split (4 KV heads on 4): the attention's old path
    ("codeqwen1.5-7b", "prefill", "default", {"flops": 75_530_240}),
    # a decode step computes with each leaf's "model" part, as before
    ("qwen2.5-3b", "decode", "serving",
     {"flops": 262_144, "ops/all-gather/4": 9, "ops/all-reduce/4": 5,
      "coll/all-gather/4": 14_336, "coll/all-reduce/4": 2_560})])
def test_the_old_forms_count_as_before(arch, kind, rules_name, want):
    cfg = reduced(get_config(arch))
    seq, rows = (256, 4) if kind == "prefill" else (64, 4)
    with counting_world(MeshShape(("data", "model"), (1, 4))) as m:
        got = D.count_step(cfg, ShapeSpec(kind, seq, rows, kind), mesh=m,
                           rules=RULES[rules_name])
    assert {k: got[k] for k in want} == want
    if kind == "decode":
        assert {k for k in got if k.startswith("ops/")} == {
            k for k in want if k.startswith("ops/")}
