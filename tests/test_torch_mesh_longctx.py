"""The long-context decode step on a ``torch.distributed`` device mesh
(``src/repro_torch``): under ``LONG_CONTEXT_RULES`` a batch of one row is
whole on the data axes, and each weight keeps its data shard of
``d_model`` there (``sharding.spmd.decode_part``). A product contracts x's
columns of that shard and sums the partial products over "data" (the
attention's and MLA's query, key and value projections, the dense MLP's
and the experts' ``wi`` / ``wg``, the router, Mamba's ``in_proj``, the
unembedding), or gives this rank's output columns, which are gathered (the
output projections, the embedding and whisper's position rows). No
parameter is gathered over "data".

Every meshed check runs in one spawned world of 4 gloo ranks on "cpu"
meshes (4, 1) and (2, 2) ("data", "model") at ``reduced(cfg,
dtype="float32")`` with random attention biases; rank 0 prints the world's
findings as one JSON line.
Logits are held within rtol and atol 1e-5 of one device (the partial
products are summed in another order), greedy tokens and every top-k
expert choice exactly. The same world counts a decode step of ranks 0 and
3 with the dry-run's counter; each count must equal that rank's meta count
in a counting world (``launch.mesh.counting_world``).

In the main process rank 0's FLOPs (the dry-run's count) are held beside
the reference's partitioned program: a subprocess compiling its decode
step on 4 forced host devices with the dry-run's in- and out-shardings
(``repro/launch/dryrun.py``), read with ``repro.utils.hlo_cost.analyze``.
They differ by named products only (``reference_extra``).
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
from repro_torch.models.moe import _capacity  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    DEFAULT_RULES, LONG_CONTEXT_RULES, SERVING_RULES, MeshShape)
from test_torch_mesh_train import run_world  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, STEPS = 4, 6
# hymba-1.5b's 25 query and 5 KV heads divide no model axis of 2: the
# head-dim layout of the cache
HYMBA5 = dict(n_heads=5, n_kv_heads=5, d_model=80)
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
# (case id, arch, mesh, reduced() overrides): ("data", "model") meshes,
# and (2, 2, 1) ("pod", "data", "model"), where d_model is split over two
# mesh dims, "pod" the outer, as on 2 x 16 x 16
CASES = tuple(
    (f"{tag}-{'x'.join(map(str, mesh))}", arch, mesh, over)
    for tag, arch, over in (("qwen", "qwen2.5-3b", {}),
                            ("hymba5", "hymba-1.5b", HYMBA5),
                            ("falcon-mamba", "falcon-mamba-7b", {}),
                            ("olmoe", "olmoe-1b-7b", {}),
                            ("deepseek", "deepseek-v2-lite-16b", {}),
                            ("whisper", "whisper-medium", {}))
    for mesh in ((4, 1), (2, 2), (2, 2, 1))
    if len(mesh) == 2 or tag in ("qwen", "hymba5", "falcon-mamba"))
# the decode steps whose counts ranks 0 and 3 take, on (2, 2)
COUNT_ARCHS = ("qwen2.5-3b", "hymba-1.5b", "falcon-mamba-7b",
               "deepseek-v2-lite-16b")
COUNT_RANKS = (0, 3)
COUNT_MESH = (2, 2)
# the dry-run's decode step: batch 1, a 64-slot cache
SLOTS = 64
DECODE = ShapeSpec("decode", SLOTS, 1, "decode")

WORLD = r'''
import json
import numpy as np
import torch
import torch.distributed as dist
import repro_torch.core  # noqa: F401
import repro_torch.models.moe as MOE
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.serve import generate
from repro_torch.models import Model, ShapeSpec, reduced
from repro_torch.sharding import LONG_CONTEXT_RULES as RULES
from repro_torch.sharding.rules import distribute_batch, distribute_params
from repro_torch.sharding.spmd import full_value

torch.set_num_threads(1)
DECODE = ShapeSpec(*DECODE)
meshes = {m: make_device_mesh(m, device_type="cpu") for m in ((4, 1), (2, 2))}
meshes[(2, 2, 1)] = make_device_mesh((2, 2, 1), ("pod", "data", "model"),
                                     device_type="cpu")
out = {}

# every all-gather of a meshed decode step (its group's ranks, its output's
# elements), and the experts each top-k picks, one device's and the mesh's
seen = {"on": False, "mode": None, "gathers": [], "one": [], "mesh": []}
real_gather, real_top_k = dist.all_gather_into_tensor, MOE._top_k


def gather_spy(out_t, t, group=None, **kw):
    if seen["on"]:
        seen["gathers"].append([dist.get_process_group_ranks(group),
                                out_t.numel()])
    return real_gather(out_t, t, group=group, **kw)


def top_k_spy(probs, k):
    vals, idx = real_top_k(probs, k)
    if seen["mode"]:
        seen[seen["mode"]].append(idx.tolist())
    return vals, idx


dist.all_gather_into_tensor = gather_spy
MOE._top_k = top_k_spy


def err(a, b):
    return float((a - b).abs().max())


def model_of(cfg):
    """the model at seed 0 with seeded random attention biases (added once,
    after the sum over "data")"""
    model = Model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def run_case(arch, sizes, over):
    mesh = meshes[tuple(sizes)]
    cfg = reduced(get_config(arch), dtype="float32", **over)
    one = model_of(cfg)
    model = distribute_params(model_of(cfg), mesh, RULES)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (1, PROMPT))
    c1 = one.init_cache(1, PROMPT + STEPS)
    c2 = model.init_cache(1, PROMPT + STEPS, rules=RULES)
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.normal(0, 1, (
            1, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
        c1["cross_k"], c1["cross_v"] = one.cross_kv(one.encode(frames))
        placed = distribute_batch({"frames": frames}, mesh, RULES)["frames"]
        c2["cross_k"], c2["cross_v"] = model.cross_kv(
            model.encode(placed, rules=RULES), rules=RULES)
    seen.update(gathers=[], one=[], mesh=[])
    errs, close, same, t1, t2 = [], True, True, None, None
    for t in range(PROMPT + STEPS):
        col = torch.as_tensor(prompts[:, t:t + 1]) if t < PROMPT else None
        seen["mode"] = "one"
        l1, _ = one.decode_step(c1, col if t1 is None else t1[:, None], t)
        tok2 = col if t2 is None else t2[:, None]
        seen.update(on=True, mode="mesh")
        l2, _ = model.decode_step(c2, distribute_batch(
            {"tokens": tok2}, mesh, RULES)["tokens"], t, rules=RULES)
        seen.update(on=False, mode=None)
        l2 = full_value(l2)
        if t >= PROMPT - 1:
            errs.append(err(l2, l1))
            close = close and bool(torch.allclose(l2, l1, **TOL))
            t1, t2 = l1[:, -1].argmax(-1), l2[:, -1].argmax(-1)
            same = same and torch.equal(t1, t2)
    # the data axes' groups, and the columns of the activation a gather
    # over each gives: over "data" inside "pod", the pod's block of them
    data = [dist.get_process_group_ranks(mesh.get_group(n))
            for n in mesh.mesh_dim_names if n != "model"]
    want = {cfg.d_model, cfg.d_model // mesh.size(0) ** (len(data) - 1)}
    if cfg.attention == "mla":
        # each data rank's softmax statistics over its block of the slots
        # (running max, sum and weighted values of its model rank's heads)
        names = mesh.mesh_dim_names
        dp = int(np.prod([mesh.size(i) for i, n in enumerate(names)
                          if n != "model"]))
        want.add(dp * cfg.n_heads // mesh.size(names.index("model")) *
                 (cfg.v_head_dim + 2))
    rec = {"err": max(errs), "close": close, "greedy_equal": same,
           "experts": [seen["one"] == seen["mesh"], len(seen["mesh"])],
           "want_gathers": sorted(want),
           "data_gathers": sorted({n for g, n in seen["gathers"]
                                   if g in data})}
    if cfg.family != "encdec":
        rec["generate_equal"] = bool((generate(one, prompts, STEPS) ==
                                      generate(model, prompts, STEPS,
                                               mesh=mesh, rules=RULES)).all())
    return rec


for case_id, arch, sizes, over in CASES:
    out[case_id] = run_case(arch, sizes, over)

# each rank's count of a long-context decode step, as the dry-run counts it
counts = {}
for arch in COUNT_ARCHS:
    fn, inputs = D.step_program(reduced(get_config(arch)), DECODE,
                                mesh=meshes[tuple(COUNT_MESH)], rules=RULES,
                                device="cpu")
    c = D.trace_counts(fn, inputs)
    every = [None] * world
    dist.all_gather_object(every, c)
    counts[arch] = {str(r): every[r] for r in COUNT_RANKS}
out["counts"] = counts
if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


def _meta_count(arch: str, rank: int) -> dict:
    with counting_world(MeshShape(("data", "model"), COUNT_MESH),
                        rank) as m:
        fn, inputs = D.step_program(reduced(get_config(arch)), DECODE,
                                    mesh=m, rules=LONG_CONTEXT_RULES)
        return D.trace_counts(fn, inputs)


@pytest.fixture(scope="module")
def world():
    """The world's findings, and each counted step's meta counts, taken
    in this process while the world runs."""
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_world, WORLD, CASES=CASES, PROMPT=PROMPT,
                              STEPS=STEPS, TOL=TOL, COUNT_ARCHS=COUNT_ARCHS,
                              COUNT_RANKS=COUNT_RANKS, COUNT_MESH=COUNT_MESH,
                              DECODE=("decode", SLOTS, 1, "decode"))
        meta = {(a, r): _meta_count(a, r) for a in COUNT_ARCHS
                for r in COUNT_RANKS}
        found = running.result()
    found["meta"] = meta
    return found


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_long_context_decode_matches_one_device(world, case):
    """Every decode step's logits within 1e-5 of one device, fed its own
    greedy tokens, which equal one device's; ``generate``'s tokens too."""
    rec = world[case]
    assert rec["close"], rec["err"]
    assert rec["greedy_equal"]
    assert rec.get("generate_equal", True)


@pytest.mark.parametrize("case", [c[0] for c in CASES
                                  if c[1] in MOE_ARCHS])
def test_long_context_decode_picks_one_devices_experts(world, case):
    """The router's logits are summed over "data" from each rank's
    columns: every top-k choice of every step equals one device's."""
    equal, calls = world[case]["experts"]
    assert equal and calls > 0


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_long_context_decode_gathers_no_parameter_over_data(world, case):
    """Every all-gather over this rank's data group is one token's
    activation ([1, 1, d_model]; over "data" inside "pod", its half) or,
    for MLA, the softmax statistics of the attention over the rank's block
    of the slots ([1, H/tp, 1, dv + 2] a rank): no weight is gathered
    there."""
    assert world[case]["data_gathers"] == world[case]["want_gathers"]


@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_a_real_rank_counts_what_its_meta_count_says(world, arch):
    for rank in COUNT_RANKS:
        real = world["counts"][arch][str(rank)]
        meta = world["meta"][(arch, rank)]
        assert {k: v for k, v in real.items() if not k.startswith("peak/")
                } == {k: v for k, v in meta.items()
                      if not k.startswith("peak/")}, rank
        assert real["flops"] > 0


REFERENCE = textwrap.dedent("""
    import os, sys, json, functools
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join({root!r}, "src"))
    import jax
    from repro.configs import get_config
    from repro.models import Model, ShapeSpec, reduced, token_spec
    from repro.sharding import (LONG_CONTEXT_RULES as rules,
                                logical_axis_rules, param_specs)
    from repro.sharding.rules import batch_specs, cache_specs
    from repro.utils.hlo_cost import analyze
    from repro.utils.jaxcompat import make_auto_mesh

    out = {{}}
    for arch, sizes in {cells!r}:
        mesh = make_auto_mesh(tuple(sizes), ("data", "model"),
                              devices=jax.devices()[:sizes[0] * sizes[1]])
        nm = lambda t: jax.tree.map(
            lambda s: jax.sharding.NamedSharding(mesh, s), t)
        model = Model(reduced(get_config(arch)))
        spec = ShapeSpec("decode", {slots}, 1, "decode")
        with mesh, logical_axis_rules(mesh, rules):
            batch = token_spec(model.cfg, spec)
            params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
            cache = jax.eval_shape(functools.partial(
                model.init_cache, 1, {slots}))
            c_sh = nm(cache_specs(cache, mesh, rules))
            low = jax.jit(
                lambda p, c, t, pos: model.decode_step(p, c, t, pos),
                in_shardings=(nm(param_specs(params, mesh, rules)), c_sh,
                              nm(batch_specs({{"tokens": batch["tokens"]}},
                                             mesh, rules))["tokens"], None),
                out_shardings=(None, c_sh)).lower(
                params, cache, batch["tokens"], batch["pos"])
            out[f"{{arch}}|{{sizes[0]}}x{{sizes[1]}}"] = analyze(
                low.compile().as_text()).flops
    print("RESULT " + json.dumps(out))
""")

# the cells held beside the reference: every family at (2, 2), the Mamba
# archs and qwen on (1, 1) and (4, 1) too
REF_CELLS = tuple(
    (a, m) for a in ("falcon-mamba-7b", "hymba-1.5b", "qwen2.5-3b")
    for m in ((1, 1), (4, 1), (2, 2))) + tuple(
    (a, (2, 2)) for a in ("codeqwen1.5-7b", "glm4-9b", "nemotron-4-15b",
                          "llava-next-34b", "olmoe-1b-7b",
                          "deepseek-v2-lite-16b", "whisper-medium"))
# rank 0's FLOPs of the reference's partitioned program in the production
# archs' cells (falcon-mamba-7b, hymba-1.5b) and qwen2.5-3b's, digit for
# digit
REF_FLOPS = {"qwen2.5-3b|4x1": 102_400, "qwen2.5-3b|2x2": 69_632,
             "hymba-1.5b|4x1": 137_216, "hymba-1.5b|2x2": 101_376,
             "falcon-mamba-7b|4x1": 55_296, "falcon-mamba-7b|2x2": 44_032}


@pytest.fixture(scope="module")
def reference_flops():
    res = subprocess.run([sys.executable, "-c", REFERENCE.format(
        root=ROOT, cells=REF_CELLS, slots=SLOTS)], capture_output=True,
        text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads([ln for ln in res.stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])


def _port_count(arch: str, sizes: tuple) -> dict:
    cfg = reduced(get_config(arch))
    with counting_world(MeshShape(("data", "model"), sizes)) as m:
        return D.count_step(cfg, DECODE, mesh=m, rules=LONG_CONTEXT_RULES)


def _local(n: int, tp: int) -> int:
    """A dim's part on a model rank (whole where tp does not divide it)."""
    return n // tp if n % tp == 0 else n


def reference_extra(cfg, dp: int, tp: int) -> dict:
    """{product: FLOPs} that the reference's partitioned long-context
    decode step (batch 1, reduced widths) counts on rank 0 beyond the
    port's, each named:

    * products it runs whole over "data" where the port runs each rank's
      data shard, (dp - 1) / dp of each: the dense MLP's and the shared
      expert's ``wo`` and MLA's ``wo``, whose weights it gathers over
      "data" (its MLP constrains the output whole over "embed"), the
      router, whose weight it gathers too, and, in a MoE layer without a
      shared expert, the combine, whose expert outputs it gathers;
    * the Mamba conv window, an einsum there and an elementwise product
      and sum here (the one-device gap, on this rank's channels);
    * MLA's attention over the cache (the scores and the weighted values
      of the expanded keys and values), which it runs whole on every data
      rank once it has gathered the expanded keys and values, where the
      port attends over each data rank's block of the slots and combines
      the softmax statistics over "data"; both split the expansion of the
      cached latent (``wk_b``, ``wv_b``) over "data" by slots."""
    cut = (dp - 1) / dp
    d, out = cfg.d_model, {}
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.is_moe else 0
    n_dense = 0 if cfg.family == "ssm" else cfg.n_layers - n_moe
    if n_dense:
        out["mlp/wo"] = n_dense * 2 * _local(cfg.d_ff, tp) * d * cut
    if n_moe:
        out["router"] = n_moe * 2 * d * cfg.n_experts * cut
        if cfg.n_shared_experts:
            f = cfg.moe_d_ff * cfg.n_shared_experts
            out["shared/wo"] = n_moe * 2 * _local(f, tp) * d * cut
        else:
            out["combine"] = n_moe * 2 * _local(cfg.n_experts, tp) * \
                _capacity(cfg, 1) * d * cut
    if cfg.attention == "mla":
        h = _local(cfg.n_heads, tp)
        out["mla/wo"] = cfg.n_layers * 2 * h * cfg.v_head_dim * d * cut
        out["mla/attend"] = cfg.n_layers * 2 * SLOTS * h * (
            cfg.nope_head_dim + cfg.rope_head_dim + cfg.v_head_dim) * cut
    if cfg.uses_ssm:
        out["conv"] = cfg.n_layers * 2 * cfg.ssm_conv * _local(
            cfg.d_inner, tp)
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("cell", REF_CELLS,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in REF_CELLS])
def test_rank_zero_long_decode_flops_are_the_reference_less_named_products(
        reference_flops, cell):
    """Rank 0's FLOPs equal the reference's partitioned program's less the
    named products of ``reference_extra``, digit for digit; falcon-mamba's
    differ by its conv window alone."""
    arch, sizes = cell
    key = f"{arch}|{sizes[0]}x{sizes[1]}"
    cfg = reduced(get_config(arch))
    extra = reference_extra(cfg, *sizes)
    assert _port_count(arch, sizes)["flops"] == \
        reference_flops[key] - sum(extra.values())
    if key in REF_FLOPS:
        assert reference_flops[key] == REF_FLOPS[key]
    if arch == "falcon-mamba-7b":
        assert set(extra) == {"conv"}


@pytest.mark.parametrize("arch", ("falcon-mamba-7b", "hymba-1.5b"))
def test_the_mamba_one_device_gap_is_the_conv_window_product(
        reference_flops, arch):
    """On one device the reference counts the conv window's einsum
    ``bki,ki->bi`` (2 x kc x d_inner a layer a row), which the port takes
    as an elementwise product and a sum over the window, and nothing
    else more: a difference in kind, not a fault. Both compute the same
    kc multiply-adds a channel; ``FlopCounterMode`` counts only matrix
    products, so the gap is a counting convention, and an einsum would
    send a [B, kc, d_inner] contraction through a batched matmul in every
    Mamba layer of a host-bound decode step (ROADMAP, "Open differences
    in kind")."""
    cfg = reduced(get_config(arch))
    gap = reference_flops[f"{arch}|1x1"] - D.count_step(cfg, DECODE)["flops"]
    assert gap == cfg.n_layers * 2 * cfg.ssm_conv * cfg.d_inner == \
        reference_extra(cfg, 1, 1)["conv"]


@pytest.mark.parametrize("arch", ("falcon-mamba-7b", "hymba-1.5b",
                                  "qwen2.5-3b", "deepseek-v2-lite-16b"))
def test_every_counted_all_gather_on_4x1_is_one_tokens_activation(arch):
    """On (4, 1) every all-gather is over "data": the dry-run counts as
    many of one token's activation ([1, 1, d_model] bf16) as it counts
    all-gathers, and no all-gather over a larger tensor; MLA's layers
    gather besides the softmax statistics of each rank's block of the
    slots (f32, [1, H, 1, dv + 2] a rank), one a layer."""
    cfg = reduced(get_config(arch))
    got = _port_count(arch, (4, 1))
    stats = cfg.n_layers if cfg.attention == "mla" else 0
    assert got["ops/all-gather/4"] > stats
    assert got["coll/all-gather/4"] == (
        got["ops/all-gather/4"] - stats) * cfg.d_model * 2 + \
        stats * 4 * cfg.n_heads * (cfg.v_head_dim + 2) * 4
    assert not any(k.startswith("ops/all-gather/") and not k.endswith("/4")
                   for k in got)


@pytest.mark.parametrize("arch,kind,rules_name,want", [
    ("qwen2.5-3b", "decode", "default",
     {"flops": 212_992, "ops/all-gather/2": 17, "coll/all-gather/2": 215_040,
      "ops/all-reduce/2": 5, "coll/all-reduce/2": 1_280}),
    ("qwen2.5-3b", "decode", "serving",
     {"flops": 229_376, "ops/all-gather/2": 9, "coll/all-gather/2": 4_864,
      "ops/all-reduce/2": 5, "coll/all-reduce/2": 1_280}),
    ("hymba-1.5b", "decode", "default",
     {"flops": 331_776, "ops/all-gather/2": 21, "coll/all-gather/2": 329_728,
      "ops/all-reduce/2": 9, "coll/all-reduce/2": 1_984,
      "ops/all-to-all/2": 2, "coll/all-to-all/2": 1_024}),
    ("falcon-mamba-7b", "prefill", "default",
     {"flops": 30_441_472, "ops/all-gather/2": 7,
      "coll/all-gather/2": 165_888, "ops/all-reduce/2": 5,
      "coll/all-reduce/2": 245_760, "ops/all-to-all/2": 2,
      "coll/all-to-all/2": 65_536})])
def test_the_other_rule_sets_count_as_before(arch, kind, rules_name, want):
    """Where the rows are split over "data" nothing changed: rank 0's
    FLOPs and collectives on (2, 2), decode at 4 rows and a 64-slot cache,
    prefill at 4 x 256."""
    rules = {"default": DEFAULT_RULES, "serving": SERVING_RULES}[rules_name]
    seq = 256 if kind == "prefill" else SLOTS
    with counting_world(MeshShape(("data", "model"), (2, 2))) as m:
        got = D.count_step(reduced(get_config(arch)),
                           ShapeSpec(kind, seq, 4, kind), mesh=m, rules=rules)
    assert {k: v for k, v in got.items() if k.startswith(("ops/", "coll/"))
            } == {k: v for k, v in want.items() if k != "flops"}
    assert got["flops"] == want["flops"]


def test_mla_long_decode_expands_only_a_data_ranks_slots():
    """Reduced deepseek-v2-lite-16b, batch 1, 64 slots, (2, 2): each data
    rank expands and attends over its 32 slots, so rank 0 counts 361,536
    FLOPs (633,920 while every data rank expanded the whole cache), below
    the reference's 381,504 less its 9,728 of named whole products."""
    got = _port_count("deepseek-v2-lite-16b", (2, 2))["flops"]
    assert got == 361_536
    assert got <= 381_504 - 9_728
