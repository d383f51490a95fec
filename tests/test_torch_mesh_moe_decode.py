"""A meshed decode step's MoE layer under ``DEFAULT_RULES``
(``src/repro_torch``): its tokens are fewer than one device's group, so
``models.moe.moe_ffn`` gathers them over the data axes, where they are
then whole (``sharding.spmd.rows_gathered``), and the router, the routed
experts and the shared expert keep each leaf's data shard of ``d_model``
(``moe_parts(..., decode=True, gathered=True)``), as the reference's
partitioned program does. No MoE leaf is gathered over "data".

Rank 0's counts of a reduced decode step (4 rows, a 64-slot cache) come
from the dry-run's counter in a counting world
(``launch.mesh.counting_world``). They are held beside the reference's
partitioned program: one subprocess compiles its decode step on 4 forced
host devices with the dry-run's in- and out-shardings
(``repro/launch/dryrun.py``), read with ``repro.utils.hlo_cost.analyze``.
They differ by named products only (``decode_reference_extra``). The
same subprocess compiles deepseek's ``SERVING_RULES`` decode, whose gap
is MLA's cache expansion less the port's absorbed products
(``serving_mla_gap``). The values of these steps are held against one
device in the spawned world of ``tests/test_torch_mesh_serve.py``.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import repro_torch.core  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import counting_world  # noqa: E402
from repro_torch.models import ShapeSpec, reduced  # noqa: E402
from repro_torch.models.moe import _capacity  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    DEFAULT_RULES, SERVING_RULES, MeshShape)

ROWS, SLOTS = 4, 64
DECODE = ShapeSpec("decode", SLOTS, ROWS, "decode")
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
# (arch, ("data", "model") sizes, rule set) of the reference's program
CELLS = tuple((a, m, "default") for a in ARCHS for m in ((2, 2), (4, 1)))
SERVING_CELLS = tuple(("deepseek-v2-lite-16b", m, "serving")
                      for m in ((1, 4), (2, 2)))
# rank 0's FLOPs of the reference's partitioned decode step, digit for
# digit
REF_FLOPS = {"olmoe-1b-7b|2x2|default": 254_464,
             "olmoe-1b-7b|4x1|default": 265_216,
             "deepseek-v2-lite-16b|2x2|default": 1_298_688,
             "deepseek-v2-lite-16b|4x1|default": 1_308_160,
             "deepseek-v2-lite-16b|1x4|serving": 1_323_136,
             "deepseek-v2-lite-16b|2x2|serving": 1_368_320}
# rank 0's all-gathers of the port's decode step where every MoE leaf was
# gathered whole over "data" (ops, result bytes)
WHOLE_LEAF_GATHERS = {"olmoe-1b-7b|2x2": (21, 334_848),
                      "olmoe-1b-7b|4x1": (20, 660_480),
                      "deepseek-v2-lite-16b|2x2": (20, 291_328),
                      "deepseek-v2-lite-16b|4x1": (19, 555_520)}

REFERENCE = textwrap.dedent("""
    import os, sys, json, functools
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join({root!r}, "src"))
    import jax
    from repro.configs import get_config
    from repro.models import Model, ShapeSpec, reduced, token_spec
    from repro.sharding import (DEFAULT_RULES, SERVING_RULES,
                                logical_axis_rules, param_specs)
    from repro.sharding.rules import batch_specs, cache_specs
    from repro.utils.hlo_cost import analyze
    from repro.utils.jaxcompat import make_auto_mesh

    RULES = {{"default": DEFAULT_RULES, "serving": SERVING_RULES}}
    out = {{}}
    for arch, sizes, rules_name in {cells!r}:
        rules = RULES[rules_name]
        mesh = make_auto_mesh(tuple(sizes), ("data", "model"),
                              devices=jax.devices()[:sizes[0] * sizes[1]])
        nm = lambda t: jax.tree.map(
            lambda s: jax.sharding.NamedSharding(mesh, s), t)
        model = Model(reduced(get_config(arch)))
        spec = ShapeSpec("decode", {slots}, {rows}, "decode")
        with mesh, logical_axis_rules(mesh, rules):
            batch = token_spec(model.cfg, spec)
            params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
            cache = jax.eval_shape(functools.partial(
                model.init_cache, {rows}, {slots}))
            c_sh = nm(cache_specs(cache, mesh, rules))
            low = jax.jit(
                lambda p, c, t, pos: model.decode_step(p, c, t, pos),
                in_shardings=(nm(param_specs(params, mesh, rules)), c_sh,
                              nm(batch_specs({{"tokens": batch["tokens"]}},
                                             mesh, rules))["tokens"], None),
                out_shardings=(None, c_sh)).lower(
                params, cache, batch["tokens"], batch["pos"])
            out[f"{{arch}}|{{sizes[0]}}x{{sizes[1]}}|{{rules_name}}"] = \\
                analyze(low.compile().as_text()).flops
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_flops():
    res = subprocess.run([sys.executable, "-c", REFERENCE.format(
        root=ROOT, cells=CELLS + SERVING_CELLS, slots=SLOTS, rows=ROWS)],
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads([ln for ln in res.stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])


@functools.lru_cache(maxsize=None)
def _port_count(arch: str, sizes: tuple, rules=DEFAULT_RULES,
                spec=DECODE) -> dict:
    with counting_world(MeshShape(("data", "model"), sizes)) as m:
        return D.count_step(reduced(get_config(arch)), spec, mesh=m,
                            rules=rules)


def _local(n: int, tp: int) -> int:
    """A dim's part on a model rank (whole where tp does not divide it)."""
    return n // tp if n % tp == 0 else n


def _moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers


def decode_reference_extra(cfg, dp: int, tp: int) -> dict:
    """{product: FLOPs} that the reference's partitioned ``DEFAULT_RULES``
    decode step (``ROWS`` rows, reduced widths) counts on rank 0 beyond the
    port's, each named. Both gather the MoE layer's ``ROWS`` tokens whole
    over "data" and run the routed experts' ``wi`` / ``wg`` / ``wo`` and
    the shared expert's ``wi`` / ``wg`` on the data shard of ``d_model``;
    beyond that:

    * products the reference runs whole over "data" where the port runs
      the rank's data shard, (dp - 1) / dp of each: the dispatch of the
      tokens into the expert slots (its tokens' every column), the shared
      expert's ``wo`` (its MLP constrains the output whole over "embed"),
      and, in a MoE layer without a shared expert, the combine, whose
      expert outputs it gathers; the router where a model axis is split
      (on (4, 1) it contracts the router's data shard, as the port does);
    * negative: MLA's ``wkv_a``, which the port repeats on every model rank
      (its spec keeps it whole over "model") and the reference contracts
      over "model", (tp - 1) / tp of it."""
    cut = (dp - 1) / dp
    d, e_local = cfg.d_model, _local(cfg.n_experts, tp)
    slots = e_local * _capacity(cfg, ROWS)
    n_moe = _moe_layers(cfg)
    out = {"dispatch": n_moe * 2 * ROWS * slots * d * cut}
    if tp > 1:
        out["router"] = n_moe * 2 * ROWS * d * cfg.n_experts * cut
    if cfg.n_shared_experts:
        f = _local(cfg.moe_d_ff * cfg.n_shared_experts, tp)
        out["shared/wo"] = n_moe * 2 * ROWS * f * d * cut
    else:
        out["combine"] = n_moe * 2 * ROWS * slots * d * cut
    if cfg.attention == "mla":
        out["mla/wkv_a"] = -cfg.n_layers * 2 * (ROWS // dp) * d * (
            cfg.kv_lora_rank + cfg.rope_head_dim) * (tp - 1) / tp
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("cell", CELLS,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m, _ in CELLS])
def test_rank_zero_moe_decode_flops_are_the_reference_less_named_products(
        reference_flops, cell):
    """Rank 0's FLOPs equal the reference's partitioned program's less the
    named products of ``decode_reference_extra``, digit for digit: at or
    below the reference's everywhere but deepseek on (2, 2), which exceeds
    it by less than MLA's ``wkv_a`` repeated on the model ranks."""
    arch, sizes, rules_name = cell
    key = f"{arch}|{sizes[0]}x{sizes[1]}|{rules_name}"
    extra = decode_reference_extra(reduced(get_config(arch)), *sizes)
    got = _port_count(arch, sizes)["flops"]
    assert reference_flops[key] == REF_FLOPS[key]
    assert got == REF_FLOPS[key] - sum(extra.values())
    assert got - REF_FLOPS[key] <= -extra.get("mla/wkv_a", 0)


def _moe_leaf_bytes(cfg, tp: int) -> int:
    """The bytes of a MoE layer's leaves whole over "data": the router,
    and each rank's model part of the routed and the shared experts."""
    mats = 3 if cfg.mlp == "swiglu" else 2
    n = cfg.d_model * cfg.n_experts + mats * _local(
        cfg.n_experts, tp) * cfg.d_model * cfg.moe_d_ff
    if cfg.n_shared_experts:
        n += mats * cfg.d_model * _local(
            cfg.moe_d_ff * cfg.n_shared_experts, tp)
    return n * cfg.params_dtype.itemsize


@pytest.mark.parametrize("cell", CELLS,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m, _ in CELLS])
def test_a_moe_decode_step_gathers_no_moe_leaf_over_data(cell):
    """Rank 0's all-gathers are those of the step that gathered every MoE
    leaf whole over "data", less one a leaf (the router, the experts'
    ``wi`` / ``wg`` / ``wo`` and the shared expert's) and their bytes,
    plus one a layer of the ``[ROWS, d_model]`` output columns gathered
    once (``spmd.data_whole``)."""
    arch, sizes, _ = cell
    cfg = reduced(get_config(arch))
    n_moe, dp, tp = _moe_layers(cfg), *sizes
    leaves = 1 + (3 if cfg.mlp == "swiglu" else 2) * (
        2 if cfg.n_shared_experts else 1)
    ops, nbytes = WHOLE_LEAF_GATHERS[f"{arch}|{dp}x{tp}"]
    got = _port_count(arch, sizes)
    group = max(dp, tp)
    assert got[f"ops/all-gather/{group}"] == ops - n_moe * (leaves - 1)
    assert got[f"coll/all-gather/{group}"] == nbytes - n_moe * (
        _moe_leaf_bytes(cfg, tp) -
        ROWS * cfg.d_model * cfg.compute_dtype.itemsize)


# rank 0's counts on (2, 2) of the steps whose MoE tokens fill whole
# groups (DEFAULT_RULES' train step at 4 x 64 and prefill at 4 x 256) or
# whose leaves have no data shard (SERVING_RULES' decode): the digits of
# the program that gathered every MoE leaf whole over "data"
OTHER_STEPS = {
    ("olmoe-1b-7b", "train", "default"): {
        "flops": 66_469_888, "ops/all-gather/2": 36,
        "coll/all-gather/2": 600_064, "ops/all-reduce/2": 29,
        "coll/all-reduce/2": 202_012, "ops/reduce-scatter/2": 18,
        "coll/reduce-scatter/2": 165_888},
    ("olmoe-1b-7b", "prefill", "default"): {
        "flops": 88_768_512, "ops/all-gather/2": 19,
        "coll/all-gather/2": 333_824, "ops/all-reduce/2": 5,
        "coll/all-reduce/2": 327_680},
    ("olmoe-1b-7b", "decode", "serving"): {
        "flops": 385_536, "ops/all-gather/2": 11, "coll/all-gather/2": 5_888,
        "ops/all-reduce/2": 5, "coll/all-reduce/2": 1_792},
    ("deepseek-v2-lite-16b", "train", "default"): {
        "flops": 70_983_680, "ops/all-gather/2": 36,
        "coll/all-gather/2": 514_048, "ops/all-reduce/2": 39,
        "coll/all-reduce/2": 287_004, "ops/reduce-scatter/2": 18,
        "coll/reduce-scatter/2": 144_384},
    ("deepseek-v2-lite-16b", "prefill", "default"): {
        "flops": 96_829_440, "ops/all-gather/2": 19,
        "coll/all-gather/2": 290_816, "ops/all-reduce/2": 6,
        "coll/all-reduce/2": 393_216},
    ("deepseek-v2-lite-16b", "decode", "serving"): {
        "flops": 368_896, "ops/all-gather/2": 10, "coll/all-gather/2": 8_192,
        "ops/all-reduce/2": 6, "coll/all-reduce/2": 2_048}}


@pytest.mark.parametrize("step", sorted(OTHER_STEPS),
                         ids=["-".join(s) for s in sorted(OTHER_STEPS)])
def test_the_other_moe_steps_count_as_before(step):
    arch, kind, rules_name = step
    rules = {"default": DEFAULT_RULES, "serving": SERVING_RULES}[rules_name]
    seq = {"train": 64, "prefill": 256, "decode": SLOTS}[kind]
    got = _port_count(arch, (2, 2), rules, ShapeSpec(kind, seq, ROWS, kind))
    assert {k: v for k, v in got.items()
            if k == "flops" or k.startswith(("ops/", "coll/"))
            } == OTHER_STEPS[step]


def serving_mla_gap(cfg, tp: int) -> dict:
    """{part: FLOPs} of the gap between the reference's ``SERVING_RULES``
    decode and the port's on rank 0, MLA's alone (every other product is
    the same). The cache is split on its slots over "model". The reference
    expands the whole cache for the rank's heads every step
    (``mla_attend``: ``wk_b`` and ``wv_b`` over every slot) and attends
    over the expanded keys and values; the port absorbs ``wk_b`` into the
    queries and ``wv_b`` into the output and scores every head against its
    slots in the latent space (``models/mla._absorbed_over_split_slots``):
    a cheaper algorithm for the same values."""
    rows, heads = ROWS // (4 // tp), _local(cfg.n_heads, tp)
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    dn, dv = cfg.nope_head_dim, cfg.v_head_dim
    per_layer = {
        "expansion": 2 * rows * SLOTS * r * heads * (dn + dv),
        "expanded attention": 2 * rows * heads * SLOTS * (dn + dr + dv),
        "absorbed queries": -2 * rows * heads * dn * r,
        "latent attention": -2 * rows * cfg.n_heads * (SLOTS // tp) * (
            r + dr + r),
        "absorbed output": -2 * rows * heads * r * dv}
    return {k: cfg.n_layers * v for k, v in per_layer.items()}


@pytest.mark.parametrize("cell", SERVING_CELLS,
                         ids=[f"{m[0]}x{m[1]}" for _, m, _ in SERVING_CELLS])
def test_serving_mla_decode_counts_less_by_the_expansion_less_the_absorbed_form(
        reference_flops, cell):
    """Under ``SERVING_RULES`` deepseek's rank 0 counts less than the
    reference by ``serving_mla_gap`` exactly: the expansion (1,048,576
    FLOPs over the two layers) and the attention over the expanded cache,
    less the absorbed form's products."""
    arch, sizes, rules_name = cell
    key = f"{arch}|{sizes[0]}x{sizes[1]}|{rules_name}"
    cfg = reduced(get_config(arch))
    gap = serving_mla_gap(cfg, sizes[1])
    assert reference_flops[key] == REF_FLOPS[key]
    assert gap["expansion"] == 1_048_576
    assert _port_count(arch, sizes, SERVING_RULES)["flops"] == \
        REF_FLOPS[key] - sum(gap.values())
