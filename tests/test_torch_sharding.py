"""The port's sharding stack (``repro_torch.sharding``, ``train/state.py``,
``launch/mesh.py``) against the reference on the CPU.

Specs are held exactly: every parameter of every architecture at its
published widths (built on the meta device, nothing drawn), the decode
caches at batch 128 and 32768 positions, the inputs of every assigned
shape and the train state, on the 16 x 16 and 2 x 16 x 16 production
meshes under the three rule sets. The parameters' oracle is the reference's
own resolver applied to the documented rule, ``resolve_spec(
logical_axes_for(path, ndim, is_expert))`` with an expert tensor told
apart by its MoE block; the reference's ``param_specs`` differs from that
exactly on the stacked dense ``mlp/w[igo]`` leaves (ROADMAP Queue C), which
a test pins. Quantization is bit-equal to the reference's and
``ErrorFeedback`` within 1e-6 over 50 steps; the compressed all-reduce and
the pipeline run over 4-rank gloo worlds in spawned processes.
"""
import functools
import os
import re
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: the reference's import order)
import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import SHAPES_BY_NAME as REF_SHAPES
from repro.models import token_spec as ref_token_spec
from repro.sharding import annotate as ref_annotate
from repro.sharding import compression as ref_compression
from repro.sharding import rules as ref_rules

import repro_torch.core  # noqa: F401
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import (ASSIGNED_SHAPES, Model, ShapeSpec,
                                make_inputs, reduced, token_spec)
from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                  SERVING_RULES, MeshShape, PartitionSpec,
                                  batch_specs, cache_specs, current_mesh,
                                  current_rules, logical_axis_rules,
                                  param_specs, resolve_spec, shard)
from repro_torch.sharding.compression import (ErrorFeedback, dequantize_int8,
                                              quantize_int8)
from repro_torch.sharding.pipeline import pipeline_apply, split_stages
from repro_torch.train import adafactor_init, adamw_init, make_train_step
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.state import init_train_state, train_state_specs

ROOT = os.path.join(os.path.dirname(__file__), "..")

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": DEFAULT_RULES, "serving": SERVING_RULES,
         "long_context": LONG_CONTEXT_RULES}
REF_RULES = {"default": ref_annotate.DEFAULT_RULES,
             "serving": ref_annotate.SERVING_RULES,
             "long_context": ref_annotate.LONG_CONTEXT_RULES}
STACKED = ("blocks", "enc_blocks")


def _meshes(name):
    sizes, names = MESHES[name]
    return MeshShape(names, sizes), AbstractMesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = ref_get_config(arch)
    sds = jax.eval_shape(RefModel(cfg).init_params, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(sds)[0]
    return sds, [(ref_rules._path_str(p), tuple(l.shape)) for p, l in leaves]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    model = Model(get_config(arch), device="meta")
    return model, dict(model.named_parameters())


def _ref_is_expert(path, cfg):
    """The documented rule: ``mlp/w[igo]`` of a MoE block (the scanned
    ``blocks`` of a MoE config, never its ``dense_blocks``), not shared."""
    return (cfg.is_moe and path.startswith("blocks/")
            and re.search(r"mlp/w[igo]$", path) is not None)


def _expected_param_specs(arch, mesh_name, rules_name):
    """{port name: spec tuple}: the reference's resolver over the
    documented rule, unstacked to the port's per-layer names."""
    cfg = ref_get_config(arch)
    _, leaves = _ref_param_shapes(arch)
    _, amesh = _meshes(mesh_name)
    rules = dict(REF_RULES[rules_name])
    out = {}
    for path, shape in leaves:
        axes = ref_rules.logical_axes_for(path, len(shape),
                                          _ref_is_expert(path, cfg))
        spec = tuple(ref_annotate.resolve_spec(axes, amesh, rules,
                                               dims=shape))
        head = path.split("/")[0]
        name = path.replace("/", ".")
        if head in STACKED:
            assert spec[0] is None, (path, spec)     # the layer axis
            rest = name[len(head) + 1:]
            for i in range(shape[0]):
                out[f"{head}.{i}.{rest}"] = spec[1:]
        else:
            out[name] = spec
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_documented_rule(arch):
    _, params = _port_params(arch)
    for mesh_name in MESHES:
        mesh, _ = _meshes(mesh_name)
        for rules_name, rules in RULES.items():
            want = _expected_param_specs(arch, mesh_name, rules_name)
            got = param_specs(params, mesh, rules)
            assert set(got) == set(want)
            bad = {k: (tuple(got[k]), want[k]) for k in want
                   if tuple(got[k]) != want[k]}
            assert not bad, (mesh_name, rules_name, list(bad.items())[:4])
            assert all(isinstance(s, PartitionSpec) for s in got.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reference_param_specs_differ_only_on_stacked_dense_mlp(arch):
    """The reference's ``param_specs`` takes a dense MLP weight stacked
    over layers (rank 3) for an expert tensor; the port keeps the
    documented layout. Nothing else differs."""
    cfg = ref_get_config(arch)
    sds, leaves = _ref_param_shapes(arch)
    mesh, amesh = _meshes("16x16")
    ref = jax.tree_util.tree_flatten_with_path(
        ref_rules.param_specs(sds, amesh, ref_annotate.DEFAULT_RULES))[0]
    ref = {ref_rules._path_str(p): tuple(s) for p, s in ref}
    want = _expected_param_specs(arch, "16x16", "default")
    differ = set()
    for path, shape in leaves:
        head = path.split("/")[0]
        if head in STACKED:
            fixed = (None,) + want[f"{head}.0.{path[len(head) + 1:]}"
                                   .replace("/", ".")]
        else:
            fixed = want[path.replace("/", ".")]
        if ref[path] != fixed:
            differ.add(path)
    dense_mlp = {p for p, s in leaves
                 if p.split("/")[0] in STACKED and not cfg.is_moe
                 and re.search(r"(^|/)mlp/w[igo]$", p)}
    assert differ == dense_mlp


def test_qwen_stacked_mlp_is_taken_for_experts_by_the_reference():
    """qwen2.5-3b ``blocks/mlp/wi`` (36, 2048, 11008): the reference gives
    P(None, 'data', None), the port ('data', 'model') on every layer."""
    sds, _ = _ref_param_shapes("qwen2.5-3b")
    mesh, amesh = _meshes("16x16")
    ref = ref_rules.param_specs(sds, amesh, ref_annotate.DEFAULT_RULES)
    assert tuple(ref["blocks"]["mlp"]["wi"]) == (None, "data", None)
    _, params = _port_params("qwen2.5-3b")
    got = param_specs(params, mesh)
    assert tuple(got["blocks.0.mlp.wi"]) == ("data", "model")
    assert tuple(got["blocks.35.mlp.wo"]) == ("model", "data")
    # nemotron-4-15b's 32 layers divide the model axis: the reference
    # shards its layer axis
    sds, _ = _ref_param_shapes("nemotron-4-15b")
    ref = ref_rules.param_specs(sds, amesh, ref_annotate.DEFAULT_RULES)
    assert tuple(ref["blocks"]["mlp"]["wi"]) == ("model", "data", None)
    _, params = _port_params("nemotron-4-15b")
    assert tuple(param_specs(params, mesh)["blocks.0.mlp.wi"]) == (
        "data", "model")


def _ref_paths(tree):
    return {ref_rules._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tuple(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_reference(arch):
    cfg = ref_get_config(arch)
    model, _ = _port_params(arch)
    cache = model.init_cache(128, 32768)
    ref_cache = jax.eval_shape(
        functools.partial(RefModel(cfg).init_cache, 128, 32768))
    for mesh_name in MESHES:
        mesh, amesh = _meshes(mesh_name)
        for rules_name, rules in RULES.items():
            ref_r = REF_RULES[rules_name]
            got = _port_paths(cache_specs(cache, mesh, rules))
            want = _ref_paths(ref_rules.cache_specs(ref_cache, amesh, ref_r))
            assert got == want, (mesh_name, rules_name)
            for spec in ASSIGNED_SHAPES:
                batch = {k: torch.empty(s, dtype=dt, device="meta")
                         for k, (s, dt) in token_spec(
                             get_config(arch), spec).items()}
                ref_b = ref_token_spec(cfg, REF_SHAPES[spec.name])
                got = {k: tuple(v) for k, v in
                       batch_specs(batch, mesh, rules).items()}
                want = _ref_paths(ref_rules.batch_specs(ref_b, amesh, ref_r))
                assert got == want, (mesh_name, rules_name, spec.name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_specs(arch):
    """AdamW's moments take the parameter specs leaf by leaf; Adafactor's
    factored states and the step are replicated, as the reference's."""
    model, params = _port_params(arch)
    for mesh_name in MESHES:
        mesh, amesh = _meshes(mesh_name)
        want = _expected_param_specs(arch, mesh_name, "default")
        specs = train_state_specs(init_train_state(model, adamw_init), mesh)
        for part in (specs["params"], specs["opt"]["m"], specs["opt"]["v"]):
            assert {k: tuple(v) for k, v in part.items()} == want
        assert specs["step"] == PartitionSpec()
    fac = train_state_specs(init_train_state(model, adafactor_init), mesh)
    assert set(fac["opt"]) == {"f"}
    leaves = [s for sub in fac["opt"]["f"].values() for s in sub.values()]
    assert leaves and all(s == PartitionSpec() for s in leaves)
    ref_sds = jax.eval_shape(
        lambda: {"params": _ref_param_shapes(arch)[0],
                 "opt": {"f": {"x": jnp.zeros((4, 4))}},
                 "step": jnp.zeros((), jnp.int32)})
    from repro.train.state import train_state_specs as ref_state_specs
    ref = ref_state_specs(ref_sds, amesh)
    assert tuple(ref["opt"]["f"]["x"]) == () and tuple(ref["step"]) == ()


def test_resolve_spec_pruning_matches_reference():
    rules = dict(DEFAULT_RULES)
    cases = [
        # (logical, dims)
        (("batch", "seq", "embed"), (256, 4096, 2048)),
        (("batch", "fsdp"), (256, 4096)),            # ('pod','data') used once
        (("kv_heads", "head_dim"), (2, 128)),        # 2 heads: model falls through
        (("kv_heads", "head_dim"), (16, 128)),
        (("fsdp", "vocab"), (2048, 51865)),          # uneven vocab: replicated
        (("vocab", "fsdp"), (152064, 3584)),
        (("batch",), (1,)),                          # pruned to replicated
        (("batch",), (16,)),                         # pod 2 x data 16 is 32
        (("experts", "fsdp", None), (64, 2048, 1024)),
        ((None, "mlp"), (4, 24576)),
        (("seq_kv",), (32768,)),                     # no such rule by default
    ]
    for mesh_name in MESHES:
        mesh, amesh = _meshes(mesh_name)
        for logical, dims in cases:
            want = tuple(ref_annotate.resolve_spec(logical, amesh, rules,
                                                   dims=dims))
            assert tuple(resolve_spec(logical, mesh, rules, dims=dims)) == \
                want, (mesh_name, logical, dims)
            want = tuple(ref_annotate.resolve_spec(logical, amesh, rules))
            assert tuple(resolve_spec(logical, mesh, rules)) == want
    mesh, _ = _meshes("2x16x16")
    assert tuple(resolve_spec(("batch", "fsdp"), mesh, rules,
                              dims=(64, 64))) == (("pod", "data"), None)
    # pod (2) divides 16, then data (16) does not divide the 8 left
    assert tuple(resolve_spec(("batch",), mesh, rules,
                              dims=(16,))) == ("pod",)


def test_rule_binding_and_shard_are_what_the_docstrings_say():
    mesh = make_production_mesh()
    x = torch.ones(4, 8)
    assert current_mesh() is None and current_rules() is None
    with logical_axis_rules(mesh, SERVING_RULES):
        assert current_mesh() is mesh
        assert current_rules() == dict(SERVING_RULES)
        assert tuple(resolve_spec(("fsdp", "mlp"), dims=(2048, 11008))) == (
            None, "model")
        assert shard(x, "batch", "embed") is x
        with logical_axis_rules(mesh, DEFAULT_RULES):
            assert current_rules() == dict(DEFAULT_RULES)
        assert current_rules() == dict(SERVING_RULES)
    assert current_mesh() is None
    assert shard(x, "batch", "embed") is x
    assert tuple(DEFAULT_RULES) == tuple(ref_annotate.DEFAULT_RULES)
    assert tuple(SERVING_RULES) == tuple(ref_annotate.SERVING_RULES)
    assert tuple(LONG_CONTEXT_RULES) == tuple(ref_annotate.LONG_CONTEXT_RULES)


def test_production_and_host_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.shape, multi.size, multi.name) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, 512,
        "2x16x16")
    host = make_host_mesh()
    assert (host.axis_names, host.sizes) == (("data", "model"), (1, 1))


def test_constrain_accum_is_the_identity_on_one_device():
    """The accumulation constraint pins nothing on one device: two steps
    with it are bit-equal to two steps without it."""
    cfg = reduced(get_config("qwen2.5-3b"), dtype="float32")
    batch = make_inputs(cfg, ShapeSpec("t", 32, 2, "train"), seed=3,
                        device="cpu")
    finals = []
    for constrain in (False, True):
        model = Model(cfg, seed=1, device="cpu")
        state = init_train_state(model, adamw_init)
        step = make_train_step(model, OptConfig(), accum_steps=2,
                               constrain_accum=constrain)
        losses = []
        for _ in range(2):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        finals.append(({k: p.detach().clone() for k, p in
                        state["params"].items()}, losses))
    (p0, l0), (p1, l1) = finals
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((57, 33), np.float32),
                                         ((1000,), np.float32),
                                         ((3, 5, 7), np.float32),
                                         ((64, 64), "bfloat16")])
def test_quantize_int8_bit_equal_to_reference(shape, dtype):
    rng = np.random.default_rng(7)
    x = (rng.normal(0, 3, shape) * rng.uniform(0, 1, shape)).astype(
        np.float32)
    x.flat[0] = 0.5 * 127      # a half-way rounding case after scaling
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for block in (256, 64):
        q, s = quantize_int8(xt, block)
        rq, rs = ref_compression.quantize_int8(xj, block)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        back = dequantize_int8(q, s, xt.shape, xt.dtype)
        rback = ref_compression.dequantize_int8(rq, rs, xj.shape, xj.dtype)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(rback, np.float32))


def test_error_feedback_tracks_reference_over_50_steps():
    rng = np.random.default_rng(11)
    grads = [{"w": rng.normal(0, 1, (40, 30)).astype(np.float32),
              "b": rng.normal(0, 1e-3, (30,)).astype(np.float32)}
             for _ in range(50)]
    state = ErrorFeedback.init({k: torch.from_numpy(v)
                                for k, v in grads[0].items()})
    ref_state = ref_compression.ErrorFeedback.init(
        {k: jnp.asarray(v) for k, v in grads[0].items()})
    worst = 0.0
    for g in grads:
        comp, state = ErrorFeedback.apply(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, block=64)
        rcomp, ref_state = ref_compression.ErrorFeedback.apply(
            {k: jnp.asarray(v) for k, v in g.items()}, ref_state, block=64)
        for k in g:
            worst = max(worst,
                        float(np.abs(comp[k].numpy()
                                     - np.asarray(rcomp[k])).max()),
                        float(np.abs(state[k].numpy()
                                     - np.asarray(ref_state[k])).max()))
    assert worst <= 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(body: str, world: int, timeout: float = 120) -> list[str]:
    """Run ``body`` in ``world`` spawned gloo ranks (``rank``, ``world``
    and ``dist`` are bound); returns each rank's stdout. Every rank
    destroys its process group before it exits."""
    code = textwrap.dedent("""
        import os, sys
        sys.path.insert(0, os.path.join({root!r}, "src"))
        import numpy as np
        import torch
        import torch.distributed as dist
        rank, world = int(sys.argv[1]), int(sys.argv[2])
        dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
        {body}
        finally:
            dist.destroy_process_group()
    """).format(root=ROOT, port=_free_port(),
                body=textwrap.indent(textwrap.dedent(body), "    "))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(world)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_compressed_allreduce_over_four_gloo_ranks():
    """Each rank holds its own gradients; the compressed all-reduce gives
    every rank the same result: numpy's sum of the int8 payloads times the
    mean scale, over the ranks (the reference's three sums)."""
    outs = _run_world("""
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.sharding.compression import (
            make_compressed_allreduce, quantize_int8)
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        grads = {k: torch.from_numpy(np.random.default_rng(100 * r + i)
                 .normal(0, 1, s).astype(np.float32))
                 for r in range(world)
                 for i, (k, s) in enumerate([("w", (57, 33)), ("b", (300,))])
                 if r == rank}
        out = make_compressed_allreduce(mesh, block=64)(grads)
        print({k: v.numpy().tolist() for k, v in out.items()})
    """, world=4)
    got = [eval(o) for o in outs]
    assert all(g == got[0] for g in got)
    per_rank = [{k: np.random.default_rng(100 * r + i).normal(0, 1, s)
                 .astype(np.float32)
                 for i, (k, s) in enumerate([("w", (57, 33)), ("b", (300,))])}
                for r in range(4)]
    for k in ("w", "b"):
        exact = per_rank[0][k]
        qs = [quantize_int8(torch.from_numpy(g[k]), 64) for g in per_rank]
        qsum = sum(q.numpy().astype(np.int32) for q, _ in qs)
        scale = sum(s.numpy() for _, s in qs) / 4.0
        want = (qsum.astype(np.float32) * scale).ravel()[:exact.size] \
            .reshape(exact.shape) / 4
        np.testing.assert_allclose(np.array(got[0][k], np.float32), want,
                                   rtol=1e-6, atol=1e-6)


def test_split_stages():
    p = {"w": torch.arange(24).reshape(6, 2, 2)}
    s = split_stages(p, 3)
    assert s["w"].shape == (3, 2, 2, 2)
    assert torch.equal(s["w"][1, 0], p["w"][2])
    with pytest.raises(ValueError):
        split_stages(p, 4)


def test_single_stage_equals_direct():
    w = torch.stack([torch.eye(8) * 2.0])           # one stage: y = 2x
    fn = pipeline_apply(lambda params, x: x @ params,
                        MeshShape(("stage",), (1,)))
    xs = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 4, 8))
                          .astype(np.float32))
    np.testing.assert_allclose(fn(w, xs).numpy(), xs.numpy() * 2.0,
                               rtol=1e-6)


def test_four_stage_pipeline_over_gloo_equals_the_sequential_stack():
    outs = _run_world("""
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.sharding.pipeline import pipeline_apply
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
        rng = np.random.default_rng(0)
        w = torch.from_numpy(rng.normal(0, 0.3, (4, 8, 8)).astype(np.float32))
        xs = torch.from_numpy(rng.normal(size=(6, 5, 8)).astype(np.float32))
        fn = pipeline_apply(lambda p, x: torch.tanh(x @ p), mesh)
        print(fn(w, xs).numpy().tolist())
    """, world=4)
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.3, (4, 8, 8)).astype(np.float32)
    ref = rng.normal(size=(6, 5, 8)).astype(np.float32)
    for s in range(4):
        ref = np.tanh(ref @ w[s])
    for out in outs:
        np.testing.assert_allclose(np.array(eval(out), np.float32), ref,
                                   rtol=1e-5, atol=1e-6)
