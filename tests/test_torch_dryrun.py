"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

Its pure functions over config, shape and mesh (``_rules_for``,
``accum_steps_for``, ``model_flops``, ``ssm_kernel_io_bytes``,
``VARIANTS``) equal the reference's exactly for every (arch, shape, mesh).
The meta trace counts exactly the FLOPs that a real CPU step counts under
``FlopCounterMode`` (a dense, a MoE and the encoder-decoder model at
reduced widths; a record of the (1, 1) mesh is one device's count); the
depth extrapolation equals a trace at the full depth in FLOPs, bytes and
peak live bytes; and a dry-run of rank 0 of a 4 x 2 mesh of the reduced
models of ``tests/test_dryrun_small.py`` gives records with the
documented keys and the reference's collective kinds.
``tests/test_torch_dryrun_rank.py`` holds a rank's count against a real
rank's.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401
from jax.sharding import AbstractMesh
from repro.configs import get_config as ref_get_config
from repro.models import SHAPES_BY_NAME as REF_SHAPES

import repro_torch.core  # noqa: F401
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (ASSIGNED_SHAPES, Model, ShapeSpec,
                                make_inputs, reduced)
from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                  MeshShape)
from repro_torch.train import adamw_init, make_train_step
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.state import init_train_state
from torch.utils.flop_counter import FlopCounterMode

SMALL_ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "falcon-mamba-7b", "hymba-1.5b",
               "whisper-medium", "llava-next-34b")
RECORD_KEYS = {"arch", "shape", "mesh", "step", "n_devices", "skipped",
               "flops_per_device", "bytes_per_device",
               "bytes_per_device_unfused", "collective_bytes_per_device",
               "collective_breakdown", "collective_op_counts", "memory",
               "model_flops_total", "model_params", "active_params",
               "lower_s", "variant", "rules", "accum_steps", "counted_by"}


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS to 512
    host devices for processes started later; the variable is put back."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


def _small(arch):
    cfg = reduced(get_config(arch), moe_group_size=32)
    return cfg, ShapeSpec(
        "t", 64 + (cfg.n_image_tokens if cfg.family == "vlm" else 0), 8,
        "train")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pure_functions_equal_reference(arch, ref_dryrun):
    assert D.VARIANTS == ref_dryrun.VARIANTS
    names = {id(ref_dryrun.DEFAULT_RULES): "default",
             id(ref_dryrun.LONG_CONTEXT_RULES): "long_context"}
    ports = {id(DEFAULT_RULES): "default", id(LONG_CONTEXT_RULES):
             "long_context"}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        amesh = AbstractMesh(mesh.sizes, mesh.axis_names)
        for variant in D.VARIANTS:
            cfg = D.variant_config(get_config(arch), variant)
            ref_cfg = ref_get_config(arch).replace(
                **{k: getattr(cfg, k) for k in ("ssm_kernel",
                                                "cast_params_bf16")})
            for spec in ASSIGNED_SHAPES:
                ref_spec = REF_SHAPES[spec.name]
                assert ports[id(D._rules_for(spec, mesh))] == \
                    names[id(ref_dryrun._rules_for(ref_spec, amesh))]
                accum = D.accum_steps_for(cfg, spec, mesh)
                assert accum == ref_dryrun.accum_steps_for(ref_cfg, ref_spec,
                                                           amesh)
                assert D.model_flops(cfg, spec) == \
                    ref_dryrun.model_flops(ref_cfg, ref_spec)
                for a in (1, accum):
                    assert D.ssm_kernel_io_bytes(cfg, spec, mesh, a) == \
                        ref_dryrun.ssm_kernel_io_bytes(ref_cfg, ref_spec,
                                                       amesh, a)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b",
                                  "whisper-medium"])
def test_meta_trace_counts_the_flops_of_a_real_step(arch):
    cfg, spec = _small(arch)
    spec = ShapeSpec("t", spec.seq_len, 4, "train")
    rec = D.dry_run_cell(cfg, spec, MeshShape(("data", "model"), (1, 1)),
                         accum_override=2)
    model = Model(cfg, seed=0, device="cpu")
    state = init_train_state(model, adamw_init)
    step = make_train_step(model, OptConfig(), accum_steps=2)
    batch = make_inputs(cfg, spec, device="cpu")
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert rec["flops_per_device"] == fc.get_total_flops() > 0
    for kind in ("prefill", "decode"):
        s = ShapeSpec("p", 64, 2, kind)
        fn, inputs = D.step_program(cfg, s)
        meta = D.trace_counts(fn, inputs)["flops"]
        real = make_inputs(cfg, s, device="cpu")
        with FlopCounterMode(display=False) as fc:
            if kind == "prefill":
                model.prefill(real["tokens"], extra={
                    k: v for k, v in real.items() if k != "tokens"})
            else:
                model.decode_step(model.init_cache(2, 64), real["tokens"], 63)
        assert meta == fc.get_total_flops() > 0, kind


@pytest.mark.parametrize("arch,kind", [("qwen2.5-3b", "train"),
                                       ("deepseek-v2-lite-16b", "train"),
                                       ("whisper-medium", "prefill"),
                                       ("hymba-1.5b", "decode")])
def test_depth_extrapolation_equals_the_full_trace(arch, kind):
    cfg, spec = _small(arch)
    if kind != "train":
        spec = ShapeSpec("p", 128, 4, kind)
    cfg = D.cut_depth(cfg, 5)
    ext = D.count_step(cfg, spec, accum=2 if kind == "train" else 1)
    fn, inputs = D.step_program(cfg, spec, 2 if kind == "train" else 1)
    full = D.trace_counts(fn, inputs)
    for k in ("flops", "bytes", "entry"):
        assert ext[k] == full[k], k
    assert D.peak_bytes(ext) == D.peak_bytes(full)


def test_meta_model_allocates_and_draws_nothing():
    model = Model(get_config("llava-next-34b"), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert sum(p.numel() for p in model.parameters()) > 34e9
    cache = model.init_cache(128, 32768)
    assert cache["scan"]["k"].device.type == "meta"


def test_small_mesh_dry_run_of_every_family():
    """The reference's small-mesh integration test in the port: train
    steps of six reduced families (2 microbatches) and a GQA decode on a
    4 x 2 mesh, each record complete and sane, its collectives by the
    reference's kinds."""
    mesh = MeshShape(("data", "model"), (4, 2))
    for arch in SMALL_ARCHS:
        cfg, spec = _small(arch)
        rec = D.dry_run_cell(cfg, spec, mesh, accum_override=2, arch=arch)
        assert set(rec) == RECORD_KEYS, arch
        assert rec["n_devices"] == 8 and rec["mesh"] == "4x2"
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert rec["collective_bytes_per_device"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "temp_bytes"}
        assert tuple(rec["collective_breakdown"]) == D.COLLECTIVE_KINDS
        # FSDP's gathers and its gradients' reduce-scatters
        assert rec["collective_op_counts"]["all-gather"] > 0, arch
        assert rec["collective_op_counts"]["reduce-scatter"] > 0, arch
        json.dumps(rec)
    cfg = reduced(get_config("qwen2.5-3b"))
    rec = D.dry_run_cell(cfg, ShapeSpec("d", 128, 8, "decode"), mesh)
    assert rec["step"] == "decode" and rec["flops_per_device"] > 0
    used = {k for k, v in rec["collective_breakdown"].items() if v}
    assert used == {"all-gather", "all-reduce"}
    tp = D.dry_run_cell(cfg, ShapeSpec("d", 128, 8, "decode"), mesh,
                        variant="serve_tp")
    assert tp["rules"] == "serving"
    # no parameter gathered over "data": far fewer bytes gathered
    assert tp["collective_breakdown"]["all-gather"] < \
        rec["collective_breakdown"]["all-gather"] / 4


def test_variants_change_what_they_name():
    mesh = MeshShape(("data", "model"), (4, 2))
    cfg, spec = _small("falcon-mamba-7b")
    base = D.dry_run_cell(cfg, spec, mesh, accum_override=2)
    fused = D.dry_run_cell(cfg, spec, mesh, variant="ssm_fused",
                           accum_override=2)
    io = D.ssm_kernel_io_bytes(cfg, spec, mesh, 2)
    assert fused["ssm_kernel_io_bytes"] == io > 0
    # the fused scan is one shape-only op in the trace: its bytes are the
    # analytic ones, in place of the chunked scan's
    assert fused["bytes_per_device"] < base["bytes_per_device"]
    # under a mesh the port puts every microbatch's gradient in its
    # parameter's layout anyway (train/step.py): accum_rs changes nothing
    # (ROADMAP Queue C)
    rs = D.dry_run_cell(cfg, spec, mesh, variant="accum_rs",
                        accum_override=2)
    for k in ("flops_per_device", "bytes_per_device", "memory",
              "collective_breakdown", "collective_op_counts"):
        assert rs[k] == base[k], k
    cfg, spec = _small("qwen2.5-3b")
    gather = D.dry_run_cell(cfg, spec, mesh, variant="bf16_gather")
    assert gather["flops_per_device"] == D.dry_run_cell(
        cfg, spec, mesh)["flops_per_device"]


def test_cli_writes_every_cell_with_the_reference_reason(tmp_path):
    D.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--out",
            str(tmp_path)])
    D.main(["--arch", "hymba-1.5b", "--shape", "decode_32k", "--mesh",
            "single", "--out", str(tmp_path)])
    names = sorted(os.listdir(tmp_path))
    assert names == ["hymba-1.5b__decode_32k__16x16.json",
                     "qwen2.5-3b__long_500k__16x16.json",
                     "qwen2.5-3b__long_500k__2x16x16.json"]
    skipped = json.load(open(tmp_path / names[1]))
    assert skipped["skipped"] and "full-attention" in skipped["reason"]
    rec = json.load(open(tmp_path / names[0]))
    assert set(rec) == RECORD_KEYS and rec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] > 0
