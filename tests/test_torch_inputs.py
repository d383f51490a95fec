"""The port's input specifications (``repro_torch.models.inputs``) against
the reference's ``repro.models.inputs`` on the CPU: the assigned shapes,
which (arch x shape) pairs run, every input's shape and dtype, and
``make_inputs`` bit-equal to the reference's for the same seed, token ids
and the bf16 stub embeddings alike, for every arch and applicable assigned
shape at ``reduced`` sizes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import repro.models as ref_models
from repro.configs import get_config as ref_get_config

import repro_torch.models as models
from repro_torch.configs import ARCH_IDS, get_config

NAMES = ("ShapeSpec", "ASSIGNED_SHAPES", "SHAPES_BY_NAME",
         "shape_applicable", "token_spec", "make_inputs")
CASES = [(arch, spec.name) for arch in ARCH_IDS
         for spec in models.ASSIGNED_SHAPES
         if models.shape_applicable(get_config(arch), spec)[0]]


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def test_models_export_the_input_specs_as_the_reference_does():
    for name in NAMES:
        assert name in models.__all__ and name in ref_models.__all__, name
        assert getattr(models, name) is getattr(models.inputs, name)
    assert [tuple(vars(s).values()) for s in models.ASSIGNED_SHAPES] == [
        tuple(vars(s).values()) for s in ref_models.ASSIGNED_SHAPES]
    assert list(models.SHAPES_BY_NAME) == list(ref_models.SHAPES_BY_NAME)
    # three shapes each; the two sub-quadratic archs also run long_500k
    assert len(CASES) == 3 * len(ARCH_IDS) + 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_and_token_spec_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for spec, ref_spec in zip(models.ASSIGNED_SHAPES,
                              ref_models.ASSIGNED_SHAPES):
        assert models.shape_applicable(cfg, spec) == \
            ref_models.shape_applicable(ref_cfg, ref_spec)
        got = models.token_spec(cfg, spec)
        want = ref_models.token_spec(ref_cfg, ref_spec)
        assert list(got) == list(want), spec.name
        for k, (shape, dtype) in got.items():
            assert shape == want[k].shape, (spec.name, k)
            assert _dtype_name(dtype) == _dtype_name(want[k].dtype), k


@pytest.mark.parametrize("arch,shape", CASES)
def test_make_inputs_bit_equal_to_reference(arch, shape):
    cfg = models.reduced(get_config(arch))
    ref_cfg = ref_models.reduced(ref_get_config(arch))
    seed = len(arch) + len(shape)
    got = models.make_inputs(cfg, models.SHAPES_BY_NAME[shape], seed=seed,
                             device="cpu")
    want = ref_models.make_inputs(ref_cfg, ref_models.SHAPES_BY_NAME[shape],
                                  seed=seed)
    assert list(got) == list(want)
    for k, t in got.items():
        w = want[k]
        assert t.device.type == "cpu"
        assert tuple(t.shape) == w.shape and \
            _dtype_name(t.dtype) == _dtype_name(w.dtype), k
        if t.dtype == torch.bfloat16:     # compare the bits
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(w.astype(jnp.float32)).view(np.int32) >> 16,
                err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                          err_msg=k)


def test_make_inputs_feed_every_family_loss():
    """The train spec's batch runs through ``Model.loss`` for the two
    families with a stub frontend (frames, patches)."""
    spec = models.ShapeSpec("smoke_train", 64 + 8, 2, "train")
    for arch in ("whisper-medium", "llava-next-34b"):
        cfg = models.reduced(get_config(arch), dtype="float32")
        batch = models.make_inputs(cfg, spec, seed=1, device="cpu")
        with torch.no_grad():
            loss, metrics = models.Model(cfg, device="cpu").loss(batch)
        assert torch.isfinite(loss)
        assert float(metrics["ce"]) < np.log(cfg.vocab_size) * 2
