"""The port's model stack (``repro_torch.configs``, ``repro_torch.models``)
against the reference on the CPU: the config registry field by field, and
falcon-mamba-7b reduced to CPU size (``ssm_chunk=8``, float32) with the
reference's randomly initialised parameters carried across, through both
scan routes (``ssm_kernel`` False: chunked associative scan; True: the
selective-scan autograd function, plain versions on the CPU); and the
three remat policies ("none", "full", "dots") on every family.

Tolerances: hidden states within rtol 1e-5 / atol 1e-5, the loss within
rtol 1e-5, every gradient leaf within rtol 1e-3 / atol 1e-5 of
``jax.value_and_grad`` (f32 sums in another order through two layers and a
chunked cross-entropy).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import reduced as ref_reduced

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model, reduced
from repro_torch.models.convert import (flatten_reference,
                                        load_reference_params)

ARCH = "falcon-mamba-7b"


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_registry_matches_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    for arch in ARCH_IDS:
        got, want = get_config(arch), ref_get_config(arch)
        assert _fields(got) == _fields(want), arch
        assert _fields(reduced(got)) == _fields(ref_reduced(want)), arch
        assert got.n_params() == want.n_params(), arch
        assert got.d_inner == want.d_inner
        assert str(got.compute_dtype).split(".")[-1] == str(
            want.compute_dtype), arch
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("nope")


def test_falcon_mamba_published_widths():
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank,
            cfg.ssm_conv, cfg.vocab_size, cfg.n_layers) == (
        4096, 8192, 16, 256, 4, 65024, 64)
    assert cfg.compute_dtype == torch.bfloat16
    assert cfg.params_dtype == torch.float32 and cfg.remat == "full"


def _pair(ssm_kernel: bool, **kw):
    ref_cfg = ref_reduced(ref_get_config(ARCH), ssm_chunk=8, dtype="float32",
                          ssm_kernel=ssm_kernel, **kw)
    cfg = reduced(get_config(ARCH), ssm_chunk=8, dtype="float32",
                  ssm_kernel=ssm_kernel, **kw)
    ref_model = RefModel(ref_cfg)
    params = ref_model.init_params(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref_model, params, model


def _batch(vocab: int, b: int = 2, s: int = 32, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("ssm_kernel", [False, True])
def test_forward_loss_and_grads_match_reference(ssm_kernel):
    ref_model, params, model = _pair(ssm_kernel)
    batch = _batch(model.cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}

    want_x, _ = ref_model.forward(params, jb["tokens"])
    got_x, aux = model(tb["tokens"])
    np.testing.assert_allclose(got_x.detach().numpy(), np.asarray(want_x),
                               rtol=1e-5, atol=1e-5)
    assert float(aux) == 0.0

    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: ref_model.loss(p, jb), has_aux=True)(params)
    loss, metrics = model.loss(tb)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    assert int(metrics["tokens"]) == int(want_m["tokens"])
    ref_grads = flatten_reference(jax.tree.map(np.asarray, want_g))
    assert set(ref_grads) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)


def test_kernel_route_equals_chunked_route():
    """Both scan routes of the port on the same parameters: the model-level
    plain version (chunked associative scan) and the kernel route."""
    _, _, chunked = _pair(False)
    fused = Model(dataclasses.replace(chunked.cfg, ssm_kernel=True),
                  device="cpu")
    fused.load_state_dict(chunked.state_dict())
    tb = {k: torch.from_numpy(v).long()
          for k, v in _batch(chunked.cfg.vocab_size, seed=1).items()}
    with torch.no_grad():
        a, _ = chunked.loss(tb)
        b, _ = fused.loss(tb)
    assert float(a) == pytest.approx(float(b), rel=1e-5)


def test_reference_params_carried_across():
    """Every leaf of the reference's tree lands in the parameter of the same
    path, the stacked blocks unstacked one layer per module; a leaf of the
    wrong shape is refused."""
    _, params, model = _pair(True)
    tree = jax.tree.map(np.asarray, params)
    named = dict(model.named_parameters())
    flat = flatten_reference(tree)
    assert flat.keys() == named.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(named[k].detach().numpy(), v,
                                      err_msg=k)
    n_layers = model.cfg.n_layers
    assert tree["blocks"]["ssm"]["in_proj"].shape[0] == n_layers
    np.testing.assert_array_equal(
        named[f"blocks.{n_layers - 1}.ssm.in_proj"].detach().numpy(),
        tree["blocks"]["ssm"]["in_proj"][-1])
    bad = dict(tree, ln_f={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="ln_f.scale"):
        load_reference_params(model, bad)


def test_bf16_remat_and_no_remat_agree():
    """The default dtypes (bf16 compute, f32 params): remat 'full' (block
    and CE chunks under torch.utils.checkpoint) and 'none' give the same
    loss and gradients."""
    cfg = reduced(get_config(ARCH), ssm_chunk=8)
    assert cfg.compute_dtype == torch.bfloat16 and cfg.remat == "full"
    tb = {k: torch.from_numpy(v).long()
          for k, v in _batch(cfg.vocab_size, seed=2).items()}
    out = []
    for remat in ("full", "none"):
        model = Model(dataclasses.replace(cfg, remat=remat), seed=3,
                      device="cpu")
        loss, _ = model.loss(tb)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out.append((loss, grads))
    assert torch.isfinite(out[0][0])
    assert torch.equal(out[0][0], out[1][0])
    for g_full, g_none in zip(out[0][1], out[1][1]):
        assert torch.equal(g_full, g_none)


def _family_batch(cfg, s: int = 64, seed: int = 0) -> dict:
    """Tokens and labels over s positions in all, with the VLM's patches
    or the encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    tok = rng.integers(0, cfg.vocab_size, (2, s - n_img + 1))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    if n_img:
        batch["patches"] = torch.from_numpy(rng.normal(
            0, 1, (2, n_img, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            0, 1, (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_dots_full_and_none_agree_bit_for_bit(arch):
    """Every family at its default dtypes (bf16 compute, f32 parameters):
    remat "dots" (matrix products saved, the rest recomputed), "full" and
    "none" give the same loss and gradients, bit for bit."""
    cfg = reduced(get_config(arch), ssm_chunk=8)
    batch = _family_batch(cfg, seed=4)
    out = {}
    for remat in ("dots", "full", "none"):
        model = Model(dataclasses.replace(cfg, remat=remat), seed=3,
                      device="cpu")
        loss, _ = model.loss(batch)
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    assert torch.isfinite(out["dots"][0])
    for remat in ("full", "none"):
        assert torch.equal(out["dots"][0], out[remat][0]), remat
        for g_dots, g in zip(out["dots"][1], out[remat][1]):
            assert torch.equal(g_dots, g), remat


class _CountProducts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
                torch.ops.aten.baddbmm)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.PRODUCTS:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-medium"])
def test_remat_dots_saves_the_products_and_recomputes_no_forward_one(arch):
    """The products dispatched in the forward and in the backward under each
    policy: "dots" runs as many in its backward as "none" (every forward
    product is saved, none recomputed), "full" runs the forward's again.
    The hybrid's Mamba chunks and whisper's encoder attention halves are
    nested in or beside the blocks' checkpoints."""
    cfg = reduced(get_config(arch), ssm_chunk=8, dtype="float32")
    batch = _family_batch(cfg, seed=5)
    counts = {}
    for remat in ("none", "dots", "full"):
        model = Model(dataclasses.replace(cfg, remat=remat), seed=3,
                      device="cpu")
        with _CountProducts() as fwd:
            loss, _ = model.loss(batch)
        with _CountProducts() as bwd:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[remat] = (fwd.n, bwd.n)
    (f_none, b_none), (f_dots, b_dots), (f_full, b_full) = (
        counts["none"], counts["dots"], counts["full"])
    assert f_none == f_dots == f_full > 0
    assert b_dots == b_none
    assert b_full > b_none + f_none // 2, counts


def test_reference_argument_order_raises():
    """ROADMAP Queue C pin: the port's ``Model`` takes ``params`` after the
    data and its ops drop the reference's tile arguments, so a call in the
    reference's order raises instead of computing something else."""
    from repro_torch.kernels import ops
    cfg = reduced(get_config(ARCH), ssm_chunk=8, dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.params()
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(cfg.vocab_size, s=8).items()}
    with pytest.raises(KeyError, match="tokens"):
        model.loss(params, batch)                 # reference: loss(params, batch)
    with pytest.raises(IndexError):
        model.forward(params, batch["tokens"])    # reference: forward(params, tokens)
    a = torch.rand(2, 5, 5)
    with pytest.raises(TypeError):
        ops.minplus_matmul(a, a, 64)              # reference: bm as 3rd argument
    flow = torch.zeros(4, 4)
    cur = torch.tensor([0, 1])
    with pytest.raises(TypeError):
        ops.flow_accumulate(flow, cur, cur + 1, torch.ones(2), 128)  # bp
