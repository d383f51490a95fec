"""Training of every family but the SSM one (which ``test_torch_model.py``
holds) against the reference on the CPU: ``Model.loss`` and every gradient
leaf against ``jax.value_and_grad`` of the reference's loss at
``reduced(cfg, dtype="float32")``, with the reference's randomly
initialised parameters carried across (the attention biases drawn away
from their zero init so they count). One config a family: qwen2.5-3b
(dense, qkv bias), olmoe-1b-7b (MoE), deepseek-v2-lite-16b (MLA, MoE after
a dense first layer), hymba-1.5b (hybrid; the plain scan on the CPU),
llava-next-34b (VLM patch prefix) and whisper-medium (encoder-decoder).

Bounds (PR 13's, ``tests/test_torch_model.py``): the loss within rtol
1e-5, every gradient leaf within rtol 1e-3 / atol 1e-5 (f32 sums in
another order through two layers, flash attention and a chunked
cross-entropy).

hymba runs at 128 positions. At ``reduced`` widths its sliding window is
32 in blocks of 32 with the flash threshold at 64, so the reference's band
is ``(32 + 32 - 2) // 32 + 2 = 3`` blocks, capped at ``nkv``: at 64
positions (nkv 2) the cap binds and the reference drops diagonal blocks
(ROADMAP Queue C), at 128 (nkv 4) it does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import reduced as ref_reduced

from repro_torch.configs import get_config
from repro_torch.models import Model, reduced
from repro_torch.models.convert import (flatten_reference,
                                        load_reference_params)

# (arch, positions in all: patches + text for the VLM)
FAMILIES = (("qwen2.5-3b", 64), ("olmoe-1b-7b", 64),
            ("deepseek-v2-lite-16b", 64), ("hymba-1.5b", 128),
            ("llava-next-34b", 64), ("whisper-medium", 64))


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                    if k in ("bq", "bk", "bv") else _perturb(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return np.asarray(tree)


def _batch(cfg, s, b=2, seed=0):
    rng = np.random.default_rng(seed)
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    tok = rng.integers(0, cfg.vocab_size, (b, s - n_img + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if n_img:
        batch["patches"] = rng.normal(0, 1, (b, n_img, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            0, 1, (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,seq", FAMILIES)
def test_loss_and_every_gradient_match_reference(arch, seq):
    ref_model = RefModel(ref_reduced(ref_get_config(arch), dtype="float32"))
    params = _perturb(jax.tree.map(
        np.asarray, ref_model.init_params(jax.random.PRNGKey(0))),
        np.random.default_rng(7))
    model = Model(reduced(get_config(arch), dtype="float32"), device="cpu")
    load_reference_params(model, params)
    if arch == "hymba-1.5b":
        cfg = model.cfg
        nkv = seq // cfg.attn_chunk_kv
        n_band = (cfg.attn_chunk_q + cfg.window - 2) // cfg.attn_chunk_kv + 2
        assert seq >= cfg.attn_chunk_threshold and nkv >= n_band
    batch = _batch(model.cfg, seq)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
              else torch.from_numpy(v)) for k, v in batch.items()}

    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(params, jb)
    loss, metrics = model.loss(tb)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    assert int(metrics["tokens"]) == int(want_m["tokens"])
    if model.cfg.is_moe:
        assert float(metrics["aux"].detach()) == pytest.approx(
            float(want_m["aux"]), rel=1e-5)
    ref_grads = flatten_reference(jax.tree.map(np.asarray, want_g))
    assert set(ref_grads) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[name], rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    assert any(float(g.abs().max()) > 0 for g in grads)
