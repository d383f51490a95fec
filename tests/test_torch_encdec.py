"""The port's encoder-decoder family (whisper-medium: LayerNorm blocks, the
encoder over stub frame embeddings, cross-attention, learned positions, the
cross-KV cache) against the reference on the CPU at
``reduced(cfg, dtype="float32")``, with the reference's randomly
initialised parameters carried across (``models/convert``).

The cross-KV cache is filled from the encoder by hand in both packages, as
the reference's smoke test does (``tests/test_models_smoke.py``): nothing in
the reference fills it. Tolerances: hidden states, the encoder output,
losses, logits and caches within rtol 1e-5 / atol 1e-5 (f32 sums in
another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import layers as RL
from repro.models import reduced as ref_reduced

from repro_torch.configs import get_config
from repro_torch.models import Model, reduced
from repro_torch.models import layers as L
from repro_torch.models.convert import (flatten_reference,
                                        load_reference_params)

ARCH = "whisper-medium"
TOL = dict(rtol=1e-5, atol=1e-5)
_PAIRS = {}


def _pair(**kw):
    """(reference model, its params, port model with those params)."""
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        kw = dict(kw, dtype="float32")
        ref_model = RefModel(ref_reduced(ref_get_config(ARCH), **kw))
        params = jax.tree.map(np.asarray,
                              ref_model.init_params(jax.random.PRNGKey(0)))
        model = Model(reduced(get_config(ARCH), **kw), device="cpu")
        load_reference_params(model, params)
        _PAIRS[key] = (ref_model, params, model)
    return _PAIRS[key]


def _batch(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    frames = rng.normal(0, 1, (b, cfg.n_audio_frames, cfg.d_model))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "frames": frames.astype(np.float32)}


def _t(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
                else torch.from_numpy(v)) for k, v in batch.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def test_whisper_parameters_carry_across_with_the_reference_names():
    ref_model, params, model = _pair()
    cfg = model.cfg
    assert cfg.family == "encdec" and cfg.n_encoder_layers == 2
    named = dict(model.named_parameters())
    flat = flatten_reference(params)
    assert flat.keys() == named.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(named[k].detach().numpy(), v,
                                      err_msg=k)
    assert named["pos_embed"].shape == (32768 + cfg.n_audio_frames,
                                        cfg.d_model)
    assert set(named["blocks.0.ln_cross.bias"].shape) == {cfg.d_model}
    assert "enc_blocks.1.mlp.wi" in named and "enc_ln_f.bias" in named
    tree = model.params()
    assert set(tree) == set(params)
    assert set(tree["enc_blocks"][0]) == set(params["enc_blocks"])
    # the port's own tree loads into another model
    other = Model(cfg, seed=3, device="cpu")
    load_reference_params(other, jax.tree.map(
        lambda t: t.detach().numpy(), tree))
    assert torch.equal(other.pos_embed, model.pos_embed)


def test_encoder_forward_loss_and_prefill_match_reference():
    ref_model, params, model = _pair()
    batch = _batch(model.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _t(batch)
    want_enc, want_pos = ref_model._encode(params, jb["frames"])
    with torch.no_grad():
        got_enc, got_pos = model._encode(tb["frames"])
        got_x, got_aux = model(tb["tokens"], extra={"frames": tb["frames"]})
        loss, metrics = model.loss(tb)
    _close(got_enc, want_enc, "encoder output")
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    want_x, want_aux = ref_model.forward(params, jb["tokens"],
                                         extra={"frames": jb["frames"]})
    _close(got_x, want_x, "hidden")
    assert float(got_aux) == float(want_aux) == 0.0
    want_loss, want_m = ref_model.loss(params, jb)
    _close(loss, want_loss, "loss")
    _close(metrics["ce"], want_m["ce"], "ce")
    assert int(metrics["tokens"]) == int(want_m["tokens"])
    want_p = ref_model.prefill(params, jb["tokens"],
                               extra={"frames": jb["frames"]})
    got_p = model.prefill(tb["tokens"], extra={"frames": tb["frames"]})
    assert got_p.shape == (2, 1, model.cfg.vocab_size)
    _close(got_p, want_p, "prefill")


def _ref_cross_kv(ref_model, params, enc_out):
    """The reference smoke test's hand fill of the cross-KV cache."""
    dt = ref_model.cfg.compute_dtype
    n = ref_model.cfg.n_layers
    layer = lambda i: jax.tree.map(lambda x: x[i], params["blocks"])
    return tuple(jnp.stack([
        jnp.einsum("bsd,dhk->bshk", enc_out,
                   jnp.asarray(layer(i)["cross"][w]).astype(dt))
        for i in range(n)]) for w in ("wk", "wv"))


def test_every_decode_step_and_cache_match_reference():
    """Token-by-token decode over 12 positions with the cross-KV cache
    filled from the encoder: each step's logits and the whole cache after
    it."""
    ref_model, params, model = _pair()
    cfg = model.cfg
    b, s = 2, 12
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    frames = rng.normal(0, 1, (b, cfg.n_audio_frames, cfg.d_model)).astype(
        np.float32)
    ref_cache = ref_model.init_cache(b, s)
    cache = model.init_cache(b, s)
    assert set(cache) == set(ref_cache) == {"scan", "cross_k", "cross_v"}
    for k in ("cross_k", "cross_v"):
        assert tuple(cache[k].shape) == ref_cache[k].shape
        assert not cache[k].any()
    enc, _ = ref_model._encode(params, jnp.asarray(frames))
    ref_cache["cross_k"], ref_cache["cross_v"] = _ref_cross_kv(
        ref_model, params, enc)
    with torch.no_grad():
        got_enc, _ = model._encode(torch.from_numpy(frames))
    cache["cross_k"], cache["cross_v"] = model.cross_kv(got_enc)
    _close(cache["cross_k"], ref_cache["cross_k"], "cross_k")
    _close(cache["cross_v"], ref_cache["cross_v"], "cross_v")
    step = jax.jit(ref_model.decode_step)
    for t in range(s):
        want_lg, ref_cache = step(params, ref_cache,
                                  jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                  jnp.asarray(t, jnp.int32))
        got_lg, cache = model.decode_step(
            cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        _close(got_lg, want_lg, f"logits at step {t}")
        for k in ("k", "v"):
            _close(cache["scan"][k], ref_cache["scan"][k],
                   f"cache {k} after step {t}")
        for k in ("cross_k", "cross_v"):
            _close(cache[k], ref_cache[k], f"{k} after step {t}")


def test_decode_matches_forward_with_the_encoder_attended():
    """The reference's decode-vs-forward bound (rtol/atol 0.05) on the port
    in bf16: decode with the cross-KV cache filled from the encoder against
    the forward's logits over the same frames."""
    cfg = reduced(get_config(ARCH), attn_chunk_q=0)
    model = Model(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    b, s = 2, 12
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    frames = torch.from_numpy(rng.normal(
        0, 1, (b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        x, _ = model(tokens, extra={"frames": frames})
        full = L.unembed(model.params()["unembed"], x, 0.0).float()
        enc, _ = model._encode(frames.to(cfg.compute_dtype))
    cache = model.init_cache(b, s)
    cache["cross_k"], cache["cross_v"] = model.cross_kv(enc)
    dec = [model.decode_step(cache, tokens[:, t:t + 1], t)[0][:, 0].float()
           for t in range(s)]
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(),
                               rtol=0.05, atol=0.05)


def test_encoder_at_72_frames_masks_the_padded_keys_the_reference_counts():
    """ROADMAP Queue C: 72 frames reach the encoder's flash attention
    (threshold 64) in key blocks of 32, so 24 keys are padded. The
    reference's non-causal flash counts the zero keys; the port masks
    them, so its encoder equals the reference's computed with every frame
    marked in a ``kv_mask`` (here through the plain scores, which flash
    equals), and the reference's own encoder differs."""
    ref_model, params, model = _pair(n_audio_frames=72)
    cfg = model.cfg
    assert cfg.n_audio_frames >= cfg.attn_chunk_threshold
    assert cfg.n_audio_frames % cfg.attn_chunk_kv
    frames = np.random.default_rng(4).normal(
        0, 1, (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        got, _ = model._encode(torch.from_numpy(frames))
    want_ref, _ = ref_model._encode(params, jnp.asarray(frames))
    flash = RL.flash_attention
    RL.flash_attention = lambda q, k, v, qp, kp, **kw: flash(
        q, k, v, qp, kp, **dict(kw, kv_mask=jnp.ones(k.shape[:2], bool)))
    try:
        want_masked, _ = ref_model._encode(params, jnp.asarray(frames))
    finally:
        RL.flash_attention = flash
    _close(got, want_masked, "encoder with the padded keys masked")
    assert np.abs(got.numpy() - np.asarray(want_ref)).max() > 1e-3
    # at the reduced 24 frames (below the threshold) the two agree
    ref24, p24, m24 = _pair()
    f24 = frames[:, :24]
    with torch.no_grad():
        _close(m24._encode(torch.from_numpy(f24))[0],
               ref24._encode(p24, jnp.asarray(f24))[0], "24 frames")
