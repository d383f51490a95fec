"""The port's attention-stack layers (``repro_torch.models.layers``,
``mla``, ``ssm.mamba_decode_step``) against the reference's on the CPU:
the same float32 inputs from a numpy seed, the reference's randomly
initialised parameters copied across, every output within rtol 1e-5 /
atol 1e-5 (f32 sums in another order). Also the reference's own
flash-vs-plain check, run on the port.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import mla as RMLA
from repro.models import reduced as ref_reduced
from repro.models import ssm as RSSM

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import reduced
from repro_torch.models import ssm as SSM

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **kw):
    kw = dict(kw, dtype="float32")
    return (ref_reduced(ref_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def _normal(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s), (b, s)).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """LayerNorm with f32 statistics, eps 1e-5, a scale and a bias, in the
    input's dtype (bf16 results equal up to one rounding of the f32
    value)."""
    rng = np.random.default_rng(11)
    x = _normal(rng, 3, 5, 64) * 3 + 1.5
    p = {"scale": _normal(rng, 64), "bias": _normal(rng, 64)}
    init = L.init_layernorm(64)
    ref_init = RL.init_layernorm(64)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(ref_init[k]))
    want = RL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x, dtype))
    got = L.layernorm(_torch_tree(p),
                      torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype).split(".")[-1] == dtype
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_non_causal_flash_masks_padded_keys_the_reference_counts():
    """ROADMAP Queue C: with keys off a multiple of ``block_kv``, no
    ``kv_mask`` and no causal or window mask, the reference's flash
    attention lets its zero-padded keys into the softmax (their positions
    mask nothing here); the port masks them and equals plain attention, and
    equals the reference given a ``kv_mask`` that marks every real key."""
    rng = np.random.default_rng(12)
    b, s, h, dh = 2, 40, 4, 16          # 40 keys in blocks of 16: 8 padded
    q, k, v = (_normal(rng, b, s, h, dh) for _ in range(3))
    pos = _positions(b, s)
    kw = dict(causal=False, block_q=16, block_kv=16)
    got = L.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                            **kw)
    plain = L.attention_scores(*map(torch.from_numpy, (q, k, v, pos, pos)),
                               causal=False)
    _close(got, plain.numpy(), "port flash vs plain")
    jargs = tuple(map(jnp.asarray, (q, k, v, pos, pos)))
    masked = RL.flash_attention(*jargs, kv_mask=jnp.ones((b, s), bool), **kw)
    _close(got, masked, "port vs reference with every real key marked")
    ref = np.asarray(RL.flash_attention(*jargs, **kw))
    assert np.abs(ref - plain.numpy()).max() > 1e-2   # the padded keys count
    # with no key padded the two agree
    full = RL.flash_attention(*(a[:, :32] for a in jargs), **kw)
    _close(L.flash_attention(*(torch.from_numpy(a[:, :32]) for a in
                               (q, k, v, pos, pos)), **kw), full)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5, 0.3])
def test_apply_rope_matches_reference(rotary_pct):
    """Full rotary (qwen) and the partial rotary of glm4 / nemotron (0.5);
    0.3 of 16 rounds down to an even 4."""
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 5000, (2, 9))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                         rotary_pct)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                       rotary_pct)
    _close(got, want)
    d_rot = int(16 * rotary_pct) // 2 * 2
    assert torch.equal(got[..., d_rot:], torch.from_numpy(x)[..., d_rot:])


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp_matches_reference(kind):
    ref_cfg, cfg = _cfgs("qwen2.5-3b", mlp=kind)
    p = RL.init_mlp(jax.random.PRNGKey(1), ref_cfg)
    x = _normal(np.random.default_rng(1), 2, 5, cfg.d_model)
    want = RL.mlp(p, ref_cfg, jnp.asarray(x))
    got = L.mlp(_torch_tree(p), cfg, torch.from_numpy(x))
    _close(got, want)
    assert set(L.init_mlp(torch.Generator(), cfg)) == set(p)


# (heads, kv heads): MHA, qwen's 8-way groups, hymba's 5 and llava's 7
HEADS = [(4, 4), (8, 1), (10, 2), (14, 2)]


def _qkv(rng, b, sq, skv, h, hk, dh, dv=None):
    return (_normal(rng, b, sq, h, dh), _normal(rng, b, skv, hk, dh),
            _normal(rng, b, skv, hk, dv or dh))


@pytest.mark.parametrize("heads", HEADS, ids=[f"{h}x{k}" for h, k in HEADS])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_attention_scores_matches_reference(heads, causal, window):
    h, hk = heads
    rng = np.random.default_rng(h + window)
    b, sq, skv, dh = 2, 7, 11, 8
    q, k, v = _qkv(rng, b, sq, skv, h, hk, dh)
    qp = _positions(b, sq, start=skv - sq)
    kp = _positions(b, skv)
    kv_mask = rng.random((b, skv)) > 0.2
    for mask in (None, kv_mask):
        want = RL.attention_scores(
            *map(jnp.asarray, (q, k, v, qp, kp)), causal=causal,
            window=window,
            kv_mask=None if mask is None else jnp.asarray(mask))
        got = L.attention_scores(
            *map(torch.from_numpy, (q, k, v, qp, kp)), causal=causal,
            window=window,
            kv_mask=None if mask is None else torch.from_numpy(mask))
        _close(got, want, f"kv_mask {mask is not None}")


# (id, sq, skv, block_q, block_kv, causal, window, q_block_start)
FLASH = [
    ("causal", 64, 64, 16, 16, True, 0, 0),
    ("full", 64, 64, 16, 16, False, 0, 0),
    ("banded", 96, 96, 16, 16, True, 20, 0),     # 3 of 6 KV blocks a row
    ("banded_tight", 64, 64, 16, 8, True, 9, 0),
    ("banded_cp_shard", 32, 96, 16, 16, True, 20, 2),
    ("padded", 50, 37, 16, 16, True, 0, 0),      # ragged q and kv
    ("padded_banded", 50, 50, 16, 16, True, 12, 0),
    ("windowed_not_causal", 48, 48, 16, 16, False, 10, 0),
]


@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
@pytest.mark.parametrize("with_mask", [False, True])
def test_flash_attention_matches_reference(case, with_mask):
    _, sq, skv, bq, bkv, causal, window, qbs = case
    rng = np.random.default_rng(sq + skv + window)
    b, h, hk, dh = 2, 6, 2, 8
    q, k, v = _qkv(rng, b, sq, skv, h, hk, dh, dv=12)
    qp = _positions(b, sq, start=qbs * bq)
    kp = _positions(b, skv)
    kv_mask = None
    if with_mask:
        kv_mask = rng.random((b, skv)) > 0.3
        kv_mask[1] = False        # a row with every key masked
    kw = dict(causal=causal, window=window, block_q=bq, block_kv=bkv,
              q_block_start=qbs)
    want = RL.flash_attention(
        *map(jnp.asarray, (q, k, v, qp, kp)),
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask), **kw)
    got = L.flash_attention(
        *map(torch.from_numpy, (q, k, v, qp, kp)),
        kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask), **kw)
    assert got.shape == (b, sq, h, 12)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_fully_masked_rows_give_the_reference_values_not_nan():
    """Every key masked: the reference's -1e30 fill makes softmax uniform
    over the keys (plain) and the online softmax a mean over the visited
    blocks (flash); neither is NaN."""
    rng = np.random.default_rng(5)
    b, s, h, dh = 1, 32, 2, 4
    q, k, v = _qkv(rng, b, s, s, h, h, dh)
    pos = _positions(b, s)
    mask = np.zeros((b, s), bool)
    want_p = RL.attention_scores(*map(jnp.asarray, (q, k, v, pos, pos)),
                                 causal=True, kv_mask=jnp.asarray(mask))
    got_p = L.attention_scores(*map(torch.from_numpy, (q, k, v, pos, pos)),
                               causal=True, kv_mask=torch.from_numpy(mask))
    _close(got_p, want_p)
    np.testing.assert_allclose(got_p.numpy()[0, 0],
                               np.broadcast_to(v.mean(1)[0], (h, dh)),
                               rtol=1e-5, atol=1e-6)
    want_f = RL.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, kv_mask=jnp.asarray(mask),
                                block_q=8, block_kv=8)
    got_f = L.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                              causal=True, kv_mask=torch.from_numpy(mask),
                              block_q=8, block_kv=8)
    assert torch.isfinite(got_f).all()
    _close(got_f, want_f)


def test_flash_attention_matches_plain():
    """The reference's own check (``tests/test_models_smoke.py``), on the
    port."""
    rng = np.random.default_rng(3)
    b, s, h, dh = 2, 96, 4, 16
    q, k, v = (torch.from_numpy(_normal(rng, b, s, h, dh)) for _ in range(3))
    pos = torch.arange(s).expand(b, s)
    for causal in (True, False):
        for window in (0, 24):
            a = L.attention_scores(q, k, v, pos, pos, causal=causal,
                                   window=window)
            f = L.flash_attention(q, k, v, pos, pos, causal=causal,
                                  window=window, block_q=32, block_kv=32)
            np.testing.assert_allclose(a.numpy(), f.numpy(), rtol=2e-3,
                                       atol=2e-3,
                                       err_msg=f"causal={causal} win={window}")


@pytest.mark.parametrize("arch,seq", [("qwen2.5-3b", 40), ("qwen2.5-3b", 64),
                                      ("glm4-9b", 64), ("hymba-1.5b", 80),
                                      ("llava-next-34b", 24)])
def test_attention_sublayer_matches_reference(arch, seq):
    """Projection with the QKV bias (drawn away from zero), rope (partial
    for glm4), the plain form below the chunk threshold (64) and the flash
    form from it (banded for hymba's window), the output projection. The
    reference's uncalled ``kv_override`` is not ported (ROADMAP Queue C)."""
    ref_cfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(seq)
    p = jax.tree.map(np.asarray, RL.init_attention(jax.random.PRNGKey(2),
                                                   ref_cfg))
    for name in ("bq", "bk", "bv"):
        if name in p:
            p[name] = _normal(rng, *p[name].shape)
    x = _normal(rng, 2, seq, cfg.d_model)
    pos = _positions(2, seq)
    want = RL.attention(p, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = L.attention(_torch_tree(p), cfg, torch.from_numpy(x),
                      torch.from_numpy(pos))
    _close(got, want)
    assert set(L.init_attention(torch.Generator(), cfg)) == set(p)
    with pytest.raises(TypeError, match="kv_override"):
        L.attention(_torch_tree(p), cfg, torch.from_numpy(x),
                    torch.from_numpy(pos), kv_override=None)


@pytest.mark.parametrize("q_lora_rank,seq", [(0, 24), (0, 64), (16, 24)])
def test_mla_attention_matches_reference(q_lora_rank, seq):
    """DeepSeek-V2-Lite's direct q projection and a q-LoRA variant, plain
    and flash (64 positions reach the threshold); v head dim 16 against the
    key's 16 + 8."""
    ref_cfg, cfg = _cfgs("deepseek-v2-lite-16b", q_lora_rank=q_lora_rank)
    p = jax.tree.map(np.asarray, RMLA.init_mla(jax.random.PRNGKey(3),
                                               ref_cfg))
    rng = np.random.default_rng(seq + q_lora_rank)
    x = _normal(rng, 2, seq, cfg.d_model)
    pos = _positions(2, seq)
    want = RMLA.mla_attention(p, ref_cfg, jnp.asarray(x), jnp.asarray(pos))
    got = MLA.mla_attention(_torch_tree(p), cfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
    _close(got, want)
    assert set(MLA.init_mla(torch.Generator(), cfg)) == set(p)
    # the compressed cache entries and the queries on their own
    for ref_fn, fn in ((RMLA.mla_compress, MLA.mla_compress),
                       (RMLA.mla_queries, MLA.mla_queries)):
        for g, w in zip(fn(_torch_tree(p), cfg, torch.from_numpy(x),
                           torch.from_numpy(pos)),
                        ref_fn(p, ref_cfg, jnp.asarray(x), jnp.asarray(pos))):
            _close(g, w)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_mamba_decode_step_matches_reference(arch):
    """Six one-token steps from a random cache: outputs, the conv window
    and the f32 state."""
    ref_cfg, cfg = _cfgs(arch)
    p = jax.tree.map(np.asarray, RSSM.init_mamba(jax.random.PRNGKey(4),
                                                 ref_cfg))
    rng = np.random.default_rng(4)
    p["conv_b"] = _normal(rng, *p["conv_b"].shape)
    b = 3
    ref_cache = {"conv": jnp.asarray(_normal(rng, b, cfg.ssm_conv - 1,
                                             cfg.d_inner)),
                 "state": jnp.asarray(_normal(rng, b, cfg.d_inner,
                                              cfg.ssm_state))}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in ref_cache.items()}
    tp = _torch_tree(p)
    empty = SSM.init_mamba_cache(cfg, b, torch.float32)
    want_empty = RSSM.init_mamba_cache(ref_cfg, b, jnp.float32)
    for k in want_empty:
        assert tuple(empty[k].shape) == want_empty[k].shape
        assert empty[k].dtype == torch.float32
    for t in range(6):
        x = _normal(rng, b, 1, cfg.d_model)
        want, ref_cache = RSSM.mamba_decode_step(p, ref_cfg, jnp.asarray(x),
                                                 ref_cache)
        got, cache = SSM.mamba_decode_step(tp, cfg, torch.from_numpy(x),
                                           cache)
        _close(got, want, f"y at step {t}")
        for k in ("conv", "state"):
            _close(cache[k], ref_cache[k], f"{k} at step {t}")


def test_rope_frequencies_and_scores_scale():
    """The frequencies of both packages, and the softmax scale of the MLA
    head: 1/sqrt(nope + rope)."""
    np.testing.assert_allclose(L.rope_frequencies(16, 5e6).numpy(),
                               np.asarray(RL.rope_frequencies(16, 5e6)),
                               rtol=1e-6)
    q = torch.zeros(1, 1, 1, 24)
    q[..., 0] = 1.0
    k = torch.zeros(1, 2, 1, 24)
    k[0, 0, 0, 0] = math.sqrt(24)          # score 1 after the scale
    v = torch.eye(2)[None, :, None, :]
    pos = torch.zeros(1, 2, dtype=torch.int64)
    out = L.attention_scores(q, k, v, pos[:, :1], pos, causal=False)
    e = math.e
    np.testing.assert_allclose(out[0, 0, 0].numpy(),
                               [e / (e + 1), 1 / (e + 1)], rtol=1e-6)


def test_banded_flash_keeps_the_diagonal_where_the_reference_cuts_it():
    """ROADMAP Queue C, a fault of the reference repaired in the port: the
    reference caps the band at nkv offsets from its first block, so with a
    window longer than the sequence (hymba's 2048 at 2048 positions in
    blocks of 1024; here 64 at 64 in blocks of 16) q block 0 visits only
    out-of-range offsets and attends to nothing valid. The port keeps the
    whole band and equals plain windowed attention; where the cap does not
    bind it equals the reference (the cases above)."""
    rng = np.random.default_rng(8)
    b, s, h, dh = 1, 64, 2, 8
    q, k, v = _qkv(rng, b, s, s, h, h, dh)
    pos = _positions(b, s)
    kw = dict(causal=True, window=64)
    plain = RL.attention_scores(*map(jnp.asarray, (q, k, v, pos, pos)), **kw)
    ref = RL.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                             block_q=16, block_kv=16, **kw)
    got = L.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                            block_q=16, block_kv=16, **kw)
    _close(got, plain)
    ref_err = np.abs(np.asarray(ref) - np.asarray(plain)).max(axis=(0, 2, 3))
    assert ref_err[:16].min() > 0.05        # the reference's q block 0
    # the band of 16 + 62 // 16 + 2 = 6 blocks fits a 96-position sequence:
    # there the reference is right and the port equals it
    q, k, v = _qkv(rng, b, 96, 96, h, h, dh)
    pos = _positions(b, 96)
    ref = RL.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                             block_q=16, block_kv=16, **kw)
    got = L.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                            block_q=16, block_kv=16, **kw)
    _close(got, ref)


def test_embedding_gradient_sums_each_token_in_float32():
    """The port gathers the embedding rows in float32 and casts them; the
    reference casts the table first, so its gradient sums each token's
    rows in bf16. The forward is bit-equal. On the data pipeline's
    hymba-1.5b batch (2 x 2048 tokens, one token 1068 times) the port's
    gradient is the exact sum to f32 rounding; the reference's, from
    ``jax.value_and_grad`` in bf16, is about 2.1e-2 (relative L2) off it
    (ROADMAP Queue C), and the gap between the two is pinned below 3e-2."""
    from repro_torch.data import make_pipeline

    cfg = get_config("hymba-1.5b")
    ids = make_pipeline(cfg, 2, 2048, seed=0).batch_at(0)["tokens"]
    rng = np.random.default_rng(0)
    vocab, d = cfg.vocab_size, 64
    table = (rng.normal(0, 1, (vocab, d)) * 0.02).astype(np.float32)
    dy = torch.from_numpy(_normal(rng, 2, 2048, d)).to(torch.bfloat16)

    t = torch.from_numpy(table).requires_grad_(True)
    out = L.embed({"table": t}, torch.from_numpy(ids).long(), torch.bfloat16)
    torch.sum(out.float() * dy.float()).backward()

    def ref_loss(tb):
        x = RL.embed({"table": tb}, jnp.asarray(ids), jnp.bfloat16)
        return jnp.sum(x.astype(jnp.float32) *
                       jnp.asarray(dy.float().numpy()))

    ref_out = RL.embed({"table": jnp.asarray(table)}, jnp.asarray(ids),
                       jnp.bfloat16)
    _, ref_grad = jax.value_and_grad(ref_loss)(jnp.asarray(table))
    assert np.array_equal(out.detach().float().numpy(),
                          np.asarray(ref_out.astype(jnp.float32)))
    exact = np.zeros((vocab, d))
    np.add.at(exact, ids.ravel(),
              dy.float().numpy().reshape(-1, d).astype(np.float64))
    scale = np.linalg.norm(exact)
    port = t.grad.numpy()
    ref = np.asarray(ref_grad)
    assert np.linalg.norm(port - exact) / scale < 1e-6
    assert np.linalg.norm(port - ref) / scale < 3e-2
    assert np.linalg.norm(ref - exact) > np.linalg.norm(port - exact)
