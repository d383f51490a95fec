"""The port's serving path (``repro_torch.models.Model``: forward, loss,
init_cache, decode_step, prefill; ``repro_torch.launch.serve``) against the
reference on the CPU, for each of the nine decoder-only configs reduced to
CPU size in float32, with the reference's randomly initialised parameters
carried across (``models/convert.load_reference_params``; the attention
biases drawn away from their zero init so they count).

Tolerances: hidden states, losses, the MoE aux loss, logits and caches
within rtol 1e-5 / atol 1e-5 (f32 sums in another order); greedy tokens
exactly equal. The reference's own decode-vs-forward checks
(``tests/test_models_smoke.py``, ``tests/test_moe_cache.py``) are run on
the port with their bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.launch.serve import generate as ref_generate
from repro.models import Model as RefModel
from repro.models import reduced as ref_reduced

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.serve import generate, main
from repro_torch.models import Model, reduced
from repro_torch.models import layers as L
from repro_torch.models.convert import (flatten_reference,
                                        load_reference_params)

TOL = dict(rtol=1e-5, atol=1e-5)
DECODER_ARCHS = tuple(a for a in ARCH_IDS if a != "whisper-medium")
# (case id, arch, overrides of reduced()): every decoder-only config, and
# hymba with a ring buffer shorter than the decode run
CASES = tuple((a, a, {}) for a in DECODER_ARCHS) + (
    ("hymba-1.5b-ring", "hymba-1.5b", {"window": 8}),)
PROMPT, NEW = 6, 6


def _perturb(tree, rng):
    """The reference's tree with its zero-initialised attention biases drawn
    at random, so that qkv_bias is exercised."""
    if isinstance(tree, dict):
        return {k: (rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
                    if k in ("bq", "bk", "bv") else _perturb(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return np.asarray(tree)


_PAIRS = {}


def _pair(case):
    """(reference model, its params, port model with those params), built
    once per case for the module."""
    if case not in _PAIRS:
        _, arch, kw = next(c for c in CASES if c[0] == case)
        kw = dict(kw, dtype="float32")
        ref_model = RefModel(ref_reduced(ref_get_config(arch), **kw))
        params = _perturb(jax.tree.map(
            np.asarray, ref_model.init_params(jax.random.PRNGKey(0))),
            np.random.default_rng(7))
        model = Model(reduced(get_config(arch), **kw), device="cpu")
        load_reference_params(model, params)
        _PAIRS[case] = (ref_model, params, model)
    return _PAIRS[case]


def _inputs(cfg, b=2, s=64, seed=0):
    """Text tokens, labels and (VLM) patches: s positions in all, so the
    attention takes the flash form at reduced()'s threshold of 64."""
    rng = np.random.default_rng(seed)
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    tok = rng.integers(0, cfg.vocab_size, (b, s - n_img + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if n_img:
        batch["patches"] = rng.normal(0, 1, (b, n_img, cfg.d_model)).astype(
            np.float32)
    return batch


def _t(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
                else torch.from_numpy(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, want, what: str):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_forward_loss_and_prefill_match_reference(case):
    ref_model, params, model = _pair(case)
    cfg = model.cfg
    batch = _inputs(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _t(batch)
    extra = {k: v for k, v in jb.items() if k == "patches"}
    textra = {k: v for k, v in tb.items() if k == "patches"}

    want_x, want_aux = ref_model.forward(params, jb["tokens"], extra=extra)
    with torch.no_grad():
        got_x, got_aux = model(tb["tokens"], extra=textra)
        loss, metrics = model.loss(tb)
    _close(got_x, want_x, "hidden")
    _close(got_aux, want_aux, "aux")
    want_loss, want_m = ref_model.loss(params, jb)
    _close(loss, want_loss, "loss")
    _close(metrics["aux"], want_m["aux"], "loss aux")
    assert int(metrics["tokens"]) == int(want_m["tokens"])
    if cfg.is_moe:
        assert float(got_aux) > 0.5      # the aux loss is carried, not zero
    want_p = ref_model.prefill(params, jb["tokens"], extra=extra)
    got_p = model.prefill(tb["tokens"], extra=textra)
    assert got_p.shape == (2, 1, cfg.vocab_size)
    _close(got_p, want_p, "prefill")


_REF_STEPS = {}


def _ref_step(case):
    if case not in _REF_STEPS:
        _REF_STEPS[case] = jax.jit(_pair(case)[0].decode_step)
    return _REF_STEPS[case]


def _flat_cache(cache) -> dict:
    out = {}
    for k, v in cache["scan"].items():
        out[f"scan.{k}"] = v
    for i, c in enumerate(cache.get("dense", [])):
        for k, v in c.items():
            out[f"dense.{i}.{k}"] = v
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_every_decode_step_and_cache_match_reference(case):
    """Token-by-token decode over 12 positions: each step's logits and the
    whole cache after it (the hymba ring case wraps its 8 slots)."""
    ref_model, params, model = _pair(case)
    cfg = model.cfg
    b, s = 2, 12
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    ref_cache = ref_model.init_cache(b, s)
    cache = model.init_cache(b, s)
    want_keys = _flat_cache(jax.tree.map(np.asarray, ref_cache))
    got_keys = _flat_cache(cache)
    assert want_keys.keys() == got_keys.keys()
    for k in want_keys:
        assert tuple(got_keys[k].shape) == want_keys[k].shape, k
        assert str(got_keys[k].dtype).split(".")[-1] == str(
            want_keys[k].dtype), k
    step = _ref_step(case)
    for t in range(s):
        want_lg, ref_cache = step(params, ref_cache,
                                  jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                  jnp.asarray(t, jnp.int32))
        got_lg, cache = model.decode_step(
            cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        _close(got_lg, want_lg, f"logits at step {t}")
        want_c = _flat_cache(jax.tree.map(np.asarray, ref_cache))
        for k, v in _flat_cache(cache).items():
            _close(v, want_c[k], f"cache {k} after step {t}")


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_generate_greedy_tokens_equal_reference(case):
    ref_model, params, model = _pair(case)
    prompts = np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (3, PROMPT))
    want = ref_generate(ref_model, params, prompts, NEW)
    got = generate(model, prompts, NEW)
    assert got.shape == (3, NEW)
    np.testing.assert_array_equal(got, want)


# -- the reference's own checks, on the port ---------------------------------

def _decode_vs_forward(cfg, seed, b, s, tol):
    model = Model(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    with torch.no_grad():
        x, _ = model(tokens)
        full = L.unembed(model.params()["unembed"], x, 0.0).float()
    cache = model.init_cache(b, s)
    dec = []
    for t in range(s):
        lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
        dec.append(lg[:, 0].float())
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(),
                               **tol)
    return cache


def test_decode_matches_forward_gqa():
    """Token-by-token decode reproduces the full forward logits (bf16)."""
    _decode_vs_forward(reduced(get_config("qwen2.5-3b"), attn_chunk_q=0),
                       1, 2, 12, dict(rtol=0.05, atol=0.05))


def test_decode_matches_forward_ssm():
    _decode_vs_forward(reduced(get_config("falcon-mamba-7b"), ssm_chunk=4),
                       2, 2, 8, dict(rtol=0.05, atol=0.05))


def test_sliding_window_ring_cache_matches_forward():
    """hymba decode with a ring buffer smaller than the sequence matches the
    windowed full forward at every step."""
    cfg = reduced(get_config("hymba-1.5b"), window=16, attn_chunk_q=0,
                  ssm_chunk=4)
    cache = _decode_vs_forward(cfg, 0, 2, 40, dict(rtol=0.06, atol=0.06))
    assert cache["scan"]["k"].shape[2] == cfg.window


def test_param_counts_match_config_estimate():
    for arch in ("qwen2.5-3b", "olmoe-1b-7b", "falcon-mamba-7b"):
        cfg = reduced(get_config(arch))
        actual = sum(p.numel() for p in Model(cfg, device="cpu").parameters())
        est = cfg.n_params()
        # estimate ignores norms/biases/pos-embeds: within 20%
        assert abs(actual - est) / actual < 0.2, (arch, actual, est)


# -- the port's own rules ------------------------------------------------------

def test_dense_blocks_round_trip_through_convert():
    """DeepSeek's list of leading dense blocks lands in ``dense_blocks.<i>``
    and comes back out of ``Model.params()`` as the reference's list; the
    port's own tree (blocks as a list) loads into another model."""
    ref_model, params, model = _pair("deepseek-v2-lite-16b")
    assert isinstance(params["dense_blocks"], list)
    flat = flatten_reference(params)
    assert any(k.startswith("dense_blocks.0.mlp.") for k in flat)
    back = flatten_reference(jax.tree.map(
        lambda t: t.detach().numpy(), model.params()))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    tree = model.params()
    assert set(tree) == set(params)
    assert set(tree["dense_blocks"][0]) == set(params["dense_blocks"][0])
    assert set(tree["blocks"][0]["mlp"]) == set(params["blocks"]["mlp"])
    other = Model(model.cfg, seed=1, device="cpu")
    load_reference_params(other, jax.tree.map(
        lambda t: t.detach().numpy(), tree))
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 other.named_parameters()):
        assert torch.equal(p, q), name


def test_decode_step_updates_the_cache_in_place():
    """ROADMAP Queue C: the port's decode step writes into the cache it is
    given and returns that object (the reference returns a new tree)."""
    model = _pair("qwen2.5-3b")[2]
    cache = model.init_cache(1, 4)
    k0 = cache["scan"]["k"]
    _, out = model.decode_step(cache, torch.tensor([[3]]), 0)
    assert out is cache and out["scan"]["k"] is k0
    assert k0[:, :, 0].abs().sum() > 0 and k0[:, :, 1:].abs().sum() == 0


def test_decode_beyond_the_cache_raises():
    """ROADMAP Queue C: a position past the cache raises, where XLA's
    dynamic_update_slice clamps the write into the last slot."""
    model = _pair("qwen2.5-3b")[2]
    cache = model.init_cache(1, 2)
    with pytest.raises(ValueError, match="beyond the cache"):
        model.decode_step(cache, torch.tensor([[3]]), 2)


def test_temperature_sampling_is_deterministic():
    """ROADMAP Queue C: temperature draws come from a torch.Generator
    seeded with ``seed``: the same seed gives the same tokens, another
    seed others. It is not jax.random's stream, so only determinism is
    held."""
    model = _pair("olmoe-1b-7b")[2]
    prompts = np.random.default_rng(3).integers(0, 256, (2, 4))
    a = generate(model, prompts, 8, temperature=1.0, seed=5)
    b = generate(model, prompts, 8, temperature=1.0, seed=5)
    c = generate(model, prompts, 8, temperature=1.0, seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < model.cfg.vocab_size


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_serve_cli_runs_every_decoder_config_on_the_cpu(arch):
    out = main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "4", "--max-new", "3"])
    assert out.shape == (2, 3)


def test_serve_cli_rejects_whisper_with_the_reference_message():
    with pytest.raises(SystemExit, match="decoder-only archs"):
        main(["--arch", "whisper-medium", "--reduced", "--device", "cpu"])


def test_hymba_prefill_hands_the_scan_aligned_rows_at_its_width():
    """B7's 16-byte row copies need Di % 4 == 0 and 16-byte aligned
    pointers (``csrc/selective_scan.cu``'s ``vec_x``/``vec_bc``): at
    hymba's d_inner of 3200 the prefill hands the scan contiguous, aligned
    tensors (B and C copied out of their x_proj slices), so the card takes
    the vector path."""
    from repro_torch.kernels import ops

    cfg = reduced(get_config("hymba-1.5b"), d_model=1600, d_head=64,
                  n_heads=25, n_kv_heads=5, n_layers=1, ssm_state=16,
                  ssm_kernel=True, dtype="float32")
    assert cfg.d_inner == 3200
    model = Model(cfg, device="cpu")
    seen = []
    route = ops.selective_scan_fwd

    def record(*args, chunk):
        seen.append([(t.is_contiguous(), t.data_ptr() % 16) for t in
                     (t.contiguous() for t in args)])
        return route(*args, chunk=chunk)

    ops.selective_scan_fwd = record
    try:
        model.prefill(torch.zeros((1, 32), dtype=torch.int64))
    finally:
        ops.selective_scan_fwd = route
    assert len(seen) == 1
    assert all(contig and off == 0 for contig, off in seen[0])
