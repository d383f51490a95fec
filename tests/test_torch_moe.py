"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
on the CPU: the same float32 inputs from a numpy seed and the reference's
randomly initialised parameters copied across; y and the aux loss within
rtol 1e-5 / atol 1e-5. Pinned: a top-k tie takes the lower expert index as
``jax.lax.top_k`` does, and one-hot rows of out-of-range positions (unrouted
slots, capacity overflow) are zero as ``jax.nn.one_hot``'s are. Then the
reference's own MoE checks (``tests/test_moe_cache.py``), on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.models import moe as RMOE
from repro.models import reduced as ref_reduced

from repro_torch.configs import get_config
from repro_torch.models import moe as MOE
from repro_torch.models import reduced

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, **kw):
    kw = dict(kw, dtype="float32")
    return (ref_reduced(ref_get_config(arch), **kw),
            reduced(get_config(arch), **kw))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _run_both(arch, x, seed=0, zero_router=False, **kw):
    ref_cfg, cfg = _cfgs(arch, **kw)
    p = jax.tree.map(np.asarray, RMOE.init_moe(jax.random.PRNGKey(seed),
                                               ref_cfg))
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    want_y, want_aux = RMOE.moe_ffn(p, ref_cfg, jnp.asarray(x))
    got_y, got_aux = MOE.moe_ffn(_torch_tree(p), cfg, torch.from_numpy(x))
    return (got_y, got_aux), (np.asarray(want_y), np.asarray(want_aux)), p


def _check(got, want):
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)


# (id, arch, overrides, tokens per sequence)
MOE_CASES = [
    ("olmoe", "olmoe-1b-7b", {}, 64),
    ("olmoe_groups", "olmoe-1b-7b", {"moe_group_size": 32}, 64),
    ("deepseek_shared", "deepseek-v2-lite-16b", {}, 64),
    ("olmoe_relu2", "olmoe-1b-7b", {"mlp": "relu2"}, 64),
    ("olmoe_gelu", "olmoe-1b-7b", {"mlp": "gelu"}, 64),
    ("decode_group_is_the_batch", "deepseek-v2-lite-16b", {}, 1),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_ffn_matches_reference(case):
    _, arch, kw, s = case
    ref_cfg, cfg = _cfgs(arch, **kw)
    x = np.random.default_rng(s).normal(0, 1, (2, s, cfg.d_model)).astype(
        np.float32)
    got, want, p = _run_both(arch, x, **kw)
    _check(got, want)
    assert float(got[1]) > 0.5
    assert set(MOE.init_moe(torch.Generator(), cfg)) == set(p)


def test_overflow_is_dropped_as_in_the_reference():
    """Capacity well below the load: positions >= capacity drop their
    token's choice (a zero one-hot row and a zero gate)."""
    ref_cfg, cfg = _cfgs("olmoe-1b-7b", capacity_factor=0.3)
    x = np.random.default_rng(9).normal(0, 1, (1, 64, cfg.d_model)).astype(
        np.float32)
    got, want, _ = _run_both("olmoe-1b-7b", x, capacity_factor=0.3)
    _check(got, want)
    assert MOE._capacity(cfg, 64) < 64 * cfg.top_k / cfg.n_experts


def test_top_k_tie_takes_the_lower_index():
    """A planted tie: a zero router gives every expert the same probability,
    so the reference routes every token to experts 0..k-1. The port's stable
    order does the same; y and aux equal the reference's."""
    ref_cfg, cfg = _cfgs("olmoe-1b-7b", capacity_factor=8.0)
    x = np.random.default_rng(2).normal(0, 1, (2, 32, cfg.d_model)).astype(
        np.float32)
    got, want, _ = _run_both("olmoe-1b-7b", x, zero_router=True,
                             capacity_factor=8.0)
    _check(got, want)
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 4)
    got_v, got_i = MOE._top_k(torch.from_numpy(probs), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i.tolist() == [[1, 2, 4, 3]]


def test_one_hot_out_of_range_is_a_zero_row():
    idx = np.array([[-1, 0, 3, 4, 7]], np.int32)
    want = jax.nn.one_hot(jnp.asarray(idx), 4, dtype=jnp.float32)
    got = MOE._one_hot(torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0].sum() == 0 and got[0, 3].sum() == 0


def test_token_count_must_divide_into_groups():
    _, cfg = _cfgs("olmoe-1b-7b", moe_group_size=48)
    p = MOE.init_moe(torch.Generator(), cfg)
    with pytest.raises(ValueError, match="not divisible"):
        MOE.moe_ffn(p, cfg, torch.zeros(1, 64, cfg.d_model))


# -- the reference's own checks (tests/test_moe_cache.py), on the port --------

def _moe_cfg(**kw):
    base = dict(n_experts=8, top_k=2, moe_d_ff=32, n_shared_experts=0,
                capacity_factor=1.25, moe_group_size=64)
    base.update(kw)
    return reduced(get_config("olmoe-1b-7b"), **base)


def _init(cfg, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return MOE.init_moe(gen, cfg)


def test_moe_gates_normalized_and_capacity():
    cfg = _moe_cfg()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 64, cfg.d_model)).astype(np.float32))
    y, aux = MOE.moe_ffn(_init(cfg, 0), cfg, x)
    assert y.shape == x.shape
    assert torch.isfinite(y).all()
    assert float(aux) > 0.5   # aux loss ~1 at uniform routing


def test_moe_capacity_formula():
    cfg = _moe_cfg()
    assert MOE._capacity(cfg, 64) == max(int(64 * 2 * 1.25 / 8), 2)


def test_moe_capacity_drops_overflow():
    """With capacity_factor ~0 most tokens overflow: the output shrinks."""
    cfg = _moe_cfg(capacity_factor=1e-6)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, cfg.d_model)).astype(np.float32))
    y, _ = MOE.moe_ffn(_init(cfg, 0), cfg, x)
    base_cfg = _moe_cfg()
    y_full, _ = MOE.moe_ffn(_init(base_cfg, 0), base_cfg, x)
    assert float(y.abs().mean()) < float(y_full.abs().mean())


def test_moe_permutation_equivariance():
    """Permuting tokens within a group permutes outputs identically (with
    capacity generous enough that no token drops)."""
    p = _init(_moe_cfg(), 2)
    rng = np.random.default_rng(3)
    cfg_big = _moe_cfg(capacity_factor=8.0)
    x = torch.from_numpy(rng.normal(0, 1, (1, 64, cfg_big.d_model)).astype(
        np.float32))
    perm = torch.from_numpy(rng.permutation(64))
    y1, _ = MOE.moe_ffn(p, cfg_big, x)
    y2, _ = MOE.moe_ffn(p, cfg_big, x[:, perm])
    np.testing.assert_allclose(y2.numpy(), y1[:, perm].numpy(), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.parametrize("ways", (2, 4))
@pytest.mark.parametrize("rows,total,g", ((1, 64, 64), (2, 64, 128),
                                          (2, 96, 64)))
def test_block_capacity_positions_equal_one_devices(ways, rows, total, g):
    """A prompt in ``ways`` blocks of each row (a long-context prefill's
    data ranks) whose routing groups of ``g`` tokens of the flattened batch
    span blocks (and, at 2 x 64 in one group of 128 or 2 x 96 in groups of
    64, rows): each block's capacity positions, from its own pairs and the
    counts of the blocks before it in the flattened order
    (``sharding.spmd.counts_before``), equal one device's cumulative sum
    over the whole group; the blocks' counts add up to each group's."""
    from repro_torch.sharding.spmd import counts_before
    rng = np.random.default_rng(ways * 7 + rows + total)
    e, k = 8, 2
    idx = torch.as_tensor(np.argsort(rng.random((rows, total, e)),
                                     axis=-1)[..., :k])
    probs = torch.softmax(torch.as_tensor(
        rng.normal(0, 1, (rows, total, e)), dtype=torch.float32), -1)
    onehot = MOE._one_hot(idx, e)                       # [B,S,k,E]
    # one device: the pairs' running count over each group, in order
    groups = onehot.reshape(rows * total // g, g * k, e)
    one = (torch.cumsum(groups, dim=1).reshape(rows, total, k, e) *
           onehot - 1.0)
    n = total // ways
    blocks = [(j * n, n, total) for j in range(ways)]
    every = torch.stack([MOE.block_counts(
        onehot[:, s:s + n].reshape(rows * n, k, e),
        probs[:, s:s + n].reshape(rows * n, e),
        idx[:, s:s + n].reshape(rows * n, k), rows, blk, g)
        for blk in blocks for s in (blk[0],)])
    for j, (s, _, _) in enumerate(blocks):
        before, totals = counts_before(every, j)
        got = MOE.block_positions(onehot[:, s:s + n].reshape(rows * n, k, e),
                                  rows, blocks[j], g, before[:, :, 0])
        assert torch.equal(got, one[:, s:s + n].reshape(rows * n, k, e)), j
    assert torch.equal(totals[:, 0], groups.sum(dim=1))
    assert torch.allclose(totals[:, 1], probs.reshape(-1, g, e).sum(1))
