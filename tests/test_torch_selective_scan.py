"""The port's selective scan (``repro_torch.kernels.selective_scan``) against
the reference's Pallas kernels, run as the reference's own tests run them on
the CPU (``interpret=True``), on the same inputs made with numpy.

Tolerances: the forward within rtol 1e-5 / atol 1e-6 and the gradients
within rtol 1e-4 / atol 1e-5 of the reference kernels, tighter than the
reference's own bounds against its recurrence (forward rtol 1e-4 / atol
1e-5, gradients rtol 2e-3 / atol 5e-4, ``tests/test_selective_scan.py``):
both sides are f32 recurrences that sum over N and over channels in other
orders. Against ``torch.autograd`` of the port's own plain forward the
transcribed backward agrees within rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from repro.kernels import selective_scan as ref_ss

from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as ss

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
NAMES = ("dxc", "ddt", "dbm", "dcm", "da", "dh0")


def _inputs(B=2, S=32, Di=16, N=4, seed=0):
    """The reference tests' inputs (tests/test_selective_scan.py:_inputs),
    plus a cotangent dy."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    return (f32(rng.normal(0, 1, (B, S, Di))),
            f32(rng.uniform(0.01, 0.2, (B, S, Di))),
            f32(rng.normal(0, 1, (B, S, N))), f32(rng.normal(0, 1, (B, S, N))),
            f32(-rng.uniform(0.5, 2.0, (Di, N))),
            f32(rng.normal(0, 0.3, (B, Di, N))),
            f32(rng.normal(0, 1, (B, S, Di))))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk,bd", [(8, 8), (16, 16), (32, 16), (8, 4)])
def test_forward_matches_reference_kernel(chunk, bd):
    *args, _ = _inputs()
    want = ref_ss.selective_scan_fwd(*map(jnp.asarray, args), chunk=chunk,
                                     bd=bd)
    got = ss.selective_scan_fwd_plain(*_t(args), chunk=chunk)
    for g, w, what in zip(got, want, ("y", "ckpt", "hT")):
        assert tuple(g.shape) == w.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what,
                                   **FWD)


@pytest.mark.parametrize("chunk,bd", [(8, 8), (16, 16), (32, 16), (8, 4)])
def test_backward_matches_reference_kernel(chunk, bd):
    xc, dt, bm, cm, a, h0, dy = _inputs(seed=1)
    _, ckpt, _ = ref_ss.selective_scan_fwd(*map(jnp.asarray, (xc, dt, bm, cm,
                                                              a, h0)),
                                           chunk=chunk, bd=bd)
    ckpt = np.array(ckpt)
    want = ref_ss.selective_scan_bwd(*map(jnp.asarray, (xc, dt, bm, cm, a,
                                                         ckpt, dy)),
                                     chunk=chunk, bd=bd)
    got = ss.selective_scan_bwd_plain(*_t((xc, dt, bm, cm, a, ckpt, dy)),
                                      chunk=chunk)
    for g, w, what in zip(got, want, NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what,
                                   **GRAD)


@pytest.mark.parametrize("shape", [(1, 16, 8, 4, 8), (2, 24, 12, 4, 8),
                                   (2, 24, 12, 8, 24)])
def test_autograd_function_matches_reference_custom_vjp(shape):
    """The autograd function (CPU route: plain forward and backward) against
    the reference's custom_vjp, for a scalar loss of y."""
    import jax

    B, S, Di, N, chunk = shape
    xc, dt, bm, cm, a, h0, _ = _inputs(B, S, Di, N, seed=3)
    bd = min(Di, 4)

    def loss_ref(*args):
        return jnp.sum(jnp.sin(ref_ss.selective_scan(*args, chunk, bd, True)))

    want = jax.grad(loss_ref, argnums=tuple(range(6)))(
        *map(jnp.asarray, (xc, dt, bm, cm, a, h0)))
    args = [t.requires_grad_() for t in _t((xc, dt, bm, cm, a, h0))]
    torch.sin(ops.selective_scan(*args, chunk)).sum().backward()
    for t, w, what in zip(args, want, NAMES):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=what, **GRAD)


@pytest.mark.parametrize("chunk", [4, 8, 24])
def test_backward_equals_autograd_of_plain_forward(chunk):
    xc, dt, bm, cm, a, h0, dy = _t(_inputs(2, 24, 12, 8, seed=4))
    args = [t.requires_grad_() for t in (xc, dt, bm, cm, a, h0)]
    y, ckpt, _ = ss.selective_scan_fwd_plain(*args, chunk=chunk)
    want = torch.autograd.grad(y, args, dy)
    got = ss.selective_scan_bwd_plain(*(t.detach() for t in args[:5]),
                                      ckpt.detach(), dy, chunk=chunk)
    for g, w, what in zip(got, want, NAMES):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=what)


def test_route_follows_the_device():
    """A CPU tensor takes the plain version (no launch); the CUDA wrappers
    refuse CPU tensors instead of falling back."""
    xc, dt, bm, cm, a, h0, dy = _t(_inputs(1, 16, 8, 4))
    fwd0 = ss.selective_scan_fwd_cuda.launches
    y, ckpt, ht = ops.selective_scan_fwd(xc, dt, bm, cm, a, h0, chunk=8)
    assert ss.selective_scan_fwd_cuda.launches == fwd0
    want = ss.selective_scan_fwd_plain(xc, dt, bm, cm, a, h0, chunk=8)
    assert all(torch.equal(g, w) for g, w in zip((y, ckpt, ht), want))
    with pytest.raises(ValueError, match="CUDA"):
        ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt, dy, chunk=8)


def test_shape_checks():
    xc, dt, bm, cm, a, h0, _ = _t(_inputs(1, 12, 8, 4))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.selective_scan_fwd(xc, dt, bm, cm, a, h0, chunk=8)
    with pytest.raises(ValueError, match=r"\[Di, N\]"):
        ops.selective_scan_fwd(xc, dt, bm, cm, a[:, :3], h0, chunk=4)


def test_backward_sub_chunks_fit_shared_memory():
    """The backward kernel keeps 16-step sub-chunks in shared memory and the
    sub-chunk start states in a global scratch, so one block's shared memory
    depends on N only and fits the limit for every chunk; N > 16 is
    refused."""
    assert ss.bwd_sub_chunk(256) == 16 and ss.bwd_sub_chunk(8) == 8
    # 16 steps x (2 x 256 states + 5 x 32 channels + 2 x 16 + 8 warps x 32)
    assert ss.bwd_smem_bytes(16) == 16 * (512 + 160 + 32 + 256) * 4 == 61440
    assert ss.bwd_smem_bytes(4) < ss.bwd_smem_bytes(8) < ss.bwd_smem_bytes(16)
    for N in range(1, 17):
        assert ss.bwd_smem_bytes(N) <= ss.SMEM_MAX
        ss._check_state(N)
    with pytest.raises(ValueError, match="N <= 16"):
        ss._check_state(17)


@pytest.mark.parametrize("N", range(1, 17))
def test_forward_plan_covers_every_state(N):
    """The forward block's layout (``fwd_plan``, the mirror of ``FwdShape``):
    each of the N states sits on exactly one (lane, slot) of its channel, the
    padded ones past N; a channel's lanes are a power of two within a warp,
    so the y butterfly stays inside it; the static shared memory fits
    48 KB, far below the 227 KB limit."""
    plan = ss.fwd_plan(N)
    lanes, spl, np_ = plan["lanes"], plan["states_per_lane"], plan["padded"]
    assert np_ >= N and lanes * spl == np_
    states = sorted(j * spl + s for j in range(lanes) for s in range(spl))
    assert states == list(range(np_))
    assert lanes & (lanes - 1) == 0 and 32 % lanes == 0
    assert plan["threads"] == plan["channels"] * lanes
    assert plan["threads"] % 32 == 0
    assert plan["smem_bytes"] <= 48 * 1024 <= ss.SMEM_MAX
    if N == 16:
        # two stages of x, dt [32, 32] and B, C [32, 16], and y [32, 32]
        assert (lanes, spl, plan["threads"]) == (4, 4, 128)
        assert plan["smem_bytes"] == (2 * 32 * (64 + 32) + 32 * 32) * 4


def _fwd_lane_partials(xc, dt, bm, cm, a, h0, chunk):
    """A plain emulation of the forward kernel's arithmetic: the states as
    ``step_state`` updates them, padded to ``fwd_plan``'s NP with zeros, and
    y_t as each lane's partial sum over its slots, closed by the butterfly
    ``part += part[lane ^ o]`` for o = 1, 2, ... below the lane count."""
    B, S, Di = xc.shape
    N = a.shape[1]
    plan = ss.fwd_plan(N)
    lanes, spl, np_ = plan["lanes"], plan["states_per_lane"], plan["padded"]
    pad = lambda x: torch.nn.functional.pad(x, (0, np_ - N))
    a_p, bm_p, cm_p, h = pad(a), pad(bm), pad(cm), pad(h0)
    lane = torch.arange(lanes)
    ys, ckpts = [], []
    for t in range(S):
        if t % chunk == 0:
            ckpts.append(h[..., :N])
        dt_t = dt[:, t, :, None]
        dx = dt_t * xc[:, t, :, None]
        h = torch.exp(dt_t * a_p) * h + dx * bm_p[:, t, None, :]
        prod = (h * cm_p[:, t, None, :]).reshape(B, Di, lanes, spl)
        part = prod[..., 0]
        for s in range(1, spl):
            part = part + prod[..., s]
        o = 1
        while o < lanes:
            part = part + part[..., lane ^ o]
            o *= 2
        ys.append(part[..., 0])
    return torch.stack(ys, 1), torch.stack(ckpts, 1), h[..., :N]


@pytest.mark.parametrize("shape", [(2, 32, 16, 4, 8), (2, 40, 12, 1, 8),
                                   (1, 48, 37, 3, 16), (2, 24, 20, 12, 24),
                                   (2, 64, 40, 16, 32)])
def test_lane_partial_y_sum_matches_reference(shape):
    """The lane-partial y sum against the reference kernel in interpret mode
    within the reference's forward bound (rtol 1e-4 / atol 1e-5); its
    checkpoints and final states equal the plain forward's bit for bit (the
    states are updated the same way, only y is summed in another order)."""
    B, S, Di, N, chunk = shape
    *args, _ = _inputs(B, S, Di, N, seed=N)
    want = ref_ss.selective_scan_fwd(*map(jnp.asarray, args), chunk=chunk,
                                     bd=Di)
    got = _fwd_lane_partials(*_t(args), chunk=chunk)
    for g, w, what in zip(got, want, ("y", "ckpt", "hT")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=what)
    plain = ss.selective_scan_fwd_plain(*_t(args), chunk=chunk)
    assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
