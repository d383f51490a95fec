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
