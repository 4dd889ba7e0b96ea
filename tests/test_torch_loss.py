"""The port's differentiable loss (``get_loss_fn``) and the autograd rules of
its kernels, against the JAX package on the CPU (small seeded inputs).

The JAX reference for the whole slice is ``jax.value_and_grad`` of the JAX
package's ``get_loss_fn`` on its CPU (XLA) path, jitted, with ``remat=False``:
``jax.checkpoint`` changes what is stored, not the gradient, and tracing
without it is faster. Test images are clipped to [0, 1], so they hold exact
0s and 1s: the gradient at those ties must follow JAX's rule (0.5).
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import pyramid as pyr_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels import csf_lut as lut_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels.blur_halo import blur_tpu  # noqa: E402
from colorvideovdp_tpu_torch.convert import params_from_jax  # noqa: E402
from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import csf_lut as lut_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels.blur import Blur  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels.pyramid_reduce import Reduce  # noqa: E402

TAPS = gaussian_kernel1d(13, 3.0)  # the calibrated pu_dilate = 3
# Loss and gradient bounds against JAX; the gradient bound is the one the JAX
# package holds its own kernels' gradients to (tests/test_fused_kernels.py).
LOSS_TOL = 1e-4
GRAD_TOL = 1e-3


def _pair(B, H, W, seed=17):
    rng = np.random.RandomState(seed)
    ref = rng.rand(B, 3, 1, H, W).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    return test, ref


@functools.lru_cache(maxsize=None)
def _jax_loss(B, H, W, mask_p=None):
    """(loss, d/dtest, d/dref) of the JAX package's loss on ``_pair``."""
    m = cj.cvvdp(display_name="standard_4k", quiet=True)
    if mask_p is not None:
        m.mask_p = mask_p
    test, ref = _pair(B, H, W)
    fn = jax.jit(jax.value_and_grad(m.get_loss_fn(H, W, remat=False), argnums=(0, 1)))
    v, (gt, gr) = fn(jnp.asarray(test), jnp.asarray(ref))
    return float(v), np.asarray(gt), np.asarray(gr), m


def _torch_loss(m, B, H, W, remat=True):
    test, ref = (torch.from_numpy(a).requires_grad_() for a in _pair(B, H, W))
    v = m.get_loss_fn(H, W, remat=remat)(test, ref)
    gt, gr = torch.autograd.grad(v, (test, ref))
    return float(v.detach()), gt.numpy(), gr.numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("shape", [(1, 64, 256), (2, 48, 160)])
def test_loss_and_gradient_match_jax(shape, remat):
    v_j, gt_j, gr_j, _ = _jax_loss(*shape)
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    v, gt, gr = _torch_loss(m, *shape, remat=remat)
    print(f"loss {shape} remat={remat}: |dloss| {abs(v - v_j):.3e}, "
          f"grad rel {_rel(gt, gt_j):.3e} (test) {_rel(gr, gr_j):.3e} (ref)")
    assert abs(v - v_j) <= LOSS_TOL, (v, v_j)
    assert np.abs(gt_j).max() > 0 and np.abs(gr_j).max() > 0
    assert _rel(gt, gt_j) <= GRAD_TOL
    assert _rel(gr, gr_j) <= GRAD_TOL


def test_remat_gradient_equals_plain_autograd():
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    v1, gt1, gr1 = _torch_loss(m, 1, 48, 160, remat=True)
    v0, gt0, gr0 = _torch_loss(m, 1, 48, 160, remat=False)
    assert v1 == v0
    assert np.abs(gt1 - gt0).max() <= 1e-6 * np.abs(gt0).max()
    assert np.abs(gr1 - gr0).max() <= 1e-6 * np.abs(gr0).max()


def test_carried_mask_p_gradient_matches_jax():
    v_j, gt_j, gr_j, mj = _jax_loss(1, 32, 128, mask_p=2.9)
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    v_d, gt_d, _ = _torch_loss(m, 1, 32, 128)
    m.load_parameters(params_from_jax(mj))
    assert m.mask_p == 2.9
    v, gt, gr = _torch_loss(m, 1, 32, 128)
    print(f"loss mask_p=2.9: |dloss| {abs(v - v_j):.3e}, "
          f"grad rel {_rel(gt, gt_j):.3e} (test) {_rel(gr, gr_j):.3e} (ref)")
    assert abs(v - v_d) > 100 * LOSS_TOL and _rel(gt, gt_d) > 100 * GRAD_TOL
    assert abs(v - v_j) <= LOSS_TOL, (v, v_j)
    assert _rel(gt, gt_j) <= GRAD_TOL
    assert _rel(gr, gr_j) <= GRAD_TOL


def test_loss_equals_ten_minus_predicted_jod():
    test, ref = _pair(2, 48, 160)
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    per_image = m.loss(test, ref, dim_order="BCFHW")
    assert per_image.shape == (2,)
    v = m.get_loss_fn(48, 160)(torch.from_numpy(test), torch.from_numpy(ref))
    assert abs(float(v) - float(per_image.mean())) <= 1e-5


def test_signed_gradient_step_lowers_loss():
    test, ref = (torch.from_numpy(a) for a in _pair(1, 64, 96, seed=0))
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    fn = m.get_loss_fn(64, 96)
    x = test.clone().requires_grad_()
    v = fn(x, ref)
    (g,) = torch.autograd.grad(v, x)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    assert float(fn(test - 1e-2 * torch.sign(g), ref)) < float(v.detach())


def _csf_table():
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    luts = np.stack([m.csf.logS_of_logL(2.0, 0, c) for c in range(3)]
                    + [m.csf.logS_of_logL(2.0, 5, 0)]).astype(np.float32)
    return luts, m.csf.lut_range()


@pytest.mark.parametrize("shape", [(2, 16, 256), (3, 5, 7)])  # natural / padded route
def test_csf_lut_backward_matches_pallas(shape):
    luts, (x0, x1) = _csf_table()
    nk = luts.shape[1]
    step = (x1 - x0) / (nk - 1)
    rng = np.random.RandomState(8)
    # Off the knots (a knot's one-sided slope is a convention), spanning
    # below x0, the table and above x1; plus the clip edges themselves,
    # where the derivative is 0 (strictly inside only).
    knot = rng.randint(-4, nk + 3, size=shape)
    logL = (x0 + (knot + rng.uniform(0.05, 0.95, size=shape)) * step).astype(np.float32)
    logL.reshape(-1)[:2] = (x0, x1)
    g = rng.randn(4, *shape).astype(np.float32)
    lookup = lut_j._make_lookup(("test", shape), luts, x0, x1)
    S_j, vjp = jax.vjp(lookup, jnp.asarray(logL))
    (d_j,) = vjp(jnp.asarray(g))
    S_j, d_j = np.asarray(S_j), np.asarray(d_j)
    S_t = lut_t.csf_lut_plain(torch.from_numpy(logL), torch.from_numpy(luts), x0, x1).numpy()
    d_t = lut_t.csf_lut_bwd_plain(torch.from_numpy(logL), torch.from_numpy(g),
                                  torch.from_numpy(luts), x0, x1).numpy()
    assert np.abs(S_t - S_j).max() <= 1e-5 * np.abs(S_j).max()
    assert np.abs(d_t - d_j).max() <= 1e-5 * np.abs(d_j).max()
    assert d_t.reshape(-1)[0] == 0.0 and d_t.reshape(-1)[1] == 0.0
    inside = (logL > x0) & (logL < x1)
    assert np.all(d_t[~inside] == 0.0) and np.abs(d_t[inside]).min() > 0


@pytest.mark.parametrize("shape", [(3, 40, 200), (2, 17, 129)])
def test_blur_plain_matches_pallas(shape):
    x = np.random.RandomState(9).rand(*shape).astype(np.float32)
    y_j = np.asarray(blur_tpu(jnp.asarray(x), TAPS, interpret=True))
    y_t = blur_plain(torch.from_numpy(x), TAPS).numpy()
    assert np.abs(y_t - y_j).max() <= 1e-6 * np.abs(y_j).max()


@pytest.mark.parametrize("shape", [(2, 3, 17, 33), (1, 2, 24, 40)])
def test_reduce_backward_matches_jax(shape):
    rng = np.random.RandomState(10)
    x = rng.rand(*shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = Reduce.apply(xt)
    g = rng.randn(*y.shape).astype(np.float32)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    y_j, vjp = jax.vjp(pyr_j._xla_reduce, jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    assert np.abs(y.detach().numpy() - np.asarray(y_j)).max() <= 1e-6
    assert np.abs(dx.numpy() - np.asarray(dx_j)).max() <= 1e-6 * np.abs(dx_j).max()


def test_blur_backward_matches_autograd():
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.rand(2, 3, 20, 30).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(2, 3, 20, 30).astype(np.float32))
    (d_fn,) = torch.autograd.grad(Blur.apply(x, TAPS), x, g)
    (d_ref,) = torch.autograd.grad(blur_plain(x, TAPS), x, g)
    assert torch.equal(d_fn, d_ref)


def test_gradcheck_blur_and_reduce():
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.rand(2, 9, 11)).requires_grad_()
    taps = gaussian_kernel1d(5, 1.0).astype(np.float64)
    assert torch.autograd.gradcheck(lambda t: Blur.apply(t, taps), (x,))
    assert torch.autograd.gradcheck(Reduce.apply, (x,))
    assert torch.autograd.gradcheck(Reduce.apply, (x[:, :8].detach().requires_grad_(),))


def test_blur_nan_stays_within_radius():
    r = (len(TAPS) - 1) // 2
    x = torch.rand(1, 40, 50)
    x[0, 20, 25] = float("nan")
    for y in (blur_plain(x, TAPS), Blur.apply(x, TAPS)):
        nan = torch.isnan(y[0])
        box = torch.zeros_like(nan)
        box[20 - r:20 + r + 1, 25 - r:25 + r + 1] = True
        assert torch.equal(nan, box)
