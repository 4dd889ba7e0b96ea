"""The port's one band route (``ops/kernels/band_pooled.py``) against the JAX
package's band mega-kernel route (``band_fused.py``, ``cvvdp.use_band_mega``).

The port has no mega route: the bands the JAX gate admits take the same
one-pass kernel as every other band. On CPU tensors the port runs its plain
version (the raw-pair chain fed ``gausspyr_expand(gn)``); the JAX side runs
its Pallas mega-kernel in interpret mode, as ``tests/test_fused_kernels.py``
does, or its public-op chain. Inputs are seeded numpy arrays handed to both
packages; the JAX results are computed once per module.
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
from colorvideovdp_tpu.ops import masking as mk_j  # noqa: E402
from colorvideovdp_tpu.ops import pyramid as pyr_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels import band_fused as bf_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels import csf_lut as lut_j  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402

GAINS = (1.0, 1.45, 1.0, 1.0)
RHO = 2.0


@functools.lru_cache(maxsize=None)
def _setup(H, W, L, seed):
    """The JAX kernel tests' fixture: the default calibration's LUT rows at
    rho = 2 and a synthetic (2C, L, H, W) level with its genuine reduce."""
    m = cj.cvvdp(display_name="standard_4k", quiet=True)
    lut_rows = np.stack([m.csf.logS_of_logL(RHO, om, cc)
                         for om, cc in ((0, 0), (0, 1), (0, 2), (5, 0))]).astype(np.float32)
    x0, x1 = float(m.csf.log_L_bkg[0]), float(m.csf.log_L_bkg[-1])
    rng = np.random.RandomState(seed)
    gi = rng.rand(8, L, H, W).astype(np.float32) * 80.0 + 1.0
    gn = np.asarray(pyr_j.gausspyr_reduce(jnp.asarray(gi)))
    return m, lut_rows, x0, x1, gi.reshape(1, 8, L, H, W), gn.reshape(1, 8, L, *gn.shape[-2:])


def _port(H, W, L, seed):
    """(gi, gn, lut, BandConsts) of the same inputs for the port (sensitivity
    correction 1, as the JAX kernel tests use)."""
    _, lut_rows, x0, x1, gi, gn = _setup(H, W, L, seed)
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    consts = bm.BandConsts.make(m._masking_params(), 4, x0, x1, 1.0, False, m.beta)
    return torch.tensor(gi), torch.tensor(gn), torch.tensor(lut_rows), consts


@functools.lru_cache(maxsize=None)
def _jax_D(H, W, L, seed, mul):
    """D from the JAX mega-kernel (interpret) and from its public-op chain."""
    m, lut_rows, x0, x1, gi, gn = _setup(H, W, L, seed)
    params = m._masking_params()
    fused = bf_j.make_band_fused(lut_rows, x0, x1, GAINS, 1.0, params, False, mul,
                                 pool_beta=None)
    D_k = np.asarray(fused(jnp.asarray(gi), jnp.asarray(gn)))
    E = pyr_j.gausspyr_expand(jnp.asarray(gn), (H, W))
    gi5 = jnp.asarray(gi)
    lb_r = jnp.clip(E[:, 1:2], 0.01, None)
    lb_t = jnp.clip(E[:, 0:1], 0.01, None)
    T = jnp.clip((gi5[:, 0::2] - E[:, 0::2]) / lb_t, None, 1000.0) * mul
    R = jnp.clip((gi5[:, 1::2] - E[:, 1::2]) / lb_r, None, 1000.0) * mul
    S = jnp.moveaxis(lut_j._jnp_lookup(jnp.log10(lb_r[:, 0]), lut_rows, x0, x1), 0, 1)
    return D_k, np.asarray(mk_j.apply_masking_model(T, R, S, params))


def test_band_fused_d_matches_jax_kernel_and_chain():
    """``band_pooled_d``'s D at 96x512, 2 frames: within JAX's own
    kernel-vs-chain bound (2e-4 of max(1, max|D|)) of its mega-kernel, and
    within 1e-5 of its public-op chain."""
    H, W, L, seed, mul = 96, 512, 2, 41, 2.0
    gi, gn, lut, consts = _port(H, W, L, seed)
    # CPU: the plain version.
    D_t = bp.band_pooled_d([gi], [gn], lut[None], [mul], consts)[0][0].numpy()
    D_k, D_chain = _jax_D(H, W, L, seed, mul)
    assert D_t.shape == D_k.shape == (1, 4, L, H, W)
    denom = max(1.0, float(np.abs(D_chain).max()))
    assert np.abs(D_t - D_k).max() / denom < 2e-4
    assert np.abs(D_t - D_chain).max() / denom <= 1e-5


def test_band_fused_pooled_matches_jax_kernel():
    """``band_pooled`` at 88x256 (H off the JAX kernel's 16-row tile grid), 2
    frames: the pooled norm within 1e-4 relative of the JAX mega-kernel's."""
    H, W, L, seed, mul = 88, 256, 2, 43, 2.0
    m, lut_rows, x0, x1, gi_n, gn_n = _setup(H, W, L, seed)
    f_q = bf_j.make_band_fused(lut_rows, x0, x1, GAINS, 1.0, m._masking_params(), False, mul,
                               pool_beta=2.0)
    q_j = np.asarray(f_q(jnp.asarray(gi_n), jnp.asarray(gn_n)))
    gi, gn, lut, consts = _port(H, W, L, seed)
    sums = bp.band_pooled([gi], [gn], lut[None], [mul], consts)[0]
    q_t = bm.pooled_norm(sums, H, W, consts.beta).numpy()
    assert q_t.shape == q_j.shape == (1, 4, L)
    assert np.abs(q_t - q_j).max() / np.abs(q_j).max() <= 1e-4
    # The autograd route gives the same sums.
    assert torch.equal(bp.band_pooled_sums([gi], [gn], lut[None], [mul], consts)[0], sums)


def _clip():
    rng = np.random.RandomState(47)
    H, W, N = 96, 512, 5
    V_ref = np.repeat((rng.rand(H, W, 3, 1) * 255).astype(np.uint8), N, axis=3)
    V_test = ((V_ref.astype(np.float32) / 255 + rng.randn(*V_ref.shape) * 0.05).clip(0, 1)
              * 255).astype(np.uint8)
    return V_test, V_ref


def test_band_mega_video_matches_jax():
    """The seed-47 96x512 5-frame clip: the JAX package with
    ``use_band_mega`` and ``force_fused`` (bands 0 and 1 pass its gate), the
    port on its one route: JOD within 1e-4."""
    V_test, V_ref = _clip()
    kw = dict(dim_order="HWCF", frames_per_second=24)
    m_j = cj.cvvdp(display_name="standard_4k", quiet=True)
    m_j.force_fused = m_j.use_band_mega = True
    Q_j, _ = m_j.predict(V_test, V_ref, **kw)
    Q_t, _ = ct.cvvdp(display_name="standard_4k", device="cpu").predict(V_test, V_ref, **kw)
    assert abs(float(Q_t) - float(Q_j)) <= 1e-4, (float(Q_t), float(Q_j))


def test_band_mega_loss_matches_jax(monkeypatch):
    """Loss and gradients of the port's 64x512 ``get_loss_fn`` against JAX's
    ``value_and_grad`` of its mega route (``use_band_mega``: band 0 passes
    its gate): loss within 1e-4, gradients within 1e-3 of max|g|. The
    port hands band 0 to ``band_pooled_sums`` as gi and gn."""
    rng = np.random.RandomState(17)
    ref = rng.rand(1, 3, 1, 64, 512).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    m_j = cj.cvvdp(display_name="standard_4k", quiet=True)
    m_j.force_fused = m_j.use_band_mega = True
    fn = jax.jit(jax.value_and_grad(m_j.get_loss_fn(64, 512, remat=False), argnums=(0, 1)))
    v_j, (gt_j, gr_j) = fn(jnp.asarray(test), jnp.asarray(ref))
    m_t = ct.cvvdp(display_name="standard_4k", device="cpu")
    calls = []
    orig = bp.band_pooled_sums

    def spy(gis, gns, *args):
        calls.append((tuple(gis[0].shape), tuple(gns[0].shape)))
        return orig(gis, gns, *args)

    monkeypatch.setattr(bp, "band_pooled_sums", spy)
    x, r = (torch.from_numpy(a).requires_grad_() for a in (test, ref))
    v_t = m_t.get_loss_fn(64, 512)(x, r)
    gt_t, gr_t = torch.autograd.grad(v_t, (x, r))
    # Once in the forward, once in the checkpointed block's recompute.
    assert calls == [((1, 6, 1, 64, 512), (1, 6, 1, 32, 256))] * 2
    assert abs(float(v_t.detach()) - float(v_j)) <= 1e-4
    for g_t, g_j in ((gt_t, gt_j), (gr_t, gr_j)):
        g_j = np.asarray(g_j)
        assert np.abs(g_t.numpy() - g_j).max() <= 1e-3 * np.abs(g_j).max()


@pytest.mark.parametrize("H,W,force,heatmap", [
    (96, 512, True, False),   # JAX: bands 0 and 1 take its mega-kernel (min_w 256)
    (96, 512, False, False),  # JAX: band 0 only (min_w 512)
    (96, 512, True, True),    # JAX: the heatmap's D mode
    (100, 512, True, False),  # JAX: H % 8 != 0 at band 0, band 1 (50 rows) too
    (64, 1024, True, False),  # JAX: band 1 of 32 rows is below 48
])
def test_default_route_matches_jax_mega_route(H, W, force, heatmap):
    """An image pair at the shapes and flags where the JAX package's gate
    sends some interior bands to its mega-kernel and keeps others on its
    band route: the port's one route gives the JOD within 1e-4 and a raw
    heatmap within one float16 step of the map's largest value."""
    rng = np.random.RandomState(2)
    ref = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + 9, 0, 255).astype(np.uint8)
    hm = "raw" if heatmap else None
    m_j = cj.cvvdp(display_name="standard_4k", quiet=True, heatmap=hm)
    m_j.use_band_mega, m_j.force_fused = True, force
    Q_j, st_j = m_j.predict(test, ref, dim_order="HWC")
    m_t = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap=hm)
    Q_t, st_t = m_t.predict(test, ref, dim_order="HWC")
    assert abs(float(Q_t) - float(Q_j)) <= 1e-4, (float(Q_t), float(Q_j))
    if heatmap:
        a, b = (np.asarray(st["heatmap"], np.float64) for st in (st_j, st_t))
        assert a.shape == b.shape == (1, 1, 1, H, W)
        assert np.abs(a - b).max() <= np.spacing(np.float16(np.abs(a).max()))
