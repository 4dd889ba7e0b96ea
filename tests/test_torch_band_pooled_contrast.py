"""The contrast-band codings of the one-pass band kernel
(``ops/kernels/band_pooled.py`` with ``BandConsts.coding`` weber_g0_ref or
log) against the JAX package's contrast-band route, and the metric's routing
through them.

On CPU tensors the port runs its plain version: the coding's contrast band
and adaptation field formed from gi and ``gausspyr_expand(gn)``
(``ops/pyramid.py`` ``interior_contrast``) at the band's gain, then the
contrast-band chain. The JAX side takes its own decomposition's bands and
fields (``WeberContrastPyramid`` / ``LogContrastPyramid.decompose``), its
stage A ``fused_csf_contrast`` and its route ``make_fused_mult_mutual``
(Pallas in interpret mode). Inputs are seeded numpy arrays handed to both
packages; the levels gi and gn are JAX's own Gaussian pyramid.
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
from colorvideovdp_tpu.ops.kernels.masking_fused import (  # noqa: E402
    fused_csf_contrast, make_fused_mult_mutual)
from colorvideovdp_tpu_torch.ops import pyramid as pyr_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402
from colorvideovdp_tpu_torch.utils.config import write_parameters  # noqa: E402

CODINGS = ["weber_g0_ref", "log"]
RHO = 6.08
BETA = 2.0
PPD = 60.0
# A 66x94 image: band 0 even, band 1 33x47 (odd edges).
H, W = 66, 94
# D against the JAX chain: both round every product and quotient in float32,
# in orders that differ (the blur's taps, the LUT's interpolation).
D_TOL = 1e-5
POOLED_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_metric():
    return cj.cvvdp(display_name="standard_4k", quiet=True)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvvdp_codings")
    return {c: write_parameters(str(root / c), contrast=c) for c in CODINGS}


def _consts(C, coding):
    mj = _jax_metric()
    mt = ct.cvvdp(display_name="standard_4k", device="cpu")
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    sens = 10.0 ** (mj.sensitivity_correction / 20.0)
    return bm.BandConsts.make(mt._masking_params(), C, x0, x1, sens, coding.endswith("ref"),
                              BETA, coding=coding)


def _lut(C):
    mj = _jax_metric()
    return np.stack([mj.csf.logS_of_logL(RHO, mj.omega[0 if cc < 3 else 1], cc if cc < 3 else 0)
                     for cc in range(C)]).astype(np.float32)


def _image(C, coding, seed):
    """Interleaved metric-space frames (1, 2C, 2, H, W): luminance-like, or
    their log10 for the log coding."""
    R = (np.random.RandomState(seed).rand(1, 2 * C, 2, H, W) * 60 + 1).astype(np.float32)
    return np.log10(R) if coding == "log" else R


def _jax_pyramid(coding):
    if coding == "log":
        return pyr_j.LogContrastPyramid(W, H, PPD)
    return pyr_j.WeberContrastPyramid(W, H, PPD, contrast=coding)


def _jax_D(band, logL, lut, k):
    """D of JAX's contrast-band route, ``make_fused_mult_mutual``."""
    params = _jax_metric()._masking_params()
    fused = make_fused_mult_mutual(lut, k.x0, k.x1, k.ch_gain, k.sens_corr, params,
                                   lambda M: mk_j.phase_uncertainty(M, params))
    return fused(jnp.asarray(band[:, 0::2]), jnp.asarray(band[:, 1::2]), jnp.asarray(logL))


@pytest.mark.parametrize("C", [4, 3])
@pytest.mark.parametrize("coding", CODINGS)
def test_coding_matches_jax_contrast_band_route(coding, C):
    """Bands 0 (66x94) and 1 (33x47) of one image: the plain version of the
    coding (pooled and D, and the wrapper on CPU tensors) from JAX's levels
    gi and gn, against JAX's decomposition at the band's gain through
    ``fused_csf_contrast`` (stage A, within 1e-5) and
    ``make_fused_mult_mutual`` (D within 1e-5 of max|D|; pooled sums within
    1e-4 relative)."""
    pj = _jax_pyramid(coding)
    R = jnp.asarray(_image(C, coding, seed=C + len(coding)))
    bands_j, logL_j = pj.decompose(R)
    levels = [np.array(x) for x in pj.gaussian_pyramid(R, pj.height + 1)]
    lut = _lut(C)
    k = _consts(C, coding)
    for bb in (0, 1):
        mul = 1.0 if bb == 0 else 2.0
        band = np.asarray(bands_j[bb]) * np.float32(mul)
        logL = np.asarray(logL_j[bb])
        gi, gn = torch.from_numpy(levels[bb]), torch.from_numpy(levels[bb + 1])
        args = ([gi], [gn], torch.from_numpy(lut)[None], [mul], k)
        (D_t,), s_t = bp.band_pooled_d_plain(*args)
        assert torch.equal(bp.band_pooled(*args), s_t)
        assert torch.equal(bp.band_pooled_d(*args)[1], s_t)

        # Stage A: the port's band and field from gi and gn against JAX's.
        b_t, L_t = bp._contrast_band(gi, pyr_t.gausspyr_expand(gn, gi.shape[-2:]), mul, k)
        m_t, d_t = bm.csf_contrast_plain(b_t, L_t, torch.from_numpy(lut), k)
        m_j, d_j = fused_csf_contrast(jnp.asarray(band[0, 0::2]), jnp.asarray(band[0, 1::2]),
                                      jnp.asarray(logL[0, 0]), lut, k.x0, k.x1,
                                      tuple(float(g) * k.sens_corr for g in k.ch_gain))
        for a, b in ((m_t[0], m_j), (d_t[0], d_j)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()

        D_j = np.asarray(_jax_D(band, logL, lut, k))
        assert D_t.shape == D_j.shape == (1, C, 2) + tuple(levels[bb].shape[-2:])
        assert np.abs(D_j).max() > 0
        assert np.abs(D_t.numpy() - D_j).max() <= D_TOL * np.abs(D_j).max()
        s_j = np.sum((D_j.astype(np.float64) + 1e-5) ** BETA - 1e-5 ** BETA, axis=(-2, -1))
        assert np.abs(s_t[0].numpy() - s_j).max() <= POOLED_TOL * np.abs(s_j).max()


def _route_spies(monkeypatch):
    """Record the gi/gn shapes and the coding handed to the one-pass
    kernel's pooled and D entries, and count every call of the previous
    contrast-band route (``band_sums``, ``band_masking_contrast`` and its D
    mode) and of the backward's recompute."""
    seen = {"pooled": [], "pooled_d": [], "vjp": [], "band_sums": 0, "contrast": 0,
            "contrast_d": 0}
    pooled, pooled_d, vjp = bp.band_pooled_sums, bp.band_pooled_d, bp.pooled_vjp

    def spy(key, fn):
        def run(gis, gns, luts, muls, k, *a):
            seen[key].append((k.coding, [(tuple(g.shape[-2:]), tuple(n.shape[-2:]))
                                         for g, n in zip(gis, gns)]))
            return fn(gis, gns, luts, muls, k, *a)
        return run

    def spy_vjp(gi, gn, lut, mul, k, *a):
        seen["vjp"].append(k.coding)
        return vjp(gi, gn, lut, mul, k, *a)

    def counting(key, fn):
        def run(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(bp, "band_pooled_sums", spy("pooled", pooled))
    monkeypatch.setattr(bp, "band_pooled_d", spy("pooled_d", pooled_d))
    monkeypatch.setattr(bp, "pooled_vjp", spy_vjp)
    monkeypatch.setattr(bm, "band_sums", counting("band_sums", bm.band_sums))
    monkeypatch.setattr(bm, "band_masking_contrast",
                        counting("contrast", bm.band_masking_contrast))
    monkeypatch.setattr(bm, "band_masking_contrast_d",
                        counting("contrast_d", bm.band_masking_contrast_d))
    return seen


def _pair(h, w, seed):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(h, w, 3) * 200 + 20).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(h, w, 3) * 8).astype(np.int16),
                   0, 255).astype(np.uint8)
    return test, ref


@pytest.mark.parametrize("coding", CODINGS)
def test_metric_hands_gi_and_gn_to_band_pooled(monkeypatch, configs, coding):
    """A 64x96 image, one loss step and a raw heatmap under the coding: every
    interior band group goes to ``band_pooled_sums`` (the loss's backward to
    ``pooled_vjp``) or, for the heatmap, ``band_pooled_d`` as gi and gn with
    the coding, and nothing to the previous route (``band_sums``,
    ``band_masking_contrast`` / ``_d``)."""
    seen = _route_spies(monkeypatch)
    test, ref = _pair(64, 96, seed=3)
    m = ct.cvvdp(display_name="standard_4k", device="cpu", config_paths=configs[coding])
    m.predict(test, ref, dim_order="HWC")
    shapes = [tuple(s) for s in m.lpyr.pyr_shape[:-1]]
    want = [(coding, [(shapes[bb], ((shapes[bb][0] + 1) // 2, (shapes[bb][1] + 1) // 2))
                      for bb in sel])
            for sel in bm.band_groups(shapes, 1, 3, 1, gn=True)]
    assert seen["pooled"] == want and len(want) >= 1

    seen["pooled"].clear()
    x = torch.from_numpy(test.transpose(2, 0, 1)[None, :, None] / np.float32(255)).float()
    r = torch.from_numpy(ref.transpose(2, 0, 1)[None, :, None] / np.float32(255)).float()
    x.requires_grad_()
    (g,) = torch.autograd.grad(m.get_loss_fn(64, 96)(x, r), x)
    # Once in the forward, once in the checkpointed block's recompute.
    assert seen["pooled"] == want * 2
    assert seen["vjp"] == [coding] * len(shapes)
    assert torch.isfinite(g).all() and g.abs().max() > 0

    mh = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap="raw",
                  config_paths=configs[coding])
    mh.predict(test, ref, dim_order="HWC")
    blurs = [mh._masking_params().blurs(*s) for s in shapes]
    assert [c for c, _ in seen["pooled_d"]] == [coding] * len(seen["pooled_d"])
    assert [b for _, b in seen["pooled_d"]] == [
        [(shapes[bb], ((shapes[bb][0] + 1) // 2, (shapes[bb][1] + 1) // 2)) for bb in sel]
        for sel in bm.band_groups(shapes, 1, 3, 1, blurs, gn=True)]
    assert (seen["band_sums"], seen["contrast"], seen["contrast_d"]) == (0, 0, 0)


@pytest.mark.parametrize("coding", CODINGS)
def test_predict_matches_jax_through_band_pooled(configs, coding):
    """A 64x96 image under the coding: the port's JOD (through the one-pass
    kernel's plain version) within 1e-4 of JAX's (its contrast-band route)."""
    test, ref = _pair(64, 96, seed=9)
    Qj, _ = cj.cvvdp(display_name="standard_4k", quiet=True, config_paths=configs[coding]
                     ).predict(test, ref, dim_order="HWC")
    Qt, _ = ct.cvvdp(display_name="standard_4k", device="cpu", config_paths=configs[coding]
                     ).predict(test, ref, dim_order="HWC")
    assert abs(float(Qj) - float(Qt)) <= 1e-4, (float(Qj), float(Qt))


def test_weber_g0_ref_band_gradient_matches_jax(monkeypatch):
    """``BandPooled`` under weber_g0_ref (its backward ``pooled_vjp``
    recomputes the coding's plain chain) against JAX's ``value_and_grad`` of
    its contrast-band route fed its own contrast of gi and the expand of gn:
    a weighted sum of the pooled norms within 1e-4, gradients in gi and gn
    within 1e-3 of max|g|."""
    C, h, w, mul = 4, 33, 47, 2.0
    rng = np.random.RandomState(21)
    gi = (rng.rand(1, 2 * C, 2, h, w) * 40 + 0.5).astype(np.float32)
    gn = (rng.rand(1, 2 * C, 2, (h + 1) // 2, (w + 1) // 2) * 40 + 0.5).astype(np.float32)
    wts = np.random.RandomState(22).rand(1, C, 2).astype(np.float32)
    lut = _lut(C)
    k = _consts(C, "weber_g0_ref")
    params = _jax_metric()._masking_params()
    fused = make_fused_mult_mutual(lut, k.x0, k.x1, k.ch_gain, k.sens_corr, params,
                                   lambda M: mk_j.phase_uncertainty(M, params))

    def f_j(gi_, gn_):
        E = pyr_j.gausspyr_expand(gn_, (h, w))
        L = jnp.clip(gi_[:, 1:2], 0.01, None)
        band = jnp.clip((gi_ - E) / L, None, 1000.0) * mul
        D = fused(band[:, 0::2], band[:, 1::2], jnp.log10(L))
        return jnp.sum(mk_j.lp_norm(D, BETA, dim=(-2, -1), normalize=True, keepdim=False) * wts)

    v_j, (dgi_j, dgn_j) = jax.value_and_grad(f_j, argnums=(0, 1))(jnp.asarray(gi),
                                                                    jnp.asarray(gn))
    codings = []
    vjp = bp.pooled_vjp

    def spy_vjp(*a):
        codings.append(a[4].coding)
        return vjp(*a)

    monkeypatch.setattr(bp, "pooled_vjp", spy_vjp)
    gi_t, gn_t = (torch.from_numpy(a).requires_grad_() for a in (gi, gn))
    sums = bp.band_pooled_sums([gi_t], [gn_t], torch.from_numpy(lut)[None], [mul], k)
    v_t = torch.sum(bm.pooled_norm(sums[0], h, w, BETA) * torch.from_numpy(wts))
    dgi_t, dgn_t = torch.autograd.grad(v_t, (gi_t, gn_t))
    assert codings == ["weber_g0_ref"]
    assert abs(float(v_t.detach()) - float(v_j)) <= 1e-4
    for g_t, g_j in ((dgi_t, dgi_j), (dgn_t, dgn_j)):
        g_j = np.asarray(g_j)
        assert np.abs(g_j).max() > 0
        assert np.abs(g_t.numpy() - g_j).max() <= 1e-3 * np.abs(g_j).max()
