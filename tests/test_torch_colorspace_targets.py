"""The port's colour targets, PU21, the inverse EOTFs and the viewing
geometry against the JAX package (CPU, seeded inputs)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import colorspace as cs_j  # noqa: E402
from colorvideovdp_tpu_torch.ops import colorspace as cs_t  # noqa: E402

# Relative error: 1e-6 for the colour matrices and the display encodings,
# 1e-5 where a float32 power is taken (PU21, PQ).
TOL, TOL_POW = 1e-6, 1e-5
DISPLAYS = ["standard_4k", "standard_hdr_pq", "standard_hdr_linear"]
LINEAR_TARGETS = ["Y", "XYZ", "LMS2006", "DKLd65", "RGB709", "RGB2020", "RGB2020pq",
                  "logLMS_DKLd65"]
ENCODED_TARGETS = ["display_encoded_01", "display_encoded_dmax", "display_encoded_100nit"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _frames(display, C=3):
    V = np.random.RandomState(3).rand(2, C, 2, 9, 13).astype(np.float32)
    return V * 400.0 if display == "standard_hdr_linear" else V


def _tol(display, target):
    pq = display == "standard_hdr_pq" or target == "RGB2020pq"
    pu = target.startswith("display_encoded") and display != "standard_4k"
    return TOL_POW if pq or pu else TOL


@pytest.mark.parametrize("display", DISPLAYS)
@pytest.mark.parametrize("target", LINEAR_TARGETS + ENCODED_TARGETS)
def test_source_2_target_colorspace_matches_jax(display, target):
    V = _frames(display)
    dj = cj.vvdp_display_photometry.load(display)
    dt = ct.vvdp_display_photometry.load(display)
    a = np.asarray(dj.source_2_target_colorspace(jnp.asarray(V), target))
    b = dt.source_2_target_colorspace(torch.from_numpy(V), target).numpy()
    assert a.shape == b.shape and b.dtype == np.float32
    assert _rel(b, a) <= _tol(display, target), (display, target, _rel(b, a))


@pytest.mark.parametrize("target", ["Y", "display_encoded_100nit", "DKLd65"])
def test_luminance_only_content_matches_jax(target):
    V = _frames("standard_hdr_pq", C=1)
    dj = cj.vvdp_display_photometry.load("standard_hdr_pq")
    dt = ct.vvdp_display_photometry.load("standard_hdr_pq")
    a = np.asarray(dj.source_2_target_colorspace(jnp.asarray(V), target))
    b = dt.source_2_target_colorspace(torch.from_numpy(V), target).numpy()
    assert a.shape == b.shape == V.shape
    assert _rel(b, a) <= TOL_POW


@pytest.mark.parametrize("target", LINEAR_TARGETS)
def test_linear_2_target_colorspace_matches_jax(target):
    L = np.random.RandomState(4).rand(1, 3, 1, 7, 11).astype(np.float32) * 800 + 0.01
    dj = cj.vvdp_display_photometry.load("standard_hdr_pq")
    dt = ct.vvdp_display_photometry.load("standard_hdr_pq")
    a = np.asarray(dj.linear_2_target_colorspace(jnp.asarray(L), target))
    b = dt.linear_2_target_colorspace(torch.from_numpy(L), target).numpy()
    assert _rel(b, a) <= (TOL_POW if target == "RGB2020pq" else TOL), target


def test_unknown_target_raises():
    dt = ct.vvdp_display_photometry.load("standard_4k")
    with pytest.raises(RuntimeError, match="Unknown colorspace"):
        dt.linear_2_target_colorspace(torch.ones(1, 3, 1, 2, 2), "sRGB")


@pytest.mark.parametrize("pu_type", ["banding", "banding_glare", "peaks", "peaks_glare"])
def test_pu21_matches_jax(pu_type):
    Y = np.concatenate([np.geomspace(1e-3, 2e4, 301), [0.005, 100.0, 10000.0]]).astype(
        np.float32)
    pj, pt = cs_j.PU(type=pu_type), cs_t.PU(type=pu_type)
    enc_j = np.asarray(pj.encode(jnp.asarray(Y)))
    enc_t = pt.encode(torch.from_numpy(Y)).numpy()
    assert _rel(enc_t, enc_j) <= TOL_POW
    assert _rel(pt.decode(torch.from_numpy(enc_j)).numpy(),
                np.asarray(pj.decode(jnp.asarray(enc_j)))) <= TOL_POW
    assert pt.peak == pytest.approx(pj.peak, rel=1e-12)
    assert float(pt.encode(100.0)) == pytest.approx(float(pj.encode(100.0)), rel=TOL_POW)
    with pytest.raises(ValueError):
        cs_t.PU(type="nope")


def test_inverse_eotfs_match_jax():
    L = np.concatenate([np.linspace(-0.1, 1.1, 257), np.geomspace(1e-6, 1, 100)]).astype(
        np.float32)
    assert _rel(cs_t.lin2srgb(torch.from_numpy(L)).numpy(),
                np.asarray(cs_j.lin2srgb(jnp.asarray(L)))) <= TOL
    Lpq = np.concatenate([np.geomspace(1e-3, 1e4, 301), [0.0, 2e4]]).astype(np.float32)
    assert _rel(cs_t.lin2pq(torch.from_numpy(Lpq)).numpy(),
                np.asarray(cs_j.lin2pq(jnp.asarray(Lpq)))) <= TOL_POW


@pytest.mark.parametrize("display", ["standard_4k", "standard_fhd", "standard_phone"])
def test_geometry_with_eccentricity_matches_jax(display):
    gj = cj.vvdp_display_geometry.load(display)
    gt = ct.vvdp_display_geometry.load(display)
    assert gt.get_ppd() == pytest.approx(gj.get_ppd(), rel=1e-12)
    ecc = np.array([0.0, 0.5, 3.0, 10.0, 25.0, 45.0, 80.0, 95.0], np.float32)
    # Both are (tan(a + delta) - tan(a)) / tan(delta), delta half a pixel:
    # the port takes it in float64, so it is held to a float64 evaluation of
    # the JAX package's formula, and to the JAX package's float32 result
    # within what the float32 roundings of its steps (the sum in degrees or
    # radians, each radian value, each tangent, two ulps each: XLA's float32
    # tangent is not correctly rounded) move the difference.
    pix_deg = 1.0 / gt.get_ppd()
    e64 = np.deg2rad(ecc.astype(np.float64))

    def ulp(v):
        return np.spacing(np.abs(v).astype(np.float32)).astype(np.float64)

    for delta, ours, theirs, scale in (
            (np.deg2rad(pix_deg / 2), gt.get_ppd(ecc), gj.get_ppd(jnp.asarray(ecc)),
             gt.get_ppd()),
            (np.deg2rad(pix_deg) / 2, gt.get_resolution_magnification(ecc),
             gj.get_resolution_magnification(jnp.asarray(ecc)), 1.0)):
        # The magnification clamps the float32 eccentricity at 89.9 degrees.
        e = np.deg2rad(np.minimum(ecc, np.float32(89.9)).astype(np.float64)) \
            if scale == 1.0 else e64
        exact = scale * (np.tan(e + delta) - np.tan(e)) / np.tan(delta)
        assert _rel(ours.numpy(), exact) <= TOL
        sec2_hi, sec2_lo = 1 + np.tan(e + delta) ** 2, 1 + np.tan(e) ** 2
        f32_err = (sec2_hi * (np.deg2rad(ulp(np.rad2deg(e + delta))) + ulp(e + delta))
                   + sec2_lo * ulp(e) + ulp(np.tan(e + delta)) + ulp(np.tan(e)))
        assert np.all(np.abs(ours.numpy() - np.asarray(theirs))
                      <= 2 * scale * f32_err / np.tan(delta) + TOL * np.abs(exact))
    W, H = gt.resolution
    x = np.array([0.0, W / 3, W - 1.0], np.float32)
    y = np.array([0.0, H / 2, H - 1.0], np.float32)
    gaze = (W / 2 + 10, H / 2 - 5)
    a = np.asarray(gj.pix2eccentricity((W, H), jnp.asarray(x), jnp.asarray(y), gaze))
    b = gt.pix2eccentricity((W, H), torch.from_numpy(x), torch.from_numpy(y), gaze).numpy()
    assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())


def test_fixed_ppd_geometry_matches_jax():
    gj = cj.vvdp_display_geometry((1920, 1080), ppd=40.0)
    gt = ct.vvdp_display_geometry((1920, 1080), ppd=40.0)
    ecc = np.array([0.0, 5.0, 20.0], np.float32)
    assert gt.get_ppd(ecc) == gj.get_ppd(ecc) == 40.0
    assert np.array_equal(gt.get_resolution_magnification(ecc).numpy(),
                          np.asarray(gj.get_resolution_magnification(jnp.asarray(ecc))))
    x, y = np.array([0.0, 100.0], np.float32), np.array([10.0, 50.0], np.float32)
    a = np.asarray(gj.pix2eccentricity((1920, 1080), jnp.asarray(x), jnp.asarray(y), (5, 6)))
    b = gt.pix2eccentricity((1920, 1080), torch.from_numpy(x), torch.from_numpy(y),
                            (5, 6)).numpy()
    assert _rel(b, a) <= TOL
