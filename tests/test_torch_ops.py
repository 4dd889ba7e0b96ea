"""Host-side modules of the PyTorch port against the JAX package and the
BASELINE.md stage goldens (CPU, small seeded inputs)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import colorspace as cs_j  # noqa: E402
from colorvideovdp_tpu.ops import masking as mk_j  # noqa: E402
from colorvideovdp_tpu.ops import pyramid as pyr_j  # noqa: E402
from colorvideovdp_tpu.ops import temporal as tmp_j  # noqa: E402
from colorvideovdp_tpu.ops.blur import gaussian_blur as blur_j  # noqa: E402
from colorvideovdp_tpu_torch.ops import colorspace as cs_t  # noqa: E402
from colorvideovdp_tpu_torch.ops import masking as mk_t  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr_t  # noqa: E402
from colorvideovdp_tpu_torch.ops import temporal as tmp_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.blur import gaussian_blur as blur_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels.csf_lut import csf_lut_plain  # noqa: E402
from colorvideovdp_tpu_torch.utils.config import config_files  # noqa: E402

DISPLAYS = ["standard_4k", "standard_hdr_pq", "standard_hdr_hlg", "standard_hdr_linear",
            "standard_fhd"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_config_reads_jax_package_data_in_place():
    path = config_files.find("cvvdp_parameters.json")
    assert path.endswith("colorvideovdp_tpu/vvdp_data/cvvdp_parameters.json")


@pytest.mark.parametrize("display", DISPLAYS + ["gamma2.2"])
def test_display_forward_and_dkl_match_jax(display):
    rng = np.random.RandomState(1)
    V = rng.rand(1, 3, 2, 8, 16).astype(np.float32)
    if display == "gamma2.2":
        dj = cj.vvdp_display_photo_eotf(200, contrast=1000, source_colorspace="Adobe RGB (1998)",
                                        E_ambient=100)
        dt = ct.vvdp_display_photo_eotf(200, contrast=1000, source_colorspace="Adobe RGB (1998)",
                                        E_ambient=100)
        assert dt.EOTF == "2.2"
    else:
        dj = cj.vvdp_display_photometry.load(display)
        dt = ct.vvdp_display_photometry.load(display)
    if dt.EOTF == "linear":
        V = V * 500.0
    lin_j = np.asarray(dj.forward(jnp.asarray(V)))
    lin_t = dt.forward(_t(V)).numpy()
    assert _rel(lin_t, lin_j) < 1e-5
    dkl_j = np.asarray(dj.source_2_target_colorspace(jnp.asarray(V), "DKLd65"))
    dkl_t = dt.source_2_target_colorspace(_t(V), "DKLd65").numpy()
    assert _rel(dkl_t, dkl_j) < 1e-5


def test_colorspace_curves_match_jax():
    rng = np.random.RandomState(2)
    V = rng.rand(3, 1, 4, 32).astype(np.float32)
    assert _rel(cs_t.srgb2lin(_t(V)).numpy(), np.asarray(cs_j.srgb2lin(V))) < 1e-6
    assert _rel(cs_t.pq2lin(_t(V)).numpy(), np.asarray(cs_j.pq2lin(V))) < 1e-6
    assert _rel(cs_t.hlg2lin(_t(V), 1.2).numpy(), np.asarray(cs_j.hlg2lin(V, 1.2))) < 1e-6


def test_baseline_goldens_ppd_bands_dkl():
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    assert m.pix_per_deg == pytest.approx(75.40244934516305, rel=1e-12)
    freqs, height = pyr_t.pyramid_band_freqs(1024, 683, m.pix_per_deg)
    assert height + 1 == 9
    np.testing.assert_allclose(
        freqs, [37.701225, 12.169955, 6.084978, 3.042489, 1.521244, 0.760622, 0.380311,
                0.190156, 0.095078], rtol=0, atol=5e-7)  # goldens have 6 decimals
    fj, hj = pyr_j.pyramid_band_freqs(1024, 683, m.pix_per_deg)
    assert hj == height and np.array_equal(fj, freqs)
    px = torch.tensor([0.5, 0.2, 0.8], dtype=torch.float32).reshape(1, 3, 1, 1, 1)
    dkl = m.display_photometry.source_2_target_colorspace(px, "DKLd65").reshape(-1).numpy()
    np.testing.assert_allclose(dkl, [26.158955, 0.447117, 89.394264], rtol=2e-6, atol=2e-6)


def test_csf_rows_and_goldens():
    mj = cj.cvvdp(display_name="standard_4k", quiet=True)
    mt = ct.cvvdp(display_name="standard_4k", device="cpu")
    for rho in (0.1, 2.0, 16.0, 37.7):
        for om, cc in ((0, 0), (0, 1), (0, 2), (5, 0)):
            np.testing.assert_array_equal(mt.csf.logS_of_logL(rho, om, cc),
                                          mj.csf.logS_of_logL(rho, om, cc))
    x0, x1 = mt.csf.lut_range()
    # BASELINE.md castleCSF samples S(rho, omega, log10 L, channel).
    for rho, om, logL, cc, want in ((2, 0, 2.0, 0, 288.107727), (2, 0, 2.0, 1, 294.149475),
                                    (2, 0, 2.0, 2, 63.754951), (2, 5, 2.0, 0, 311.582092),
                                    (16, 0, 0.0, 0, 4.033122), (0.5, 0, 1.0, 1, 181.329666)):
        lut = _t(mt.csf.logS_of_logL(rho, om, cc)[None])
        S = float(csf_lut_plain(torch.tensor([logL]), lut, x0, x1)[0, 0])
        assert S == pytest.approx(want, rel=1e-4)
    S_j = np.asarray(mj.csf.sensitivity_multi_channel(
        [2.0] * 4, [0, 0, 0, 5], jnp.linspace(-4.0, 5.0, 257), [0, 1, 2, 0]))
    S_t = mt.csf.sensitivity_multi_channel([2.0] * 4, [0, 0, 0, 5], torch.linspace(-4.0, 5.0, 257),
                                           [0, 1, 2, 0]).numpy()
    assert _rel(S_t, S_j) < 1e-5


def test_temporal_filters_match_jax_and_goldens():
    sigma, beta = np.array([5.79336, 14.1255, 6.63661, 0.12314]), np.array(
        [1.3314, 1.1196, 0.947901, 0.1898])
    Ft, om_t = tmp_t.get_temporal_filters(30, sigma, beta)
    Fj, om_j = tmp_j.get_temporal_filters(30, sigma, beta)
    assert len(Ft[0]) == 9
    for a, b in zip(Ft, Fj):
        np.testing.assert_array_equal(a, b)
    assert Ft[0][4] == pytest.approx(0.213727, abs=1e-6)
    assert Ft[3][4] == pytest.approx(0.661264, abs=1e-6)
    rng = np.random.RandomState(4)
    buf = rng.rand(1, 3, 9 + 3 - 1, 4, 8).astype(np.float32)
    filt = np.stack([f[::-1] for f in Ft])
    out_t = tmp_t.apply_temporal_filters(_t(buf), filt).numpy()
    out_j = np.asarray(tmp_j.apply_temporal_filters(jnp.asarray(buf), filt))
    assert _rel(out_t, out_j) < 1e-6


@pytest.mark.parametrize("shape", [(2, 3, 17, 33), (1, 2, 24, 40), (1, 1, 5, 7)])
def test_plain_reduce_and_expand_match_jax(shape):
    rng = np.random.RandomState(5)
    x = rng.rand(*shape).astype(np.float32)
    y_t = pyr_t.reduce_plain(_t(x)).numpy()
    y_j = np.asarray(pyr_j._xla_reduce(jnp.asarray(x)))
    assert y_t.shape == y_j.shape
    assert np.abs(y_t - y_j).max() <= 1e-6 * max(1.0, np.abs(y_j).max())
    sz = (2 * shape[-2] - 1, 2 * shape[-1])
    e_t = pyr_t.gausspyr_expand(_t(x), sz).numpy()
    e_j = np.asarray(pyr_j.gausspyr_expand(jnp.asarray(x), sz))
    assert e_t.shape == e_j.shape
    assert np.abs(e_t - e_j).max() <= 1e-6


def test_blur_and_masking_match_jax():
    mj = cj.cvvdp(display_name="standard_4k", quiet=True)
    pj = mj._masking_params()
    pt = ct.cvvdp(display_name="standard_4k", device="cpu")._masking_params()
    rng = np.random.RandomState(6)
    M = rng.rand(1, 4, 2, 20, 24).astype(np.float32)
    assert _rel(blur_t(_t(M), 13, 3.0).numpy(), np.asarray(blur_j(jnp.asarray(M), 13, 3.0))) < 1e-6
    T = rng.randn(1, 4, 2, 20, 24).astype(np.float32)
    R = T + 0.3 * rng.randn(1, 4, 2, 20, 24).astype(np.float32)
    S = (rng.rand(1, 4, 2, 20, 24) * 50 + 1).astype(np.float32)
    for h, w in ((20, 24), (5, 24)):  # the second skips the blur
        sl = (Ellipsis, slice(0, h), slice(0, w))
        D_j = np.asarray(mk_j.apply_masking_model(jnp.asarray(T[sl]), jnp.asarray(R[sl]),
                                                  jnp.asarray(S[sl]), pj))
        D_t = mk_t.apply_masking_model(_t(T[sl]), _t(R[sl]), _t(S[sl]), pt).numpy()
        assert _rel(D_t, D_j) < 1e-5
        q_j = np.asarray(mk_j.lp_norm(jnp.asarray(D_j), 2.0, dim=(-2, -1), keepdim=False))
        q_t = mk_t.lp_norm(_t(D_j), 2.0, dim=(-2, -1), keepdim=False).numpy()
        assert _rel(q_t, q_j) < 1e-6
    Q = np.array([0.01, 0.1, 0.5, 3.0, 40.0], np.float32)
    np.testing.assert_allclose(mk_t.met2jod(_t(Q), mj.jod_a, mj.jod_exp).numpy(),
                               np.asarray(mk_j.met2jod(jnp.asarray(Q), mj.jod_a, mj.jod_exp)),
                               rtol=1e-6)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        ct.cvvdp(display_name="standard_4k", device="cpu", dump_channels=["difference"])
