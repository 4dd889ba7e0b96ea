"""The port's aux metrics (PSNR-RGB, PU21-PSNR-Y, PU21-PSNR-RGB2020, SSIM)
against the JAX package on seeded images and videos (CPU)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.metrics import psnr as psnr_j  # noqa: E402
from colorvideovdp_tpu.metrics import ssim as ssim_j  # noqa: E402
from colorvideovdp_tpu_torch.metrics import psnr as psnr_t  # noqa: E402
from colorvideovdp_tpu_torch.metrics import ssim as ssim_t  # noqa: E402

DB_TOL, SSIM_TOL = 1e-4, 1e-5
PAIRS = [(psnr_j.psnr_rgb, psnr_t.psnr_rgb), (psnr_j.pu_psnr_y, psnr_t.pu_psnr_y),
         (psnr_j.pu_psnr_rgb2020, psnr_t.pu_psnr_rgb2020),
         (ssim_j.ssim_metric, ssim_t.ssim_metric)]


def _content(kind, frames):
    """(test, ref) as (F, 3, H, W): uint8 SDR or float HDR (cd/m^2)."""
    rng = np.random.RandomState(5 + frames)
    ref = rng.rand(frames, 3, 36, 52)
    test = np.clip(ref + rng.randn(*ref.shape) * 0.04, 0, 1)
    if kind == "sdr":
        return (test * 255).astype(np.uint8), (ref * 255).astype(np.uint8)
    return (test * 600 + 0.1).astype(np.float32), (ref * 600 + 0.1).astype(np.float32)


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("kind,display", [("sdr", "standard_4k"),
                                          ("hdr", "standard_hdr_linear")])
@pytest.mark.parametrize("idx", range(len(PAIRS)))
def test_aux_metric_matches_jax(idx, kind, display, frames):
    cls_j, cls_t = PAIRS[idx]
    test, ref = _content(kind, frames)
    dims = "FCHW" if frames > 1 else "CHW"
    if frames == 1:
        test, ref = test[0], ref[0]
    a, _ = cls_j(display_name=display).predict(test, ref, dim_order=dims,
                                               frames_per_second=24 if frames > 1 else 0)
    b, _ = cls_t(display_name=display, device="cpu").predict(
        test, ref, dim_order=dims, frames_per_second=24 if frames > 1 else 0)
    assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
    a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
    assert a.shape == b.shape and np.all(np.isfinite(b))
    tol = SSIM_TOL if cls_t is ssim_t.ssim_metric else DB_TOL
    assert np.abs(a - b).max() <= tol, (a, b)


def test_psnr_batch_matches_jax():
    test, ref = _content("sdr", 3)
    test = np.stack([test, ref])  # B = 2: one pair identical in every frame
    ref = np.stack([ref, ref])
    a, _ = psnr_j.psnr_rgb(display_name="standard_4k").predict(
        test, ref, dim_order="BFCHW", frames_per_second=24)
    b, _ = psnr_t.psnr_rgb(display_name="standard_4k", device="cpu").predict(
        test, ref, dim_order="BFCHW", frames_per_second=24)
    assert b.shape == (2,) and np.isinf(b[1].item()) and np.isinf(np.asarray(a)[1])
    assert abs(float(a[0]) - float(b[0])) <= DB_TOL


def test_pu_psnr_y_error_is_on_unencoded_luminance():
    """The squared error is taken on the display's linear luminance, and the
    PU21 code of 100 cd/m^2 is the peak (the reference metric's quirk)."""
    test, ref = _content("hdr", 1)
    m = psnr_t.pu_psnr_y(display_name="standard_hdr_linear", device="cpu")
    dm = m.display_photometry
    Y = [dm.source_2_target_colorspace(torch.from_numpy(x[:, None][None]), "Y")
         for x in (test[0], ref[0])]
    mse = float(torch.mean((Y[0] - Y[1]) ** 2))
    want = 20 * np.log10(float(ct.PU().encode(100.0)) / np.sqrt(mse))
    got, _ = m.predict(test[0], ref[0], dim_order="CHW")
    assert m.max_I == pytest.approx(float(ct.PU().encode(100.0)))
    assert abs(float(got) - want) <= DB_TOL
    # Not the error of the PU-encoded values.
    enc = [m.pu.encode(y) for y in Y]
    assert abs(float(got) - 20 * np.log10(m.max_I / np.sqrt(
        float(torch.mean((enc[0] - enc[1]) ** 2))))) > 1.0


def test_registry_names_and_units_match_jax():
    for name in ("psnr_rgb", "pu_psnr_y", "pu_psnr_rgb2020", "ssim_metric"):
        assert name in ct.vq_metric_dict and name in cj.vq_metric_dict
        mj = cj.vq_metric_dict[name](display_name="standard_4k")
        mt = ct.vq_metric_dict[name](display_name="standard_4k", device="cpu")
        assert (mt.short_name(), mt.quality_unit()) == (mj.short_name(), mj.quality_unit())


def test_aux_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for cls in (ct.psnr_rgb, ct.pu_psnr_y, ct.pu_psnr_rgb2020, ct.ssim_metric):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(display_name="standard_4k")
