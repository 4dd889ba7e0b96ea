"""The non-default contrast codings of the PyTorch port against the JAX
package (CPU): weber_g1, weber_g1_ref, weber_g0_ref and log.

The decompositions, the contrast-band stage of the band kernel (the JAX
package's ``fused_csf_contrast``, Pallas in interpret mode) and the whole
contrast-band route (``make_fused_mult_mutual``), then ``predict`` on an
image and a multi-block video per contrast, a log-contrast heatmap, the
weber_g0_ref loss and gradient, and ``params_from_jax`` carrying a
non-default configuration. Configurations are copies of the default
``cvvdp_parameters.json`` with a few keys changed, passed as
``config_paths``. Inputs are seeded numpy arrays handed to both packages;
each JAX metric is built once per module.
"""

import os

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
from colorvideovdp_tpu_torch.convert import params_from_jax  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402
from colorvideovdp_tpu_torch.utils.config import write_parameters  # noqa: E402

CONTRASTS = ["weber_g1", "weber_g1_ref", "weber_g0_ref", "log"]
H, W, N, FPS = 32, 96, 7, 30.0
# Port-side gpu_mem (GB) that gives 3-frame blocks at 32x96 under the
# reference memory model (a = 1.6e9, b = 16, c = 320): blocks 3 + 3 + 1(+2).
SMALL_GPU_MEM = (1.6e9 + H * W * 8 * 16 + H * W * 336 * 3.5) / 1e9
HM_TOL = 1.1e-3


def write_config(root, **over):
    """``config_paths`` for the default configuration with ``over``."""
    return write_parameters(os.path.join(str(root), "_".join(f"{k}-{v}" for k, v in over.items())),
                            **over)


def _clip(seed, n=N):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(H, W, 3, n) * 200 + 20).astype(np.uint8)
    test = np.clip(ref + rng.randn(H, W, 3, n) * 10, 0, 255).astype(np.uint8)
    return test, ref


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvvdp_configs")
    return {c: write_config(root, contrast=c) for c in CONTRASTS}


@pytest.fixture(scope="module")
def jax_metrics(configs):
    return {c: cj.cvvdp(display_name="standard_4k", quiet=True, config_paths=configs[c])
            for c in CONTRASTS}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("contrast", CONTRASTS)
def test_decompose_matches_jax(contrast):
    """Bands and log-luminance of the non-raw decomposition, and the raw-pair
    baseband of every contrast, on interleaved metric-space frames."""
    rng = np.random.RandomState(2)
    R = (rng.rand(1, 8, 2, 40, 72) * 60 + 1).astype(np.float32)
    if contrast == "log":
        R = np.log10(R)
        pj = pyr_j.LogContrastPyramid(72, 40, 30.0)
        pt = pyr_t.LogContrastPyramid(72, 40, 30.0)
    else:
        pj = pyr_j.WeberContrastPyramid(72, 40, 30.0, contrast=contrast)
        pt = pyr_t.WeberContrastPyramid(72, 40, 30.0, contrast=contrast)
    bj, lj = pj.decompose(jnp.asarray(R))
    bt, lt = pt.decompose(torch.from_numpy(R), use_kernel=False)
    assert len(bt) == len(bj) >= 3
    for a, b, la, lb in zip(bt, bj, lt, lj):
        assert a.shape == b.shape and la.shape == lb.shape
        assert _rel(a.numpy(), b) <= 1e-5
        assert _rel(la.numpy(), lb) <= 1e-5
    if contrast != "log":
        bj, lj = pj.decompose(jnp.asarray(R), raw_pairs=True)
    # JAX's log pyramid has no raw-pair mode; its baseband is the same either way.
    bt, lt = pt.decompose(torch.from_numpy(R), raw_pairs=True, use_kernel=False)
    assert all(isinstance(b, tuple) for b in bt[:-1]) and lt[0] is None
    assert _rel(bt[-1].numpy(), bj[-1]) <= 1e-5
    assert _rel(lt[-1].numpy(), lj[-1]) <= 1e-5


def _contrast_band(jax_metrics, C, h, w, seed):
    """A seeded contrast band (1, 2C, 2, h, w), its logL, LUT rows and the
    port's band constants, as the metric forms them for one band."""
    mj = jax_metrics["weber_g0_ref"]
    mt = ct.cvvdp(display_name="standard_4k", device="cpu")
    rng = np.random.RandomState(seed)
    band = (rng.randn(1, 2 * C, 2, h, w) * 0.3).astype(np.float32)
    band[:, 1::2] = band[:, 0::2] + (rng.randn(1, C, 2, h, w) * 0.05).astype(np.float32)
    logL = (rng.rand(1, 1, 2, h, w) * 4 - 1).astype(np.float32)
    luts = np.stack([mj.csf.logS_of_logL(6.08, mj.omega[0 if cc < 3 else 1], cc if cc < 3 else 0)
                     for cc in range(C)])
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    sens = 10.0 ** (mj.sensitivity_correction / 20.0)
    k = bm.BandConsts.make(mt._masking_params(), C, x0, x1, sens, False, 2.0)
    return band, logL, luts, k


@pytest.mark.parametrize("C", [4, 3])
def test_csf_contrast_stage_matches_fused_csf_contrast(jax_metrics, C):
    """Row 7 itself: the plain version of the contrast-band stage A against
    the JAX package's Pallas ``fused_csf_contrast`` (interpret mode)."""
    band, logL, luts, k = _contrast_band(jax_metrics, C, 24, 136, seed=3)
    T4 = np.ascontiguousarray(band[0, 0::2])  # (C, L, h, w), L = B * F
    R4 = np.ascontiguousarray(band[0, 1::2])
    m_j, d_j = fused_csf_contrast(jnp.asarray(T4), jnp.asarray(R4), jnp.asarray(logL[0, 0]),
                                  luts, k.x0, k.x1, tuple(float(g) * k.sens_corr for g in k.ch_gain))
    m_t, d_t = bm.csf_contrast_plain(torch.from_numpy(band), torch.from_numpy(logL),
                                     torch.from_numpy(luts), k)
    assert _rel(m_t[0].numpy(), np.asarray(m_j)) <= 1e-5
    assert _rel(d_t[0].numpy(), np.asarray(d_j)) <= 1e-5


@pytest.mark.parametrize("C,h,w", [(4, 24, 160), (3, 24, 160), (4, 16, 6)],
                         ids=["C4-blur", "C3-blur", "C4-noblur"])
def test_contrast_band_matches_make_fused_mult_mutual(jax_metrics, C, h, w):
    """The whole contrast-band route, D mode and pooled, plain on the CPU,
    against the JAX package's ``make_fused_mult_mutual`` (its Pallas kernels
    in interpret mode, as ``force_fused`` runs them)."""
    band, logL, luts, k = _contrast_band(jax_metrics, C, h, w, seed=4)
    params = jax_metrics["weber_g0_ref"]._masking_params()
    fused = make_fused_mult_mutual(luts, k.x0, k.x1, k.ch_gain, k.sens_corr, params,
                                   lambda M: mk_j.phase_uncertainty(M, params))
    D_j = np.asarray(fused(jnp.asarray(band[:, 0::2]), jnp.asarray(band[:, 1::2]),
                           jnp.asarray(logL)))
    args = ([torch.from_numpy(band)], [torch.from_numpy(logL)], torch.from_numpy(luts[None]),
            [1.0], k)
    (D_t,) = bm.band_masking_d_plain(*args, contrast=True)
    assert D_t.shape == D_j.shape == (1, C, 2, h, w)
    assert np.abs(D_t.numpy() - D_j).max() <= 2e-4 * max(1.0, np.abs(D_j).max())
    sums = bm.band_masking_plain(*args, contrast=True)[0]
    assert torch.equal(sums, torch.sum((D_t + 1e-5) ** 2 - 1e-10, dim=(-2, -1)))


def test_band_groups_count_logL_plane():
    """A contrast band holds one logL plane in place of E's 2C planes."""
    big = [(1500, 2000), (750, 1000)]
    assert bm.band_groups(big, 1, 4, 1, [True, True]) == [[0], [1]]
    assert bm.band_groups(big, 1, 4, 1, [True, True], contrast=True) == [[0, 1]]
    assert bm.band_groups([(2000, 2000)] * 2, 1, 4, 1, contrast=True) == [[0], [1]]


@pytest.mark.parametrize("contrast", CONTRASTS)
def test_predict_matches_jax(configs, jax_metrics, contrast):
    """An image and a 7-frame video in port blocks of 3 + 3 + 1: |dJOD| <= 1e-4."""
    mj = jax_metrics[contrast]
    mt = ct.cvvdp(display_name="standard_4k", device="cpu", config_paths=configs[contrast],
                  gpu_mem=SMALL_GPU_MEM)
    test, ref = _clip(7)
    Qj, sj = mj.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)
    Qt, st = mt.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)
    assert st["block_N_frames"] == 3
    assert abs(float(Qj) - float(Qt)) <= 1e-4, (float(Qj), float(Qt))
    assert np.abs(st["Q_per_ch"] - sj["Q_per_ch"]).max() <= 1e-4 * np.abs(sj["Q_per_ch"]).max()
    Qj, _ = mj.predict(test[..., 0], ref[..., 0], dim_order="HWC")
    Qt, _ = mt.predict(test[..., 0], ref[..., 0], dim_order="HWC")
    assert abs(float(Qj) - float(Qt)) <= 1e-4 * max(1.0, abs(10.0 - float(Qj))), (
        float(Qj), float(Qt))


def test_log_contrast_colour_space_and_ingest():
    """logLMS_DKLd65 against the JAX display model, and the ingest chain in
    that space against its single-frame conversion."""
    rng = np.random.RandomState(9)
    V = rng.rand(1, 3, 2, 8, 16).astype(np.float32)
    dj = cj.vvdp_display_photometry.load("standard_hdr_pq")
    dt = ct.vvdp_display_photometry.load("standard_hdr_pq")
    a = dt.source_2_target_colorspace(torch.from_numpy(V), "logLMS_DKLd65").numpy()
    b = np.asarray(dj.source_2_target_colorspace(jnp.asarray(V), "logLMS_DKLd65"))
    assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())
    raws = [torch.from_numpy((rng.rand(1, 3, 3, 8, 16) * 255).astype(np.uint8)) for _ in range(2)]
    filt = np.full((4, 2), 0.5, np.float32)
    tails = [ing.raw_to_met(dt, r[:, :1], "logLMS_DKLd65") for r in raws]
    out, t_t, _ = ing.ingest(*tails, *raws, dt, filt, "logLMS_DKLd65")
    assert out.shape == (1, 8, 3, 8, 16)
    assert torch.equal(t_t, ing.raw_to_met(dt, raws[0][:, 2:], "logLMS_DKLd65"))


def test_log_contrast_heatmap_matches_jax(configs):
    """A raw heatmap with the log contrast, image and 5-frame video."""
    test, ref = _clip(11, n=5)
    mj = cj.cvvdp(display_name="standard_4k", quiet=True, heatmap="raw",
                  config_paths=configs["log"])
    mt = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap="raw",
                  config_paths=configs["log"])
    for t, r, kw in ((test, ref, dict(dim_order="HWCF", frames_per_second=FPS)),
                     (test[..., 0], ref[..., 0], dict(dim_order="HWC"))):
        Qj, sj = mj.predict(t, r, **kw)
        Qt, st = mt.predict(t, r, **kw)
        hj, ht = sj["heatmap"], st["heatmap"]
        assert ht.dtype == np.float16 and ht.shape == hj.shape
        assert np.abs(ht.astype(np.float32) - hj.astype(np.float32)).max() <= HM_TOL
        assert abs(float(Qj) - float(Qt)) <= 1e-4


@pytest.mark.parametrize("contrast", ["weber_g0_ref", "log"])
def test_weber_g0_ref_loss_and_gradient_match_jax(jax_metrics, configs, contrast):
    """get_loss_fn on the contrast codings' route (weber_g0_ref, and log,
    whose loss no other test holds against JAX): loss within 1e-4, gradient
    within 1e-3 of max|g| of ``jax.value_and_grad``."""
    B, Hl, Wl = 1, 48, 160
    rng = np.random.RandomState(17)
    ref = rng.rand(B, 3, 1, Hl, Wl).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    mj = jax_metrics[contrast]
    fn = jax.jit(jax.value_and_grad(mj.get_loss_fn(Hl, Wl, remat=False), argnums=(0, 1)))
    v_j, (gt_j, gr_j) = fn(jnp.asarray(test), jnp.asarray(ref))
    mt = ct.cvvdp(display_name="standard_4k", device="cpu", config_paths=configs[contrast])
    x, y = (torch.from_numpy(a).requires_grad_() for a in (test, ref))
    v = mt.get_loss_fn(Hl, Wl)(x, y)
    gt, gr = torch.autograd.grad(v, (x, y))
    assert abs(float(v.detach()) - float(v_j)) <= 1e-4
    for g, g_j in ((gt, gt_j), (gr, gr_j)):
        g_j = np.asarray(g_j)
        assert np.abs(g_j).max() > 0
        assert np.abs(g.numpy() - g_j).max() <= 1e-3 * np.abs(g_j).max()


def test_params_from_jax_carry_configuration(tmp_path):
    """A JAX metric built from a weber_g0_ref + mult-transducer configuration
    gives the same JOD as the port after ``load_parameters`` (the port itself
    built from the default configuration). Under the default calibration
    this model's distortions reach 1e5 and its JOD lies far below 0, where a
    float32 pooling sum moves the JOD by about 1e-6 of 10 - JOD, so the bound
    is 1e-4 of max(1, |10 - JOD|) (1e-4 JOD near 10)."""
    cp = write_config(tmp_path, contrast="weber_g0_ref", masking_model="mult-transducer",
                      ce_g=0.9)
    mj = cj.cvvdp(display_name="standard_4k", quiet=True, config_paths=cp)
    mt = ct.cvvdp(display_name="standard_4k", device="cpu")
    d = params_from_jax(mj)
    assert (d["contrast"], d["masking_model"], d["ce_g"]) == ("weber_g0_ref", "mult-transducer",
                                                             0.9)
    assert "k_c" not in d
    mt.load_parameters(d)
    test, ref = _clip(13)
    Qj, _ = mj.predict(test[..., 0], ref[..., 0], dim_order="HWC")
    Qt, _ = mt.predict(test[..., 0], ref[..., 0], dim_order="HWC")
    assert abs(float(Qj) - float(Qt)) <= 1e-4 * max(1.0, abs(10.0 - float(Qj))), (
        float(Qj), float(Qt))
