"""The heatmap path of the PyTorch port against the JAX package (CPU).

The D-output mode of the band kernel's plain version against the JAX fused
band route with ``pool_beta=None`` (Pallas, interpret mode), the Laplacian
reconstruct, the colour mapping against ``colorvideovdp_tpu.viz``, and
``predict`` with a heatmap on images and multi-block videos. Inputs are
seeded numpy arrays handed to both packages. Heatmaps are stored as float16,
whose quantum in [0.5, 1) is 4.9e-4: 1.1e-3 allows one quantum either way of
a float32 difference of a few ulps (tests/test_viz.py holds the JAX package
to the same bound against the reference).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu import viz as viz_j  # noqa: E402
from colorvideovdp_tpu.metrics.base import vq_exception as vq_exception_j  # noqa: E402
from colorvideovdp_tpu.ops import masking as mk_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels.masking_fused import make_fused_mult_mutual_raw  # noqa: E402
from colorvideovdp_tpu.ops.pyramid import LaplacianPyramid as LaplacianPyramid_j  # noqa: E402
from colorvideovdp_tpu_torch import viz as viz_t  # noqa: E402
from colorvideovdp_tpu_torch.metrics.base import vq_exception  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.pyramid import LaplacianPyramid  # noqa: E402
from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters  # noqa: E402

HM_TOL = 1.1e-3
H, W, FPS = 48, 256, 30.0


@pytest.fixture(scope="module")
def metrics():
    return (cj.cvvdp(display_name="standard_4k", quiet=True),
            ct.cvvdp(display_name="standard_4k", device="cpu"))


def _luts(m, rhos, C):
    return np.stack([np.stack([m.csf.logS_of_logL(r, m.omega[0 if cc < 3 else 1],
                                                  cc if cc < 3 else 0) for cc in range(C)])
                     for r in rhos])


def _band_D_pair(metrics, C, h, w, seed):
    """D of one seeded band from the JAX fused raw route (pool_beta=None)
    and from the port's D mode (plain on the CPU)."""
    mj, mt = metrics
    params = mj._masking_params()
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    sens = 10.0 ** (mj.sensitivity_correction / 20.0)
    rng = np.random.RandomState(seed)
    gi = (30.0 + 20.0 * rng.rand(1, 2 * C, 2, h, w)).astype(np.float32)
    E = (gi + rng.randn(*gi.shape)).astype(np.float32)
    luts = _luts(mj, [6.08], C)
    gains = np.array([1.0, 1.45, 1.0, 1.0], np.float32)[:C]
    fused = make_fused_mult_mutual_raw(luts[0], x0, x1, gains, sens, params,
                                       lambda M: mk_j.phase_uncertainty(M, params),
                                       False, 2.0, pool_beta=None)
    D_j = np.asarray(fused(jnp.asarray(gi), jnp.asarray(E)))
    k = bm_t.BandConsts.make(mt._masking_params(), C, x0, x1, sens, False, 2.0)
    (D_t,) = bm_t.band_masking_d_plain([torch.from_numpy(gi)], [torch.from_numpy(E)],
                                       torch.from_numpy(luts), [2.0], k)
    return D_t.numpy(), D_j, k


@pytest.mark.parametrize("C", [4, 3])
def test_band_D_matches_fused_blur_transducer(metrics, C):
    """Row 5: the JAX route is fused_csf_contrast_raw + fused_blur_transducer
    in D mode; bound as the JAX package holds its own kernels
    (tests/test_fused_kernels.py:314-316)."""
    D_t, D_j, _ = _band_D_pair(metrics, C, 32, 256, seed=5)
    assert D_t.shape == D_j.shape == (1, C, 2, 32, 256)
    assert np.abs(D_t - D_j).max() <= 2e-4 * max(1.0, np.abs(D_j).max())


@pytest.mark.parametrize("C", [4, 3])
def test_band_D_noblur_matches_masking_transducer(metrics, C):
    """Row 6: a band of width 6 (<= pu_padsize) skips the blur; the JAX route
    is fused_csf_contrast_raw, phase_uncertainty (x 10^mask_c only) and
    fused_masking_transducer."""
    D_t, D_j, k = _band_D_pair(metrics, C, 16, 6, seed=6)
    assert not k.params.blurs(16, 6)
    assert D_t.shape == D_j.shape == (1, C, 2, 16, 6)
    assert np.abs(D_t - D_j).max() <= 2e-4 * max(1.0, np.abs(D_j).max())


def test_pooled_sums_are_the_D_mode_summed(metrics):
    """The pooled and D modes share one plain chain."""
    _, mt = metrics
    mt._ensure_pyramids(256, 48)
    consts, luts = mt._band_tables(4)
    rng = np.random.RandomState(8)
    shapes = [(24, 128), (6, 32)]
    gis = [torch.from_numpy((30 + 20 * rng.rand(1, 8, 3, h, w)).astype(np.float32))
           for h, w in shapes]
    Es = [g + torch.from_numpy(rng.randn(*g.shape).astype(np.float32)) for g in gis]
    sums = bm_t.band_masking_plain(gis, Es, luts[1:3], [2.0, 2.0], consts)
    Ds = bm_t.band_masking_d_plain(gis, Es, luts[1:3], [2.0, 2.0], consts)
    for s, D in zip(sums, Ds):
        assert torch.equal(s, torch.sum((D + 1e-5) ** 2 - 1e-10, dim=(-2, -1)))


def test_band_groups_in_D_mode():
    """D adds C planes per band to the launch budget, and a band without the
    blur never shares a launch with one that has it."""
    shapes = [(96, 512), (48, 256), (24, 128), (12, 64), (6, 32), (3, 16)]
    blurs = [True, True, True, True, False, False]
    assert bm_t.band_groups(shapes, 1, 4, 2) == [[0, 1, 2, 3, 4, 5]]
    assert bm_t.band_groups(shapes, 1, 4, 2, blurs) == [[0, 1, 2, 3], [4, 5]]
    # 3.75 M pixels of C = 4: 4 C planes (240 MB) fit the 256 MiB budget, 5 do not.
    big = [(1500, 2000), (750, 1000)]
    assert bm_t.band_groups(big, 1, 4, 1) == [[0, 1]]
    assert bm_t.band_groups(big, 1, 4, 1, [True, True]) == [[0], [1]]


def test_reconstruct_matches_jax():
    """Odd 37x61 levels; get_band/set_band keep the interior half gain."""
    ppd = 75.4
    lp_j, lp_t = LaplacianPyramid_j(61, 37, ppd), LaplacianPyramid(61, 37, ppd)
    assert lp_t.pyr_shape == lp_j.pyr_shape and len(lp_t.pyr_shape) >= 4
    rng = np.random.RandomState(9)
    bands = [rng.randn(1, 1, 2, h, w).astype(np.float32) for h, w in lp_t.pyr_shape]
    r_j = np.asarray(lp_j.reconstruct([jnp.asarray(b) for b in bands]))
    r_t = lp_t.reconstruct([torch.from_numpy(b) for b in bands]).numpy()
    assert r_t.shape == r_j.shape == (1, 1, 2, 37, 61)
    assert np.abs(r_t - r_j).max() <= 1e-6 * max(1.0, np.abs(r_j).max())
    bj, bt = list(bands), [torch.from_numpy(b) for b in bands]
    for i in range(len(bands)):
        np.testing.assert_array_equal(LaplacianPyramid.get_band(bt, i).numpy(),
                                      np.asarray(LaplacianPyramid_j.get_band(bj, i)))
        LaplacianPyramid.set_band(bt, i, torch.from_numpy(bands[i]))
        LaplacianPyramid_j.set_band(bj, i, bands[i])
        np.testing.assert_array_equal(bt[i].numpy(), bj[i])


def _context(case, rng):
    if case == "narrow":  # log-luminance range below the 0.6 of the tone map
        return (40.0 + 10.0 * rng.rand(1, 2, 24, 40)).astype(np.float32)
    frames = 3 if case == "three-frames" else 2
    return rng.lognormal(mean=2.0, sigma=1.5, size=(1, frames, 24, 40)).astype(np.float32)


@pytest.mark.parametrize("case", ["wide", "narrow", "three-frames"])
def test_tonemap_matches_jax(case):
    """The log-luminance within one float32 rounding, the tone map bit-equal
    on the same log-luminance, and end to end within the heatmap bound. A
    3-frame context takes the NC*** luminance branch (quirk 11) in both."""
    ctx = _context(case, np.random.RandomState(10))
    b_j = viz_j._log_luminance(ctx)
    b_t = viz_t._log_luminance(torch.from_numpy(ctx))
    assert b_t.shape == b_j.shape == ((1, 1) if case == "three-frames" else ctx.shape[:2]) + (24, 40)
    assert np.abs(b_t.numpy() - b_j).max() <= 2.4e-7 * np.abs(b_j).max()
    t_j = viz_j.vis_tonemap(b_j, 0.6)
    np.testing.assert_array_equal(viz_t.vis_tonemap(torch.from_numpy(b_j), 0.6).numpy(), t_j)
    assert np.abs(viz_t.vis_tonemap(b_t, 0.6).numpy() - t_j).max() <= HM_TOL


def test_histogram_matches_numpy_on_bin_edges():
    """Values on and next to every bin edge land in numpy's bins."""
    lo, hi = -3.25, 7.5
    edges = np.linspace(lo, hi, 1025, dtype=np.float32)
    a = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                        np.nextafter(edges, np.float32(np.inf)),
                        np.random.RandomState(11).uniform(lo, hi, 5000).astype(np.float32)])
    a = np.clip(a, np.float32(lo), np.float32(hi))
    want, _ = np.histogram(a, bins=1024, range=(lo, hi))
    np.testing.assert_array_equal(viz_t._histogram(torch.from_numpy(a), 1024, lo, hi), want)


@pytest.mark.parametrize("cmap", ["threshold", "supra-threshold", "monochromatic"])
def test_visualize_diff_map_matches_jax(cmap):
    rng = np.random.RandomState(12)
    ctx = _context("wide", rng)
    dm = (rng.rand(1, 1, 2, 24, 40) * 0.4).astype(np.float32)
    want = np.asarray(viz_j.visualize_diff_map(dm, context_image=ctx, colormap_type=cmap),
                      np.float16).astype(np.float32)
    got = viz_t.visualize_diff_map(torch.from_numpy(dm), torch.from_numpy(ctx),
                                   cmap).to(torch.float16).float().numpy()
    assert got.shape == want.shape == (3, 2, 24, 40)
    assert np.abs(got - want).max() <= HM_TOL
    no_ctx_j = viz_j.visualize_diff_map(dm, colormap_type=cmap)
    no_ctx_t = viz_t.visualize_diff_map(torch.from_numpy(dm), None, cmap).numpy()
    assert np.abs(no_ctx_t - no_ctx_j).max() <= HM_TOL


def test_visualize_three_frame_context_fails_like_jax():
    """Quirk 11 end to end: the 3-frame context becomes one luminance plane,
    and the colour mapping then fails in both packages."""
    rng = np.random.RandomState(13)
    ctx = _context("three-frames", rng)
    dm = (rng.rand(1, 1, 3, 24, 40) * 0.4).astype(np.float32)
    with pytest.raises(ValueError):
        viz_j.visualize_diff_map(dm, context_image=ctx)
    with pytest.raises(ValueError):
        viz_t.visualize_diff_map(torch.from_numpy(dm), torch.from_numpy(ctx))


def _pair(N, seed):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(H, W, 3, N) * 0.8 * 255).astype(np.uint8)
    noise = rng.randn(H, W, 3, N) * 12
    test = np.clip(ref + noise, 0, 255).astype(np.uint8)
    return test, ref


def _hm(stats):
    return np.asarray(stats["heatmap"], np.float32)


@pytest.mark.parametrize("hm_type", ["raw", "supra-threshold"])
def test_image_heatmap_matches_jax(hm_type):
    """48x256 on standard_4k: the pyramid's band 3 is 6 rows, so the blur-off
    band is on this path."""
    test, ref = _pair(1, 14)
    test, ref = test[..., 0], ref[..., 0]
    Qj, sj = cj.cvvdp(display_name="standard_4k", heatmap=hm_type, quiet=True).predict(
        test, ref, dim_order="HWC")
    mt = ct.cvvdp(display_name="standard_4k", heatmap=hm_type, device="cpu")
    Qt, st = mt.predict(test, ref, dim_order="HWC")
    assert st["heatmap"].dtype == sj["heatmap"].dtype == np.float16
    assert st["heatmap"].shape == sj["heatmap"].shape == (1, 1 if hm_type == "raw" else 3, 1, H, W)
    assert np.abs(_hm(st) - _hm(sj)).max() <= HM_TOL
    assert abs(float(Qt) - float(Qj)) <= 1e-4
    assert not all(mt._masking_params().blurs(*s) for s in mt.lpyr.pyr_shape[:-1])
    Q0, _ = ct.cvvdp(display_name="standard_4k", device="cpu").predict(test, ref,
                                                                       dim_order="HWC")
    assert abs(float(Qt) - float(Q0)) <= 1e-4


def _gpu_mem_for(block, N, jax_side):
    """gpu_mem (GB) that makes each package's block-size model pick ``block``
    frames at H x W (the two packages use different memory models)."""
    pix = H * W
    fl = len(get_temporal_filters(FPS, *[np.asarray(v) for v in (
        [5.79336, 14.1255, 6.63661, 0.12314], [1.3314, 1.1196, 0.947901, 0.1898])])[0][0])
    if jax_side:
        return (0.6e9 + pix * (fl - 1) * 24 + pix * (24 + 92) * (block + 0.5)) / 1e9
    return (1.6e9 + pix * (fl - 1) * 16 + pix * (16 + 320) * (block + 0.5)) / 1e9


def _video_pair_metrics(hm_type, N, block):
    mj = cj.cvvdp(display_name="standard_4k", heatmap=hm_type, quiet=True,
                  gpu_mem=_gpu_mem_for(block, N, True))
    mt = ct.cvvdp(display_name="standard_4k", heatmap=hm_type, device="cpu",
                  gpu_mem=_gpu_mem_for(block, N, False))
    return mj, mt


def test_video_heatmap_multiblock_matches_jax():
    """13 frames in blocks of 5, 5 and 3 on both sides (asserted): the raw
    heatmap and the JOD. The colour heatmap on 12 frames (5, 5, 2), with the
    same metrics: its tone map is block-scoped, so it matches only with
    matching blocks. With 13 frames the trailing 3-frame context hits quirk
    11, and the colour mapping fails in both packages."""
    test, ref = _pair(13, 15)
    mj, mt = _video_pair_metrics("raw", 13, 5)
    Qj, sj = mj.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)
    Qt, st = mt.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)
    assert mj.estimate_block_N(H * W, 13) == st["block_N_frames"] == 5
    assert st["heatmap"].shape == sj["heatmap"].shape == (1, 1, 13, H, W)
    assert np.abs(_hm(st) - _hm(sj)).max() <= HM_TOL
    assert abs(float(Qt) - float(Qj)) <= 1e-4
    # The colour map is drawn outside the JAX jit: switching the type reuses
    # the compiled block step.
    mj.heatmap = mt.heatmap = "supra-threshold"
    _, sj = mj.predict(test[..., :12], ref[..., :12], dim_order="HWCF", frames_per_second=FPS)
    _, st = mt.predict(test[..., :12], ref[..., :12], dim_order="HWCF", frames_per_second=FPS)
    assert st["block_N_frames"] == 5 and mj.estimate_block_N(H * W, 12) == 5
    assert st["heatmap"].shape == sj["heatmap"].shape == (1, 3, 12, H, W)
    assert np.abs(_hm(st) - _hm(sj)).max() <= HM_TOL
    for m in (mj, mt):
        with pytest.raises(ValueError):
            m.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)


def test_raw_heatmap_is_block_size_invariant():
    test, ref = _pair(13, 16)
    hms = []
    for gm in (_gpu_mem_for(5, 13, False), None):
        m = ct.cvvdp(display_name="standard_4k", heatmap="raw", device="cpu", gpu_mem=gm)
        _, st = m.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)
        assert st["block_N_frames"] == (5 if gm else 13)
        hms.append(_hm(st))
    assert np.abs(hms[0] - hms[1]).max() < 2.5e-4


def test_heatmap_rejects_batches_and_unknown_types():
    test, ref = _pair(1, 17)
    batch = np.stack([test[..., 0], ref[..., 0]])
    refs = np.stack([ref[..., 0]] * 2)
    with pytest.raises(vq_exception_j):
        cj.cvvdp(display_name="standard_4k", heatmap="raw", quiet=True).predict(
            batch, refs, dim_order="BHWC")
    with pytest.raises(vq_exception):
        ct.cvvdp(display_name="standard_4k", heatmap="raw", device="cpu").predict(
            batch, refs, dim_order="BHWC")
    with pytest.raises(AssertionError):
        cj.cvvdp(display_name="standard_4k", heatmap="jet")
    with pytest.raises(AssertionError):
        ct.cvvdp(display_name="standard_4k", heatmap="jet", device="cpu")
    m = ct.cvvdp(display_name="standard_4k", heatmap="none", device="cpu")
    assert "heatmap" not in m.predict(test[..., 0], ref[..., 0], dim_order="HWC")[1]


def test_export_distogram(tmp_path):
    pytest.importorskip("matplotlib")
    from PIL import Image

    test, ref = _pair(4, 18)
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    for name, (t, r, kw) in {"image": (test[..., 0], ref[..., 0], dict(dim_order="HWC")),
                             "video": (test, ref, dict(dim_order="HWCF",
                                                       frames_per_second=FPS))}.items():
        _, stats = m.predict(t, r, **kw)
        dest = tmp_path / f"{name}.png"
        m.export_distogram(stats, str(dest), jod_max=10)
        img = Image.open(dest)
        assert img.size[0] > 50 and img.size[1] > 50
