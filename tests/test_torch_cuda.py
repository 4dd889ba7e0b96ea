"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc; without a card they skip. They do
not import jax, so on a machine without it run them as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import colorvideovdp_tpu_torch as ct
from colorvideovdp_tpu_torch.ops import pyramid as pyr
from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d
from colorvideovdp_tpu_torch.ops.kernels import blur as bl
from colorvideovdp_tpu_torch.ops.kernels import csf_lut as lut
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm
from colorvideovdp_tpu_torch.ops.kernels.pyramid_reduce import pyramid_reduce
from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rel_planes(a, b):
    """The worst relative error over the (batch, channel) planes, so that a
    small channel is held to its own scale."""
    a, b = a.flatten(0, 1).flatten(1), b.flatten(0, 1).flatten(1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


@pytest.mark.parametrize("shape", [(2, 57, 256), (1, 66, 301), (3, 5, 7), (16, 270, 481)])
def test_reduce_kernel(dev, shape):
    x = torch.rand(shape, device=dev)
    y = pyramid_reduce(x)
    ref = pyr.reduce_plain(x)
    assert y.shape == ref.shape
    # The kernel rounds as the plain version does (csrc/common.cuh).
    assert torch.equal(y, ref)


@pytest.mark.parametrize("display,dtype", [("standard_4k", np.uint8),
                                           ("standard_hdr_pq", np.uint16),
                                           ("standard_hdr_hlg", np.uint16),
                                           ("standard_hdr_linear", np.uint16)])
def test_ingest_kernel(dev, display, dtype):
    m = ct.cvvdp(display_name=display, device="cuda")
    F, _ = get_temporal_filters(30, m.sigma_tf, m.beta_tf)
    filt = np.stack([f[::-1] for f in F])
    fl = filt.shape[1]
    rng = np.random.RandomState(0)
    raws = [m._upload((rng.rand(1, 5, 3, 67, 300) * np.iinfo(dtype).max).astype(dtype))
            for _ in range(2)]
    tails = [torch.rand(1, 3, fl - 1, 67, 300, device=dev) * 50 for _ in range(2)]
    before = ing.ingest.launches
    out = ing.ingest(*tails, *raws, m.display_photometry, filt)
    ref = ing.ingest_plain(*tails, *raws, m.display_photometry, filt)
    assert ing.ingest.launches == before + 1
    for a, b in zip(out, ref):
        assert _rel_planes(a, b) <= 1e-5


@pytest.mark.parametrize("B,C,dtype", [(2, 3, np.float32), (1, 1, np.uint8),
                                       (2, 1, np.float16)])
def test_ingest_kernel_batch_channels_float(dev, B, C, dtype):
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda")
    F, _ = get_temporal_filters(30, m.sigma_tf, m.beta_tf)
    filt = np.stack([f[::-1] for f in F])
    fl = filt.shape[1]
    rng = np.random.RandomState(1)
    scale = 255 if dtype == np.uint8 else 1.0
    raws = [m._upload((rng.rand(B, 4, C, 40, 136) * scale).astype(dtype)) for _ in range(2)]
    tails = [torch.rand(B, 3, fl - 1, 40, 136, device=dev) * 50 for _ in range(2)]
    before = ing.ingest.launches
    out = ing.ingest(*tails, *raws, m.display_photometry, filt)
    ref = ing.ingest_plain(*tails, *raws, m.display_photometry, filt)
    assert ing.ingest.launches == before + 1
    assert out[0].shape == (B, 8, 4, 40, 136)
    for a, b in zip(out, ref):
        assert _rel_planes(a, b) <= 1e-5


@pytest.mark.parametrize("C", [4, 3])
def test_band_masking_kernel(dev, C):
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(512, 96)
    consts, luts = m._band_tables(C)
    shapes = [(96, 512), (48, 256), (16, 64), (8, 32), (5, 16)]
    gis = [torch.rand(1, 2 * C, 3, h, w, device=dev) * 20 + 30 for h, w in shapes]
    Es = [g + torch.randn_like(g) for g in gis]
    for sel in ([0], [1], [2, 3, 4]):
        args = ([gis[i] for i in sel], [Es[i] for i in sel], luts[sel[0]:sel[-1] + 1],
                [2.0] * len(sel), consts)
        assert _rel(bm.band_masking(*args), bm.band_masking_plain(*args)) <= 1e-4


@pytest.mark.parametrize("C", [4, 3])
def test_band_masking_d_kernel(dev, C):
    """The D mode against its plain version at unaligned sizes: one wide band,
    a multi-band group and a band of 4 rows without the masking blur."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(517, 99)
    consts, _ = m._band_tables(C)
    shapes = [(99, 517), (50, 259), (25, 130), (13, 65), (7, 33), (4, 17)]
    luts = torch.as_tensor(np.stack([
        np.stack([m.csf.logS_of_logL(rho, m.omega[0 if cc < 3 else 1], cc if cc < 3 else 0)
                  for cc in range(C)]) for rho in (8.0, 4.0, 2.0, 1.0, 0.5, 0.25)]), device=dev)
    gis = [torch.rand(1, 2 * C, 3, h, w, device=dev) * 20 + 30 for h, w in shapes]
    Es = [g + torch.randn_like(g) for g in gis]
    for sel, fn in (([0], bm.band_masking_d), ([1, 2, 3, 4], bm.band_masking_d),
                    ([5], bm.band_masking_d_noblur)):
        args = ([gis[i] for i in sel], [Es[i] for i in sel], luts[sel[0]:sel[-1] + 1],
                [1.0 if i == 0 else 2.0 for i in sel], consts)
        before = fn.launches
        Ds = fn(*args)
        assert fn.launches == before + 1
        for D, P in zip(Ds, bm.band_masking_d_plain(*args)):
            assert D.shape == P.shape
            assert _rel_planes(D, P) <= 1e-5
    with pytest.raises(ValueError):
        bm.band_masking_d_noblur([gis[0]], [Es[0]], luts[:1], [1.0], consts)
    with pytest.raises(ValueError):
        bm.band_masking_d([gis[5]], [Es[5]], luts[5:6], [2.0], consts)


def test_csf_lut_kernel(dev):
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    x0, x1 = m.csf.lut_range()
    luts = torch.as_tensor(np.stack([m.csf.logS_of_logL(2.0, 0, c) for c in range(3)]
                                    + [m.csf.logS_of_logL(2.0, 5, 0)]), device=dev)
    logL = torch.linspace(x0 - 1, x1 + 1, 100003, device=dev).reshape(1, 1, -1, 1, 1)
    a = lut.csf_lut(logL, luts, x0, x1)
    b = lut.csf_lut_plain(logL, luts, x0, x1)
    assert torch.equal(a, b)


def test_csf_lut_bwd_kernel(dev):
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    x0, x1 = m.csf.lut_range()
    luts = torch.as_tensor(np.stack([m.csf.logS_of_logL(2.0, 0, c) for c in range(3)]),
                           device=dev)
    logL = torch.linspace(x0 - 1, x1 + 1, 100003, device=dev).reshape(1, -1, 1)
    g = torch.randn(3, *logL.shape, device=dev)
    before = lut.csf_lut_bwd.launches
    a = lut.csf_lut_bwd(logL, g, luts, x0, x1)
    b = lut.csf_lut_bwd_plain(logL, g, luts, x0, x1)
    assert lut.csf_lut_bwd.launches == before + 1
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(12, 270, 481), (3, 135, 241), (2, 17, 129),
                                   (1, 4, 2, 33, 40)])
def test_blur_kernel(dev, shape):
    taps = gaussian_kernel1d(13, 3.0)
    x = torch.rand(shape, device=dev)
    before = bl.blur.launches
    y = bl.blur(x, taps)
    assert bl.blur.launches == before + 1
    assert torch.equal(y, blur_plain(x, taps))
    with pytest.raises(ValueError):
        bl.blur(x[..., :6, :], taps)  # H <= radius: one reflection is not enough


def test_loss_kernels_match_plain(dev):
    rng = np.random.RandomState(4)
    ref = rng.rand(2, 3, 1, 96, 320).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    counters = [pyramid_reduce, bm.band_masking, lut.csf_lut, lut.csf_lut_bwd, bl.blur]
    out = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_4k", device="cuda")
        m.enable_fused_kernels = fused
        x = torch.from_numpy(test).to(dev).requires_grad_()
        before = [f.launches for f in counters]
        v = m.get_loss_fn(96, 320)(x, torch.from_numpy(ref).to(dev))
        (g,) = torch.autograd.grad(v, x)
        grew = [f.launches > b for f, b in zip(counters, before)]
        assert all(grew) if fused else not any(grew)
        out.append((float(v.detach()), g))
    assert abs(out[0][0] - out[1][0]) <= 1e-4
    assert _rel(out[0][1], out[1][1]) <= 1e-4


@pytest.mark.parametrize("case", ["uint8", "batch2-float32"])
def test_metric_kernels_match_plain(dev, case):
    rng = np.random.RandomState(3)
    ref = (rng.rand(270, 480, 3, 12) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 10).astype(np.int16),
                   0, 255).astype(np.uint8)
    dims = "HWCF"
    if case == "batch2-float32":
        test = np.stack([test, ref]).astype(np.float32) / 255
        ref = np.stack([ref, ref]).astype(np.float32) / 255
        dims = "BHWCF"
    jods = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda")
        m.enable_fused_kernels = fused
        before = ing.ingest.launches
        Q, _ = m.predict(test, ref, dim_order=dims, frames_per_second=30)
        assert (ing.ingest.launches > before) == fused
        jods.append(Q.double().cpu().numpy())
    assert np.abs(jods[0] - jods[1]).max() <= 1e-4, jods


@pytest.mark.parametrize("hm_type", ["raw", "supra-threshold", "threshold-image"])
def test_heatmap_kernels_match_plain(dev, hm_type):
    """predict with a heatmap, kernels against plain: 7 frames in blocks of 5
    and 2, or one image; at 96 rows band 4 has 6 rows and takes no blur."""
    rng = np.random.RandomState(5)
    ref = (rng.rand(96, 320, 3, 7) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 10).astype(np.int16),
                   0, 255).astype(np.uint8)
    kw = dict(dim_order="HWCF", frames_per_second=30)
    if hm_type == "threshold-image":
        hm_type, test, ref, kw = "threshold", test[..., 0], ref[..., 0], dict(dim_order="HWC")
    pix = 96 * 320
    gpu_mem = (1.6e9 + pix * 8 * 16 + pix * 336 * 5.5) / 1e9  # 5-frame blocks
    out = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_4k", device="cuda", heatmap=hm_type,
                     gpu_mem=gpu_mem)
        m.enable_fused_kernels = fused
        before = bm.band_masking_d.launches, bm.band_masking_d_noblur.launches
        Q, st = m.predict(test, ref, **kw)
        after = bm.band_masking_d.launches, bm.band_masking_d_noblur.launches
        assert all((a > b) == fused for a, b in zip(after, before))
        out.append((float(Q), st["heatmap"].astype(np.float32), st["block_N_frames"]))
    (q_k, hm_k, blk_k), (q_p, hm_p, blk_p) = out
    assert blk_k == blk_p == (1 if test.ndim == 3 else 5)
    assert hm_k.shape == hm_p.shape
    assert np.abs(hm_k - hm_p).max() <= 1.1e-3
    assert abs(q_k - q_p) <= 1e-4
