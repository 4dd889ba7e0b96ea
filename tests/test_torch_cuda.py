"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc; without a card they skip. They do
not import jax, so on a machine without it run them as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import colorvideovdp_tpu_torch as ct
from colorvideovdp_tpu_torch.ops import pyramid as pyr
from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d
from colorvideovdp_tpu_torch.ops.kernels import band_fused as bf
from colorvideovdp_tpu_torch.ops.kernels import blur as bl
from colorvideovdp_tpu_torch.ops.kernels import csf_lut as lut
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing
from colorvideovdp_tpu_torch.ops.kernels import interleave as il
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm
from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
from colorvideovdp_tpu_torch.ops.kernels.pyramid_reduce import pyramid_reduce
from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters
from colorvideovdp_tpu_torch.utils.config import write_parameters

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


@pytest.mark.parametrize("C", [4, 3])
def test_band_masking_contrast_kernel(dev, C):
    """The contrast-band mode (row 7) against its plain version at unaligned
    sizes, pooled and D: one wide band, a multi-band group and a band of 4
    rows without the masking blur."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(517, 99)
    consts, _ = m._band_tables(C)
    shapes = [(99, 517), (50, 259), (25, 130), (13, 65), (4, 17)]
    luts = torch.as_tensor(np.stack([
        np.stack([m.csf.logS_of_logL(rho, m.omega[0 if cc < 3 else 1], cc if cc < 3 else 0)
                  for cc in range(C)]) for rho in (8.0, 4.0, 2.0, 1.0, 0.25)]), device=dev)
    bands = [torch.randn(1, 2 * C, 3, h, w, device=dev) * 0.3 for h, w in shapes]
    logLs = [torch.rand(1, 1, 3, h, w, device=dev) * 4 - 1 for h, w in shapes]
    for sel in ([0], [1, 2, 3], [4]):
        args = ([bands[i] for i in sel], [logLs[i] for i in sel], luts[sel[0]:sel[-1] + 1],
                consts)
        before = bm.band_masking_contrast.launches, bm.band_masking_contrast_d.launches
        sums = bm.band_masking_contrast(*args)
        Ds = bm.band_masking_contrast_d(*args)
        assert (bm.band_masking_contrast.launches, bm.band_masking_contrast_d.launches) == (
            before[0] + 1, before[1] + 1)
        ones = [1.0] * len(sel)
        assert _rel(sums, bm.band_masking_plain(*args[:3], ones, consts, True)) <= 1e-4
        for D, P in zip(Ds, bm.band_masking_d_plain(*args[:3], ones, consts, True)):
            assert D.shape == P.shape
            assert _rel_planes(D, P) <= 1e-5
    with pytest.raises(ValueError):
        bm.band_masking_contrast_d([bands[3], bands[4]], [logLs[3], logLs[4]], luts[3:5], consts)


@pytest.mark.parametrize("display", ["standard_4k", "standard_hdr_pq"])
def test_ingest_kernel_log_lms(dev, display):
    """The log-LMS mode of the ingest kernel (the log contrast's colour space)."""
    m = ct.cvvdp(display_name=display, device="cuda")
    F, _ = get_temporal_filters(30, m.sigma_tf, m.beta_tf)
    filt = np.stack([f[::-1] for f in F])
    fl = filt.shape[1]
    rng = np.random.RandomState(2)
    raws = [m._upload((rng.rand(1, 5, 3, 67, 300) * 255).astype(np.uint8)) for _ in range(2)]
    tails = [torch.rand(1, 3, fl - 1, 67, 300, device=dev) * 3 for _ in range(2)]
    before = ing.ingest.launches
    out = ing.ingest(*tails, *raws, m.display_photometry, filt, "logLMS_DKLd65")
    ref = ing.ingest_plain(*tails, *raws, m.display_photometry, filt, "logLMS_DKLd65")
    assert ing.ingest.launches == before + 1
    for a, b in zip(out, ref):
        assert _rel_planes(a, b) <= 1e-5


def test_blur_kernel_33_taps(dev):
    """The texture models' blur (sigma 8, 33 taps), radius 16."""
    taps = gaussian_kernel1d(33, 8.0)
    for shape in ((4, 1080, 1920), (2, 17, 130)):
        x = torch.rand(shape, device=dev)
        assert torch.equal(bl.blur(x, taps), blur_plain(x, taps))
    with pytest.raises(ValueError):
        bl.blur(torch.rand(1, 16, 64, device=dev), taps)
    with pytest.raises(ValueError):
        bl.blur(torch.rand(1, 40, 64, device=dev), gaussian_kernel1d(35, 8.0))


@pytest.mark.parametrize("over", [dict(contrast="weber_g0_ref"), dict(contrast="log"),
                                  dict(masking_model="mult-transducer-texture"),
                                  dict(xchannel_masking="off")],
                         ids=["weber_g0_ref", "log", "texture", "xchannel-off"])
def test_configurations_kernels_match_plain(dev, tmp_path, over):
    """predict on a non-default configuration, kernels against plain: a video
    in blocks of 5 + 2 and an image. The contrasts take the contrast-band
    mode of the band kernel, the other two the generic chain (CSF LUT and
    blur kernels)."""
    cp = write_parameters(str(tmp_path), **over)
    rng = np.random.RandomState(6)
    ref = (rng.rand(96, 320, 3, 7) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 10).astype(np.int16),
                   0, 255).astype(np.uint8)
    pix = 96 * 320
    gpu_mem = (1.6e9 + pix * 8 * 16 + pix * 336 * 5.5) / 1e9  # 5-frame blocks
    contrast_mode = "contrast" in over
    counter = bm.band_masking_contrast if contrast_mode else lut.csf_lut
    out = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_4k", device="cuda", config_paths=cp, gpu_mem=gpu_mem)
        m.enable_fused_kernels = fused
        before = counter.launches, ing.ingest.launches, bl.blur.launches
        Qv, _ = m.predict(test, ref, dim_order="HWCF", frames_per_second=30)
        Qi, _ = m.predict(test[..., 0], ref[..., 0], dim_order="HWC")
        after = counter.launches, ing.ingest.launches, bl.blur.launches
        grew = [a > b for a, b in zip(after, before)]
        # The generic chain blurs with the blur kernel; the band kernel in-kernel.
        assert grew == ([True, True, not contrast_mode] if fused else [False] * 3)
        out.append((float(Qv), float(Qi)))
    assert np.abs(np.subtract(out[0], out[1])).max() <= 1e-4 * max(1.0, abs(10 - out[1][1]))


def test_weber_g0_ref_loss_kernels_match_plain(dev, tmp_path):
    cp = write_parameters(str(tmp_path), contrast="weber_g0_ref")
    rng = np.random.RandomState(4)
    ref = rng.rand(2, 3, 1, 96, 320).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    out = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_4k", device="cuda", config_paths=cp)
        m.enable_fused_kernels = fused
        x = torch.from_numpy(test).to(dev).requires_grad_()
        before = bm.band_masking_contrast.launches
        v = m.get_loss_fn(96, 320)(x, torch.from_numpy(ref).to(dev))
        (g,) = torch.autograd.grad(v, x)
        assert (bm.band_masking_contrast.launches > before) == fused
        out.append((float(v.detach()), g))
    assert abs(out[0][0] - out[1][0]) <= 1e-4
    assert _rel(out[0][1], out[1][1]) <= 1e-4


@pytest.mark.parametrize("mode", ["replicate", "head"])
@pytest.mark.parametrize("case", ["sdr-uint8", "pq-uint16-batch2", "hlg-luminance",
                                  "log-lms", "float16"])
def test_ingest_first_modes_kernel(dev, mode, case):
    """The first block's replicate and head modes against
    ``ingest_first_plain`` (1e-5 per plane) and against the kernel's other
    modes, which convert every frame the same way: replicate gives the bits
    of head mode fed frame 0 as every head, and a head block split in two
    (head mode, then tail mode on its tails) gives the bits of one launch."""
    display, dtype, B, C, cs = {
        "sdr-uint8": ("standard_4k", np.uint8, 1, 3, "DKLd65"),
        "pq-uint16-batch2": ("standard_hdr_pq", np.uint16, 2, 3, "DKLd65"),
        "hlg-luminance": ("standard_hdr_hlg", np.uint16, 1, 1, "DKLd65"),
        "log-lms": ("standard_4k", np.uint8, 1, 3, "logLMS_DKLd65"),
        "float16": ("standard_hdr_pq", np.float16, 1, 3, "DKLd65"),
    }[case]
    m = ct.cvvdp(display_name=display, device="cuda")
    dm = m.display_photometry
    F, _ = get_temporal_filters(30, m.sigma_tf, m.beta_tf)
    filt = np.stack([f[::-1] for f in F])
    fl = filt.shape[1]
    rng = np.random.RandomState(6)
    top = np.iinfo(dtype).max if dtype != np.float16 else 1.0

    def frames(n):
        return m._upload((rng.rand(B, n, C, 67, 300) * top).astype(dtype))

    raws, heads = [frames(5) for _ in range(2)], [frames(fl - 1) for _ in range(2)]
    if mode == "head":
        counter = ing.ingest_head
        before = counter.launches
        out = ing.ingest_head(*heads, *raws, dm, filt, cs)
        ref = ing.ingest_first_plain(*raws, dm, filt, cs, *heads)
        R1, *tails = ing.ingest_head(*heads, *[r[:, :2].contiguous() for r in raws], dm, filt, cs)
        R2, *tails2 = ing.ingest(*tails, *[r[:, 2:].contiguous() for r in raws], dm, filt, cs)
        same = (torch.cat([R1, R2], dim=2), *tails2)
    else:
        counter = ing.ingest_replicate
        before = counter.launches
        out = ing.ingest_replicate(*raws, dm, filt, cs)
        ref = ing.ingest_first_plain(*raws, dm, filt, cs)
        same = ing.ingest_head(*[r[:, :1].expand(-1, fl - 1, -1, -1, -1).contiguous()
                                 for r in raws], *raws, dm, filt, cs)
    assert counter.launches == before + (1 if mode == "replicate" else 2)
    for a, b, c in zip(out, ref, same):
        assert a.shape == b.shape
        assert _rel_planes(a, b) <= 1e-5
        assert torch.equal(a, c)


def _responsive_ml_weights(m, seed):
    """The metric's random weights with biases shifted and the MLPs' last
    layers made non-negative, so that both saliency MLPs respond."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in m.ml_weights().items():
        if k in ("feature_net.9.weight", "att_net.12.weight"):
            v = np.abs(v)
        elif k.endswith("bias"):
            v = v + rng.uniform(-0.3, 0.3, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("family,case", [("saliency", "replicate"),
                                         ("transformer", "symmetric"),
                                         ("transformer", "image")])
def test_ml_metrics_kernels_match_plain(dev, family, case):
    """predict with the ML metrics, kernels against plain: 7 frames in blocks
    of 3, 3 and 1(+2), or one image."""
    cls = {"saliency": ct.cvvdp_ml_saliency, "transformer": ct.cvvdp_ml_transformer}[family]
    rng = np.random.RandomState(8)
    ref = (rng.rand(96, 320, 3, 7) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 10).astype(np.int16),
                   0, 255).astype(np.uint8)
    kw = dict(dim_order="HWCF", frames_per_second=30)
    if case == "image":
        test, ref, kw = test[..., 0], ref[..., 0], dict(dim_order="HWC")
    pix = 96 * 320
    gpu_mem = (1.6e9 + pix * 8 * 16 + pix * 336 * 3.5) / 1e9  # 3-frame blocks
    first = ing.ingest_head if case == "symmetric" else ing.ingest_replicate
    counters = [pyramid_reduce, lut.csf_lut, bl.blur]
    if case != "image":
        counters += [first, ing.ingest]
    weights = None
    jods = []
    for fused in (True, False):
        m = cls(display_name="standard_4k", device="cuda", random_init=True, gpu_mem=gpu_mem,
                temp_padding="symmetric" if case == "symmetric" else "replicate")
        weights = weights or _responsive_ml_weights(m, 9)
        m.load_weights(weights)
        m.enable_fused_kernels = fused
        before = [f.launches for f in counters]
        Q, st = m.predict(test, ref, **kw)
        grew = [f.launches > b for f, b in zip(counters, before)]
        assert all(grew) if fused else not any(grew)
        assert st["block_N_frames"] == (1 if case == "image" else 3)
        jods.append(float(Q))
    assert abs(10.0 - jods[1]) > 1e-3
    assert abs(jods[0] - jods[1]) <= 1e-4 * max(1.0, abs(10.0 - jods[1])), jods


@pytest.mark.parametrize("C,ref_only", [(4, False), (3, False), (4, True)])
def test_band_fused_kernel(dev, C, ref_only):
    """The band kernel's fused mode against the raw-pair route fed the plain
    expand (bit for bit) and against its plain version, pooled and D, at
    aligned, odd and small band sizes (the 4-row band takes no blur)."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(512, 96)
    consts, luts = m._band_tables(C)
    consts = dataclasses.replace(consts, ref_only=ref_only)
    for i, (h, w) in enumerate([(96, 512), (99, 517), (48, 256), (13, 65), (4, 17)]):
        gi = torch.rand(2, 2 * C, 3, h, w, device=dev) * 20 + 30
        gn = pyramid_reduce(gi)
        E = pyr.gausspyr_expand(gn, (h, w))
        lut_b, mul = luts[min(i, 1)], 1.0 if i == 0 else 2.0
        before = (bf.band_fused.launches, bf.band_fused_d.launches)
        s = bf.band_fused(gi, gn, lut_b, mul, consts)
        D = bf.band_fused_d(gi, gn, lut_b, mul, consts)
        assert (bf.band_fused.launches, bf.band_fused_d.launches) == (before[0] + 1,
                                                                      before[1] + 1)
        route_d = bm.band_masking_d if consts.params.blurs(h, w) else bm.band_masking_d_noblur
        assert torch.equal(s, bm.band_masking([gi], [E], lut_b[None], [mul], consts)[0])
        assert torch.equal(D, route_d([gi], [E], lut_b[None], [mul], consts)[0])
        assert _rel(s, bf.band_fused_plain(gi, gn, lut_b, mul, consts)) <= 1e-4
        assert _rel_planes(D, bf.band_fused_d_plain(gi, gn, lut_b, mul, consts)) <= 1e-5
    with pytest.raises(ValueError):
        bf.band_fused(gi, E, lut_b, 2.0, consts)  # E in gn's slot: wrong shape


@pytest.mark.parametrize("heatmap", [None, "raw"])
def test_band_mega_route_kernels_match_plain(dev, heatmap):
    """predict with ``use_band_mega`` (``force_fused``: bands 0 and 1 of
    96x512 pass the gate), kernels against plain and against the default
    route; 7 frames in blocks of 5 and 2."""
    rng = np.random.RandomState(6)
    ref = (rng.rand(96, 512, 3, 7) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 10).astype(np.int16),
                   0, 255).astype(np.uint8)
    pix = 96 * 512
    gpu_mem = (1.6e9 + pix * 8 * 16 + pix * 336 * 5.5) / 1e9  # 5-frame blocks
    fn = bf.band_fused_d if heatmap else bf.band_fused
    out = {}
    for mega, fused in ((True, True), (True, False), (False, True)):
        m = ct.cvvdp(display_name="standard_4k", device="cuda", heatmap=heatmap,
                     gpu_mem=gpu_mem)
        m.use_band_mega, m.force_fused, m.enable_fused_kernels = mega, True, fused
        before = fn.launches
        Q, st = m.predict(test, ref, dim_order="HWCF", frames_per_second=30)
        assert st["block_N_frames"] == 5
        assert fn.launches - before == (4 if mega and fused else 0)  # 2 bands x 2 blocks
        out[(mega, fused)] = (float(Q), st.get("heatmap"))
    (jk, hk), (jp, hp), (jd, hd) = out[(True, True)], out[(True, False)], out[(False, True)]
    assert abs(jk - jp) <= 1e-4 and abs(jk - jd) <= 1e-5, (jk, jp, jd)
    if heatmap:
        assert np.abs(hk.astype(np.float32) - hp.astype(np.float32)).max() <= 1.1e-3
        assert np.array_equal(hk, hd)


def test_band_mega_loss_kernels_match_plain(dev):
    """get_loss_fn with ``use_band_mega`` at 64x512 (band 0 passes the gate
    with ``force_fused``): loss and gradient, kernels against plain and
    against the default route."""
    rng = np.random.RandomState(12)
    ref = rng.rand(2, 3, 1, 64, 512).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    out = {}
    for mega, fused in ((True, True), (True, False), (False, True)):
        m = ct.cvvdp(display_name="standard_4k", device="cuda")
        m.use_band_mega, m.force_fused, m.enable_fused_kernels = mega, True, fused
        x = torch.from_numpy(test).to(dev).requires_grad_()
        before = bf.band_fused.launches
        v = m.get_loss_fn(64, 512)(x, torch.from_numpy(ref).to(dev))
        (g,) = torch.autograd.grad(v, x)
        assert (bf.band_fused.launches > before) == (mega and fused)
        out[(mega, fused)] = (float(v.detach()), g)
    for key in ((True, False), (False, True)):
        assert abs(out[(True, True)][0] - out[key][0]) <= 1e-4
        assert _rel(out[(True, True)][1], out[key][1]) <= 1e-4


@pytest.mark.parametrize("shape", [(2, 128, 512), (3, 5, 14), (1, 7, 6), (4, 33, 258)])
def test_interleave_kernels(dev, shape):
    """Interleave, concat and de-interleave bit for bit against their plain
    versions, on float4 (W/2 a multiple of 4) and element paths."""
    P, H, W = shape
    ev, od = (torch.rand(P, H, W // 2, device=dev) for _ in range(2))
    x = torch.rand(P, H, W, device=dev)
    for fn, plain, args in ((il.interleave, il.interleave_plain, (ev, od)),
                            (il.concat, il.concat_plain, (ev, od)),
                            (il.deinterleave, il.deinterleave_plain, (x,))):
        before = fn.launches
        got, want = fn(*args), plain(*args)
        assert fn.launches == before + 1
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(il.deinterleave(il.interleave(ev, od))[1], od)


@pytest.mark.parametrize("shape,rows_odd", [((2, 64 + 16, 512), False), ((1, 96 + 16, 301), True),
                                            ((3, 2 + 16, 7), False), ((64, 270 + 16, 960), False)])
def test_reduce_slab_kernel(dev, shape, rows_odd):
    """The slab mode gives ``reduce_slab_plain``'s bits (it rounds as the
    plain version does, csrc/common.cuh)."""
    x = torch.rand(shape, device=dev)
    before = prd.pyramid_reduce_slab.launches
    y = prd.pyramid_reduce_slab(x, rows_odd)
    assert prd.pyramid_reduce_slab.launches == before + 1
    assert torch.equal(y, pyr.reduce_slab_plain(x, rows_odd))


@pytest.mark.parametrize("C", [4, 3])
def test_band_masking_halo_kernel(dev, C):
    """The halo mode against its plain version: a 3-band launch of slabs with
    odd and even owned rows and an unaligned width, and the halo mode fed a
    slab with zero-padded halos against the whole band's pooled mode on the
    interior."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(517, 99)
    consts, luts = m._band_tables(C)
    r = bm.HALO_ROWS
    h_valids, widths = [40, 17, 33], [517, 259, 130]
    gis = [torch.rand(1, 2 * C, 3, hv + 2 * r, w, device=dev) * 20 + 30
           for hv, w in zip(h_valids, widths)]
    Es = [g + torch.randn_like(g) for g in gis]
    args = (gis, Es, luts[0:3], [1.0, 2.0, 2.0], consts, h_valids)
    before = bm.band_masking_halo.launches
    got = bm.band_masking_halo(*args)
    assert bm.band_masking_halo.launches == before + 1
    assert _rel(got, bm.band_masking_halo_plain(*args)) <= 1e-4


def test_sharded_scoring_on_the_card(dev, tmp_path):
    """A 192x512 image and a 2-block 128x256 video on a (1, 2) mesh of two
    ranks on the card(s): the JODs of single-device scoring, and the slab
    reduce and halo band mode launched on every rank."""
    from colorvideovdp_tpu_torch.parallel import run_ranks
    from colorvideovdp_tpu_torch.parallel import sharding as sh

    rng = np.random.RandomState(5)
    cases = {"image": ([rng.randint(0, 255, (192, 512, 3), dtype=np.uint8) for _ in range(2)],
                       "HWC", 0),
             "video": ([rng.randint(0, 255, (128, 256, 3, 8), dtype=np.uint8)
                        for _ in range(2)], "HWCF", 30.0)}
    for name, (pair, dims, fps) in cases.items():
        paths = [str(tmp_path / f"{name}{i}.npy") for i in range(2)]
        for p, a in zip(paths, pair):
            np.save(p, a)
        spec = dict(test=paths[0], reference=paths[1], dim_order=dims, fps=fps,
                    display_name="standard_hdr_pq", gpu_mem=2.5)
        res = run_ranks(sh.score_rank, 2, (spec,), device="cuda", timeout_s=300)
        Q1, _ = ct.cvvdp(display_name="standard_hdr_pq", device="cuda").predict(
            *pair, dim_order=dims, frames_per_second=fps)
        for r in res:
            assert abs(float(r["jod"]) - float(Q1)) <= 2e-4, (name, float(r["jod"]), float(Q1))
            assert r["launches"]["pyramid_reduce_slab"] > 0
            assert r["launches"]["band_masking_halo"] > 0
