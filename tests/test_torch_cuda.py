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
from colorvideovdp_tpu_torch.ops.blur import blur_adjoint_plain, blur_plain, gaussian_kernel1d
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
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


def _ingest_launches():
    """The ingest kernel's launches in all its modes: a clip of one block
    takes only the first block's mode."""
    return ing.ingest.launches + ing.ingest_replicate.launches + ing.ingest_head.launches


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rel_planes(a, b):
    """The worst relative error over the (batch, channel) planes, so that a
    small channel is held to its own scale."""
    a, b = a.flatten(0, 1).flatten(1), b.flatten(0, 1).flatten(1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


@pytest.mark.parametrize("shape", [(2, 57, 256), (1, 66, 301), (3, 5, 7), (16, 270, 481),
                                   (1, 3, 3), (2, 3, 4, 6), (2, 3, 131, 262), (1, 260, 520),
                                   (3, 129, 516), (4, 130, 30), (2, 17, 15)])
def test_reduce_kernel(dev, shape):
    """Odd and even H and W, W % 4 != 0 (4-byte copies) and == 0 (16-byte),
    H = W = 3, lead dimensions, several row runs (Ho > 32) and strips
    (Wo > 256)."""
    x = torch.rand(shape, device=dev)
    before = prd.pyramid_reduce.launches
    y = pyramid_reduce(x)
    assert prd.pyramid_reduce.launches == before + 1
    ref = pyr.reduce_plain(x)
    assert y.shape == ref.shape
    # The kernel rounds as the plain version does (csrc/common.cuh).
    assert torch.equal(y, ref)


def test_reduce_kernel_4k_pyramid(dev):
    """Every level of a 4K pyramid (8 channels x 2 frames) bit for bit, each
    from the kernel's previous level."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(3840, 2160)
    shapes = [tuple(int(v) for v in s) for s in m.lpyr.pyr_shape]
    x = torch.rand((1, 8, 2) + shapes[0], device=dev)
    for nxt in shapes[1:]:
        y = pyramid_reduce(x)
        assert tuple(y.shape[-2:]) == nxt
        assert torch.equal(y, pyr.reduce_plain(x))
        x = y


def test_reduce_kernel_many_planes(dev):
    """More than 65535 planes (the grid is 1-D), in both modes."""
    x = torch.rand((70001, 5, 9), device=dev)
    assert torch.equal(pyramid_reduce(x), pyr.reduce_plain(x))
    xs = torch.rand((70001, 2 + 16, 6), device=dev)
    assert torch.equal(prd.pyramid_reduce_slab(xs, True), pyr.reduce_slab_plain(xs, True))


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


@pytest.mark.parametrize("C,ref_only", [(4, False), (3, False), (4, True)])
def test_band_pooled_kernel(dev, C, ref_only):
    """The one-pass pooled kernel against its plain version and against the
    plain chain fed the plain expand, within 1e-4: an odd 1081x1921 band of
    B = 2, and a stacked list of narrow bands (the 4-row band takes no
    blur)."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(1921, 1081)
    consts, luts = m._band_tables(C)
    consts = dataclasses.replace(consts, ref_only=ref_only)
    for B, shapes in ((2, [(1081, 1921)]), (1, [(135, 240), (68, 120), (34, 60), (17, 30),
                                                 (9, 15), (4, 17)])):
        gis = [torch.rand(B, 2 * C, 3, h, w, device=dev) * 20 + 30 for h, w in shapes]
        gns = [pyramid_reduce(g) for g in gis]
        Es = [pyr.gausspyr_expand(gn, g.shape[-2:]) for g, gn in zip(gis, gns)]
        lt = luts[:len(shapes)].contiguous()
        muls = [1.0] + [2.0] * (len(shapes) - 1)
        before = bp.band_pooled.launches
        s = bp.band_pooled(gis, gns, lt, muls, consts)
        assert bp.band_pooled.launches == before + 1
        assert _rel(s, bp.band_pooled_plain(gis, gns, lt, muls, consts)) <= 1e-4
        assert _rel(s, bm.band_masking_plain(gis, Es, lt, muls, consts)) <= 1e-4
    with pytest.raises(ValueError):
        bp.band_pooled([gis[0]], [Es[0]], lt[:1], [2.0], consts)  # E in gn's slot


def _ieee_float(raw, top):
    """raw / top as a correctly rounded float32 (PyTorch's CUDA division by a
    scalar multiplies by its reciprocal)."""
    return torch.from_numpy((raw.cpu().numpy().astype(np.float64) / top).astype(np.float32)
                            ).to(raw.device)


@pytest.mark.parametrize("display", ["standard_4k", "standard_hdr_pq", "standard_hdr_hlg"])
@pytest.mark.parametrize("mode", ["tail", "replicate", "head"])
def test_ingest_table_route_matches_float_path(dev, display, mode):
    """uint8, uint16 and float16 frames go through the kernel's code-value
    table; the same samples as float32 (v / 255 and v / 65535 correctly
    rounded, float16 widened) take the per-sample path: the two give the
    same bits, at fl = 9 (the register window) and fl = 15 (the shared-memory
    ring), and the table route is within 1e-5 (1e-4 on PQ) of the plain
    version."""
    dm = ct.vvdp_display_photometry.load(display)
    m = ct.cvvdp(display_name=display, device="cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for fps in (30.0, 50.0):
        F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
        filt = np.stack([f[::-1] for f in F_taps])
        fl = filt.shape[1]
        shape = (2, 4, 3, 36, 64)
        u8 = [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
              for _ in range(2)]
        u16 = [torch.randint(-32768, 32768, shape, dtype=torch.int16, device=dev, generator=gen)
               for _ in range(2)]
        f16 = [torch.rand(shape, device=dev, generator=gen).half() for _ in range(2)]
        tails = [torch.rand((2, 3, fl - 1, 36, 64), device=dev, generator=gen) * 50
                 for _ in range(2)]
        for raws, flts in ((u8, [_ieee_float(r, 255) for r in u8]),
                           (u16, [_ieee_float(r.to(torch.int32) & 0xFFFF, 65535) for r in u16]),
                           (f16, [r.float() for r in f16])):
            def run(x):
                if mode == "tail":
                    return ing.ingest(*tails, *x, dm, filt)
                if mode == "replicate":
                    return ing.ingest_replicate(*x, dm, filt)
                heads = [r[:, 1:2].expand(-1, fl - 1, -1, -1, -1).contiguous() for r in x]
                return ing.ingest_head(*heads, *x, dm, filt)

            out_t, out_f = run(raws), run(flts)
            for a, b in zip(out_t, out_f):
                assert torch.equal(a, b)
            if mode == "tail":
                plain = ing.ingest_plain(*tails, *raws, dm, filt)
            elif mode == "replicate":
                plain = ing.ingest_first_plain(*raws, dm, filt)
            else:
                heads = [r[:, 1:2].expand(-1, fl - 1, -1, -1, -1).contiguous() for r in raws]
                plain = ing.ingest_first_plain(*raws, dm, filt, "DKLd65", *heads)
            tol = 1e-4 if display == "standard_hdr_pq" else 1e-5
            for a, b in zip(out_t, plain):
                assert _rel_planes(a, b) <= tol


def _channel_last(x):
    """(B, F, C, H, W) ``x``'s values laid out as a dense (B, F, H, W, C)
    array."""
    return x.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.float16, torch.float32])
@pytest.mark.parametrize("C", [1, 3])
def test_ingest_reads_channel_last_raws_as_planar(dev, dtype, C):
    """Tail, replicate and head modes on channel-last raws (and heads) give
    the planar launch's bits, for uint8, uint16 bits, float16 and float32 at
    fl = 9 (the register window) and fl = 15 (the shared-memory ring); heads
    laid out unlike the raws are made planar first, to the same bits."""
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda")
    dm = m.display_photometry
    gen = torch.Generator(device=dev).manual_seed(9)
    shape = (2, 4, C, 36, 64)

    def raw():
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, dtype=dtype, device=dev, generator=gen)
        if dtype == torch.int16:
            return torch.randint(-32768, 32768, shape, dtype=dtype, device=dev, generator=gen)
        return torch.rand(shape, device=dev, generator=gen).to(dtype)

    for fps in (30.0, 50.0):
        F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
        filt = np.stack([f[::-1] for f in F_taps])
        fl = filt.shape[1]
        assert fl == (9 if fps == 30.0 else 15)
        raws = [raw(), raw()]
        heads = [r[:, 1:2].expand(-1, fl - 1, -1, -1, -1).contiguous() for r in raws]
        tails = [torch.rand((2, 3, fl - 1, 36, 64), device=dev, generator=gen) * 50
                 for _ in range(2)]
        cl_raws = [_channel_last(r) for r in raws]
        cl_heads = [_channel_last(h) for h in heads]
        assert C == 1 or not any(r.is_contiguous() for r in cl_raws + cl_heads)
        runs = [(ing.ingest(*tails, *raws, dm, filt), ing.ingest(*tails, *cl_raws, dm, filt)),
                (ing.ingest_replicate(*raws, dm, filt), ing.ingest_replicate(*cl_raws, dm, filt)),
                (ing.ingest_head(*heads, *raws, dm, filt),
                 ing.ingest_head(*cl_heads, *cl_raws, dm, filt)),
                (ing.ingest_head(*heads, *raws, dm, filt),
                 ing.ingest_head(*heads, *cl_raws, dm, filt))]
        for planar, channel_last in runs:
            for a, b in zip(planar, channel_last):
                assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["4k-fhwc", "fhd-hwc"])
def test_predict_channel_last_equals_planar(dev, case):
    """A 4K FHWC uint16 clip in two blocks (the second padded) and an FHD HWC
    uint8 image score as their FCHW / CHW arrays, bit for bit, with no host
    relayout for either layout."""
    from torch.profiler import ProfilerActivity, profile

    from colorvideovdp_tpu_torch.utils import spans

    display, H, W, F, dtype = {"4k-fhwc": ("standard_hdr_pq", 2160, 3840, 12, torch.int16),
                               "fhd-hwc": ("standard_fhd", 1080, 1920, 1, torch.uint8)}[case]
    gen = torch.Generator(device=dev).manual_seed(11)
    lo, hi = (-32768, 32768) if dtype == torch.int16 else (0, 256)
    ref = torch.randint(lo, hi, (F, 3, H, W), dtype=dtype, device=dev, generator=gen)
    noise = torch.randint(-1500, 1500, ref.shape, device=dev, generator=gen)
    test = (ref.to(torch.int32) + noise).clamp(lo, hi - 1).to(dtype)
    np_dtype = np.uint16 if dtype == torch.int16 else np.uint8
    planar = [x.cpu().numpy().view(np_dtype) for x in (test, ref)]
    hwc = [np.ascontiguousarray(x.transpose(0, 2, 3, 1)) for x in planar]
    m = ct.cvvdp(display_name=display, device="cuda")
    if F > 1:
        m.gpu_mem = m.block_gpu_mem(H * W, 8, 30)
        orders, args = ("FCHW", "FHWC"), (planar, hwc)
    else:
        orders, args = ("CHW", "HWC"), ([x[0] for x in planar], [x[0] for x in hwc])
    out = []
    for order, (t, r) in zip(orders, args):
        spans.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            q, stats = m.predict(t, r, dim_order=order, frames_per_second=30)
        assert not [s for s in spans.recorded() if s.name == "cvvdp.relayout"]
        ups = [s.attrs["channel_last"] for s in spans.recorded() if s.name == "cvvdp.upload"]
        assert ups and set(ups) == {int(order.endswith("HWC"))}
        out.append((torch.as_tensor(q).cpu().numpy(), stats["Q_per_ch"]))
        assert stats["block_N_frames"] == (8 if F > 1 else 1)
    spans.clear()
    assert np.array_equal(out[0][0], out[1][0]) and np.array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("C,ref_only", [(4, False), (3, False), (4, True)])
def test_band_pooled_d_kernel(dev, C, ref_only):
    """The one-pass kernel's D mode, with sums bit for bit those of the
    pooled mode, against its plain version and against the plain chain fed
    the plain expand: an aligned 96x512 band, an odd 1081x1921 band of
    B = 2, and one launch over narrow bands whose 4-row band takes no
    blur."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(1921, 1081)
    consts, luts = m._band_tables(C)
    consts = dataclasses.replace(consts, ref_only=ref_only)
    for B, shapes in ((1, [(96, 512)]), (2, [(1081, 1921)]),
                      (1, [(135, 240), (68, 120), (34, 60), (17, 30), (9, 15), (4, 17)])):
        gis = [torch.rand(B, 2 * C, 3, h, w, device=dev) * 20 + 30 for h, w in shapes]
        gns = [pyramid_reduce(g) for g in gis]
        lt = luts[:len(shapes)].contiguous()
        muls = [1.0] + [2.0] * (len(shapes) - 1)
        before = bp.band_pooled_d.launches
        Ds, s = bp.band_pooled_d(gis, gns, lt, muls, consts)
        assert bp.band_pooled_d.launches == before + 1
        assert torch.equal(s, bp.band_pooled(gis, gns, lt, muls, consts))
        D_p, s_p = bp.band_pooled_d_plain(gis, gns, lt, muls, consts)
        assert _rel(s, s_p) <= 1e-4
        for i, (g, gn) in enumerate(zip(gis, gns)):
            E = pyr.gausspyr_expand(gn, g.shape[-2:])
            D_e = bm.band_masking_d_plain([g], [E], lt[i:i + 1], [muls[i]], consts)[0]
            assert _rel_planes(Ds[i], D_e) <= 1e-5
            assert _rel_planes(Ds[i], D_p[i]) <= 1e-5
    with pytest.raises(ValueError):
        bp.band_pooled_d([gis[0]], [gis[0]], lt[:1], [1.0], consts)  # gi in gn's slot


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


@pytest.mark.parametrize("n", [4096, 4097, 2 * 1080 * 1920 + 3])
@pytest.mark.parametrize("C", [3, 4])
def test_csf_lut_kernels_odd_length_and_offset_view(dev, n, C):
    """Forward and backward bit for bit at n % 4 == 0 and != 0 and on views
    one element into their storage (a pointer off 16-byte alignment): logL
    and g both, and g alone (the vector body with scalar loads of g)."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    x0, x1 = m.csf.lut_range()
    luts = torch.as_tensor(np.stack([m.csf.logS_of_logL(2.0, 0, c) for c in range(3)]
                                    + [m.csf.logS_of_logL(2.0, 5, 0)])[:C], device=dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    base = torch.empty(n + 1, device=dev).uniform_(x0 - 0.5, x1 + 0.5, generator=gen)
    g_base = torch.randn(C * (n + 1), device=dev, generator=gen)
    for logL, g in ((base[:n], g_base[:C * n].view(C, n)),
                    (base[1:], g_base[1:C * n + 1].view(C, n)),
                    (base[:n], g_base[1:C * n + 1].view(C, n))):
        assert logL.is_contiguous() and g.is_contiguous()
        assert torch.equal(lut.csf_lut(logL, luts, x0, x1), lut.csf_lut_plain(logL, luts, x0, x1))
        assert torch.equal(lut.csf_lut_bwd(logL, g, luts, x0, x1),
                           lut.csf_lut_bwd_plain(logL, g, luts, x0, x1))


@pytest.mark.parametrize("shape", [(12, 270, 481), (3, 135, 241), (2, 17, 129),
                                   (1, 4, 2, 33, 40), (2, 70, 520), (1, 7, 30), (3, 131, 258),
                                   (1, 1080, 1920)])
def test_blur_kernel(dev, shape):
    """Several strips (16-byte copies inside, 4-byte at the reflected edges)
    and runs, W % 4 != 0 (4-byte copies), H = r + 1, lead dimensions, and a
    non-contiguous input (a transposed view)."""
    taps = gaussian_kernel1d(13, 3.0)
    x = torch.rand(shape, device=dev)
    before = bl.blur.launches
    y = bl.blur(x, taps)
    assert bl.blur.launches == before + 1
    assert torch.equal(y, blur_plain(x, taps))
    xt = torch.rand(shape[:-2] + shape[-2:][::-1], device=dev).transpose(-1, -2)
    assert not xt.is_contiguous()
    assert torch.equal(bl.blur(xt, taps), blur_plain(xt, taps))
    with pytest.raises(ValueError):
        bl.blur(x[..., :6, :], taps)  # H <= radius: one reflection is not enough


@pytest.mark.parametrize("n", list(range(1, 34, 2)))
def test_blur_kernel_every_tap_count(dev, n):
    """Every odd tap count up to 33 (the radius is a template argument), on
    planes of several strips and runs, W % 4 != 0, and H = W = r + 1."""
    taps = gaussian_kernel1d(n, max(1.0, (n - 1) / 4))
    r = (n - 1) // 2
    for shape in ((2, 150, 600), (1, 67, 301), (1, r + 1, r + 1)):
        x = torch.rand(shape, device=dev)
        assert torch.equal(bl.blur(x, taps), blur_plain(x, taps)), shape


@pytest.mark.parametrize("n", [13, 33, 3, 1])
@pytest.mark.parametrize("shape", [(12, 270, 481), (2, 17, 129), (1, 70, 520), (1, 1080, 1920)])
def test_blur_adjoint_kernel(dev, n, shape):
    """The adjoint mode within 1e-5 of max|x_bar| of autograd of blur_plain
    and bit for bit ``blur_adjoint_plain`` (the same steps and order), with
    its launch counted; ``Blur``'s backward on the card launches it."""
    taps = gaussian_kernel1d(n, max(1.0, (n - 1) / 4))
    r = (n - 1) // 2
    for shp in (shape, (1, r + 1, r + 1)):
        g = torch.randn(shp, device=dev)
        x0 = torch.zeros(shp, device=dev, requires_grad=True)
        (ref,) = torch.autograd.grad(blur_plain(x0, taps), x0, g)
        before = bl.blur_adjoint.launches
        a = bl.blur_adjoint(g, taps)
        assert bl.blur_adjoint.launches == before + 1
        assert _rel(a, ref) <= 1e-5, shp
        assert torch.equal(a, blur_adjoint_plain(g, taps)), shp
    x = torch.rand(shape, device=dev, requires_grad=True)
    g = torch.randn(shape, device=dev)
    before = bl.blur_adjoint.launches
    (dx,) = torch.autograd.grad(bl.Blur.apply(x, taps), x, g)
    assert bl.blur_adjoint.launches == before + 1
    assert torch.equal(dx, blur_adjoint_plain(g, taps))


def test_loss_kernels_match_plain(dev):
    rng = np.random.RandomState(4)
    ref = rng.rand(2, 3, 1, 96, 320).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    counters = [pyramid_reduce, bp.band_pooled, lut.csf_lut, lut.csf_lut_bwd, bl.blur,
                bl.blur_adjoint]
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
        before = _ingest_launches()
        Q, _ = m.predict(test, ref, dim_order=dims, frames_per_second=30)
        assert (_ingest_launches() > before) == fused
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
    out = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_4k", device="cuda", heatmap=hm_type)
        m.enable_fused_kernels = fused
        m.gpu_mem = m.block_gpu_mem(pix, 5, 30)  # 5-frame blocks on this route
        before = bp.band_pooled_d.launches
        Q, st = m.predict(test, ref, **kw)
        assert (bp.band_pooled_d.launches > before) == fused
        out.append((float(Q), st["heatmap"].astype(np.float32), st["block_N_frames"]))
    (q_k, hm_k, blk_k), (q_p, hm_p, blk_p) = out
    assert blk_k == blk_p == (1 if test.ndim == 3 else 5)
    assert hm_k.shape == hm_p.shape
    assert np.abs(hm_k - hm_p).max() <= 1.1e-3
    assert abs(q_k - q_p) <= 1e-4
    # The Q columns come from the D mode's pooled sums: the pooled-only JOD.
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m.gpu_mem = m.block_gpu_mem(pix, 5, 30)
    q_0, _ = m.predict(test, ref, **kw)
    assert float(q_0) == q_k


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
    in blocks of 5 + 2 and an image. The contrasts take the one-pass band
    kernel in their coding, the other two the generic chain (CSF LUT and
    blur kernels)."""
    cp = write_parameters(str(tmp_path), **over)
    rng = np.random.RandomState(6)
    ref = (rng.rand(96, 320, 3, 7) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 10).astype(np.int16),
                   0, 255).astype(np.uint8)
    pix = 96 * 320
    contrast_mode = "contrast" in over
    counter = bp.band_pooled if contrast_mode else lut.csf_lut
    out = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_4k", device="cuda", config_paths=cp)
        m.enable_fused_kernels = fused
        m.gpu_mem = m.block_gpu_mem(pix, 5, 30)  # 5-frame blocks on this route
        before = (counter.launches, ing.ingest.launches, bl.blur.launches)
        Qv, _ = m.predict(test, ref, dim_order="HWCF", frames_per_second=30)
        Qi, _ = m.predict(test[..., 0], ref[..., 0], dim_order="HWC")
        after = (counter.launches, ing.ingest.launches, bl.blur.launches)
        grew = [a > b for a, b in zip(after, before)]
        # The generic chain blurs with the blur kernel; the band kernel in-kernel,
        # from gi and gn for every coding.
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
        before = bp.band_pooled.launches
        v = m.get_loss_fn(96, 320)(x, torch.from_numpy(ref).to(dev))
        (g,) = torch.autograd.grad(v, x)
        assert (bp.band_pooled.launches > before) == fused
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
    first = ing.ingest_head if case == "symmetric" else ing.ingest_replicate
    counters = [pyramid_reduce, lut.csf_lut, bl.blur]
    if case != "image":
        counters += [first, ing.ingest]
    weights = None
    jods = []
    for fused in (True, False):
        m = cls(display_name="standard_4k", device="cuda", random_init=True,
                temp_padding="symmetric" if case == "symmetric" else "replicate")
        m.gpu_mem = m.block_gpu_mem(pix, 3, 30)  # 3-frame blocks under the ML model
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
                                            ((3, 2 + 16, 7), False), ((64, 270 + 16, 960), False),
                                            ((2, 64 + 16, 512), True), ((1, 96 + 16, 301), False),
                                            ((3, 2 + 16, 7), True), ((8, 540 + 16, 1920), True),
                                            ((4, 136 + 16, 30), True)])
def test_reduce_slab_kernel(dev, shape, rows_odd):
    """The slab mode gives ``reduce_slab_plain``'s bits (it rounds as the
    plain version does, csrc/common.cuh)."""
    x = torch.rand(shape, device=dev)
    before = prd.pyramid_reduce_slab.launches
    y = prd.pyramid_reduce_slab(x, rows_odd)
    assert prd.pyramid_reduce_slab.launches == before + 1
    assert torch.equal(y, pyr.reduce_slab_plain(x, rows_odd))


def _contrast_levels(C, B, shapes, coding, dev):
    """Seeded levels gi of the given shapes (log-like values for the log
    coding, luminance-like otherwise) and their reduces gn."""
    g = torch.Generator(device=dev).manual_seed(3)
    gis = [torch.rand(B, 2 * C, 3, h, w, device=dev, generator=g) for h, w in shapes]
    gis = [x * 2 - 1 if coding == "log" else x * 20 + 0.005 for x in gis]
    return gis, [pyramid_reduce(x) for x in gis]


def _contrast_bands(gis, gns, muls, coding):
    """The contrast bands and fields as the JAX package's decomposition
    writes them: plain ``interior_contrast`` x the band gain."""
    out = [pyr.interior_contrast(g, pyr.gausspyr_expand(n, g.shape[-2:]), coding)
           for g, n in zip(gis, gns)]
    return [b * m for (b, _), m in zip(out, muls)], [L for _, L in out]


@pytest.mark.parametrize("coding", ["weber_g0_ref", "log"])
@pytest.mark.parametrize("C", [4, 3])
def test_band_pooled_contrast_codings_kernel(dev, C, coding):
    """The contrast-band codings of the one-pass kernel, pooled and D,
    against their plain versions and against the plain chain on the plain
    contrast bands and fields: an odd 1081x1921 band of B = 2, an aligned
    96x512 band, and one launch over narrow bands whose 4-row band takes no
    blur."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(1921, 1081)
    consts, luts = m._band_tables(C)
    k = dataclasses.replace(consts, coding=coding, ref_only=coding.endswith("ref"))
    for B, shapes in ((2, [(1081, 1921)]), (1, [(96, 512)]),
                      (1, [(135, 240), (68, 120), (34, 60), (17, 30), (9, 15), (4, 17)])):
        gis, gns = _contrast_levels(C, B, shapes, coding, dev)
        lt = luts[:len(shapes)].contiguous()
        muls = [1.0] + [2.0] * (len(shapes) - 1)
        before = bp.band_pooled.launches, bp.band_pooled_d.launches
        s = bp.band_pooled(gis, gns, lt, muls, k)
        Ds, s_d = bp.band_pooled_d(gis, gns, lt, muls, k)
        assert (bp.band_pooled.launches, bp.band_pooled_d.launches) == (before[0] + 1,
                                                                      before[1] + 1)
        assert torch.equal(s_d, s)
        assert _rel(s, bp.band_pooled_plain(gis, gns, lt, muls, k)) <= 1e-4
        bands, logLs = _contrast_bands(gis, gns, muls, coding)
        ones = [1.0] * len(shapes)
        assert _rel(s, bm.band_masking_plain(bands, logLs, lt, ones, k, True)) <= 1e-4
        D_p, _ = bp.band_pooled_d_plain(gis, gns, lt, muls, k)
        for i, D in enumerate(Ds):
            assert _rel_planes(D, D_p[i]) <= 1e-5
            D_r = bm.band_masking_d_plain([bands[i]], [logLs[i]], lt[i:i + 1], [1.0], k,
                                          True)[0]
            assert _rel_planes(D, D_r) <= 1e-5


def _halo_slab(x, s, n, edge_rows):
    """Rank s's slab of x (rows axis -2, n ranks) with ``edge_rows`` rows of
    each neighbour, and past a global edge the exclude-edge reflection."""
    h_loc = x.shape[-2] // n
    lo, hi, r = s * h_loc, (s + 1) * h_loc, edge_rows
    above = x[..., lo - r:lo, :] if s > 0 else x[..., 1:r + 1, :].flip(-2)
    below = x[..., hi:hi + r, :] if s < n - 1 else x[..., -r - 1:-1, :].flip(-2)
    return torch.cat([above, x[..., lo:hi, :], below], dim=-2).contiguous()


def _gn_rows(gn, s, n, sharded):
    """(rows, row0) of gn as ``parallel/sharding.py`` ``halo_gn`` hands them
    over: a sharded gn's slab with GN_HALO_ROWS rows of each neighbour (zeros
    past a global edge), or a replicated gn whole."""
    if not sharded:
        return gn, 0
    r, hn_loc = bp.GN_HALO_ROWS, gn.shape[-2] // n
    z = torch.zeros_like(gn[..., :r, :])
    above = gn[..., s * hn_loc - r:s * hn_loc, :] if s > 0 else z
    below = gn[..., (s + 1) * hn_loc:(s + 1) * hn_loc + r, :] if s < n - 1 else z
    return torch.cat([above, gn[..., s * hn_loc:(s + 1) * hn_loc, :], below], -2), s * hn_loc - r


@pytest.mark.parametrize("C", [4, 3])
def test_band_pooled_halo_kernel(dev, C):
    """The one-pass kernel's halo mode against its plain version and against
    the plain halo chain fed the slab of the plain expand: a 2-band launch (a
    sharded gn, and a replicated one with an unaligned width) on the first, a
    middle and the last of 4 slabs; the slabs' sums add up to the whole
    bands' pooled sums."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(517, 256)
    consts, luts = m._band_tables(C)
    n, r = 4, bm.HALO_ROWS
    shapes, sharded = [(256, 512), (128, 259)], [True, False]
    g = torch.Generator(device=dev).manual_seed(5)
    gis = [torch.rand(1, 2 * C, 3, h, w, device=dev, generator=g) * 20 + 30 for h, w in shapes]
    gns = [pyramid_reduce(x) for x in gis]
    lt, muls = luts[0:2].contiguous(), [1.0, 2.0]
    total = 0
    for s in range(n):
        xs = [_halo_slab(x, s, n, r) for x in gis]
        ys, row0s = zip(*[_gn_rows(gn, s, n, sh) for gn, sh in zip(gns, sharded)])
        slabs = [(s * (h // n), h, row0) for (h, _), row0 in zip(shapes, row0s)]
        before = bp.band_pooled_halo.launches
        got = bp.band_pooled_halo(xs, list(ys), lt, muls, consts, slabs)
        assert bp.band_pooled_halo.launches == before + 1
        assert _rel(got, bp.band_pooled_halo_plain(xs, list(ys), lt, muls, consts, slabs)) <= 1e-4
        Es = [_halo_slab(pyr.gausspyr_expand(gn, x.shape[-2:]), s, n, r)
              for x, gn in zip(gis, gns)]
        assert _rel(got, bm.band_masking_halo_plain(xs, Es, lt, muls, consts,
                                                    [h // n for h, _ in shapes])) <= 1e-4
        total = total + got
    assert _rel(total, bp.band_pooled(gis, gns, lt, muls, consts)) <= 1e-5
    with pytest.raises(ValueError):  # gn rows that do not cover the slab's expand
        bp.band_pooled_halo([xs[0]], [ys[0][..., :-6, :]], lt[:1], [1.0], consts, [slabs[0]])


@pytest.mark.parametrize("coding", bm.CODINGS)
def test_band_pooled_halo_codings_and_d_kernel(dev, tmp_path, coding):
    """The halo mode in every contrast coding, pooled (``band_pooled_halo``)
    and with D (``band_pooled_d_halo``), on the first, a middle and the last
    of 4 slabs of a 2-band launch (a sharded gn, and a replicated one with
    an unaligned width): sums within 1e-4 of the plain version, D within
    1e-5 per plane, the D mode's sums those of the pooled mode, and the
    owned rows' D and sums bit for bit the whole bands' (``band_pooled_d``
    on the card)."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda",
                 config_paths=write_parameters(str(tmp_path), contrast=coding))
    m._ensure_pyramids(517, 256)
    consts, luts = m._band_tables(4)
    assert consts.coding == coding
    n, r = 4, bm.HALO_ROWS
    shapes, sharded = [(256, 512), (128, 259)], [True, False]
    g = torch.Generator(device=dev).manual_seed(7)
    lo, span = (-1.0, 2.0) if coding == "log" else (30.0, 20.0)
    gis = [torch.rand(1, 8, 3, h, w, device=dev, generator=g) * span + lo for h, w in shapes]
    gns = [pyramid_reduce(x) for x in gis]
    lt, muls = luts[0:2].contiguous(), [1.0, 2.0]
    D_whole, s_whole = bp.band_pooled_d(gis, gns, lt, muls, consts)
    for s in (0, 1, n - 1):
        xs = [_halo_slab(x, s, n, r) for x in gis]
        ys, row0s = zip(*[_gn_rows(gn, s, n, sh) for gn, sh in zip(gns, sharded)])
        slabs = [(s * (h // n), h, row0) for (h, _), row0 in zip(shapes, row0s)]
        args = (xs, list(ys), lt, muls, consts, slabs)
        before = bp.band_pooled_halo.launches, bp.band_pooled_d_halo.launches
        got = bp.band_pooled_halo(*args)
        Ds, s_d = bp.band_pooled_d_halo(*args)
        assert (bp.band_pooled_halo.launches, bp.band_pooled_d_halo.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(s_d, got)
        assert _rel(got, bp.band_pooled_halo_plain(*args)) <= 1e-4
        D_p, _ = bp.band_pooled_d_halo_plain(*args)
        for i, (h, _) in enumerate(shapes):
            h_loc = h // n
            assert Ds[i].shape == D_p[i].shape and _rel_planes(Ds[i], D_p[i]) <= 1e-5
            own = D_whole[i][..., s * h_loc:(s + 1) * h_loc, :]
            assert torch.equal(Ds[i], own)


def test_band_pooled_halo_backward_kernels(dev):
    """``BandPooledHalo``'s backward on the card recomputes the halo chain
    with the blur kernel over the whole slab (``halo_D_plain`` with
    ``use_kernel``: the owned rows bit for bit the plain tap loop's) and
    differentiates it through ``blur_adjoint`` and ``csf_lut_bwd``; its
    gradients within 1e-5 of max|g| of the plain chain's autograd."""
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(517, 256)
    consts, luts = m._band_tables(3)
    n, r, s = 4, bm.HALO_ROWS, 1
    g = torch.Generator(device=dev).manual_seed(9)
    gi = torch.rand(1, 6, 2, 256, 512, device=dev, generator=g) * 20 + 30
    gn = pyramid_reduce(gi)
    x = _halo_slab(gi, s, n, r)
    y, row0 = _gn_rows(gn, s, n, True)
    slab, lt = (s * 64, 256, row0), luts[0:1].contiguous()
    E = bp.halo_expand_plain(x, y, slab)
    m_h, d_h = bp._stage_a(x, E, lt[0], 1.0, consts)
    assert torch.equal(bm.halo_D_plain(m_h, d_h, consts, 64, use_kernel=True),
                       bm.halo_D_plain(m_h, d_h, consts, 64))
    w = torch.rand(1, 1, 3, 2, device=dev, generator=g)
    grads = []
    for use_k in (True, False):
        xs, ys = x.clone().requires_grad_(), y.clone().requires_grad_()
        before = bl.blur_adjoint.launches, lut.csf_lut_bwd.launches
        sums = bp.band_pooled_halo_sums([xs], [ys], lt, [1.0], consts, [slab], use_kernel=use_k)
        torch.sum(torch.sqrt(sums) * w).backward()
        grew = bl.blur_adjoint.launches > before[0], lut.csf_lut_bwd.launches > before[1]
        assert grew == (use_k, use_k)
        grads.append((xs.grad, ys.grad))
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("world,batch", [(2, 1), (4, 2)])
def test_sharded_heatmap_and_loss_on_the_card(dev, tmp_path, world, batch):
    """On ``world`` ranks on the card(s) (NCCL with a card each, else gloo
    sharing them): a raw heatmap of a 192x512 image on a (1, world) mesh
    (``band_pooled_d_halo`` on every rank, the heatmap within 1.1e-3 of
    single-device scoring's) and a B = 2 ``shard_loss_fn`` step on a
    (batch, world / batch) mesh (loss within 1e-4, the gathered gradient
    within 1e-3 of max|g| of the single-device ``get_loss_fn`` on the
    card)."""
    from colorvideovdp_tpu_torch.parallel import run_ranks
    from colorvideovdp_tpu_torch.parallel import sharding as sh

    rng = np.random.RandomState(6)
    img = [rng.randint(0, 255, (192, 512, 3), dtype=np.uint8) for _ in range(2)]
    ref = rng.rand(2, 3, 1, 192, 512).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    specs = []
    for name, pair, extra in (("hm", img, dict(heatmap="raw", dim_order="HWC", fps=0, batch=1)),
                              ("loss", (test, ref), dict(loss=True, batch=batch))):
        paths = [str(tmp_path / f"{name}{i}.npy") for i in range(2)]
        for p, a in zip(paths, pair):
            np.save(p, a)
        specs.append(dict(test=paths[0], reference=paths[1], display_name="standard_4k",
                          **extra))
    from colorvideovdp_tpu_torch.parallel import launch

    res = run_ranks(launch.run_jobs, world, ([(sh.score_rank, (sp,)) for sp in specs],),
                    device="cuda", timeout_s=300)
    Q1, st = ct.cvvdp(display_name="standard_4k", device="cuda", heatmap="raw").predict(
        *img, dim_order="HWC")
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    t = torch.from_numpy(test).to(dev).requires_grad_()
    v = m.get_loss_fn(192, 512)(t, torch.from_numpy(ref).to(dev))
    v.backward()
    g1 = t.grad.cpu().numpy()
    got = np.full_like(g1, np.nan)
    for _, loss in res:
        g = loss["grad"]
        bl, hl = g.shape[0], g.shape[-2]
        got[loss["b"] * bl:(loss["b"] + 1) * bl, ..., loss["s"] * hl:(loss["s"] + 1) * hl, :] = g
    for hm, loss in res:
        assert abs(float(hm["jod"]) - float(Q1)) <= 2e-4
        assert hm["launches"]["band_pooled_d_halo"] > 0
        assert np.abs(hm["heatmap"].astype(np.float32) - st["heatmap"].astype(np.float32)
                      ).max() <= 1.1e-3
        assert abs(loss["loss"] - float(v.detach())) <= 1e-4
        assert loss["launches"]["band_pooled_halo"] > 0
    assert np.abs(got - g1).max() <= 1e-3 * np.abs(g1).max()


def test_sharded_scoring_on_the_card(dev, tmp_path):
    """A 192x512 image and a 2-block 128x256 video on a (1, 2) mesh of two
    ranks on the card(s): the JODs of single-device scoring, and the slab
    reduce and the one-pass kernel's halo mode launched on every rank."""
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
            assert r["launches"]["band_pooled_halo"] > 0


def _yuv_pair_files(tmp_path, h, w, n, seed=2):
    """A 10-bit 4:2:0 BT.2020 .yuv pair (test = reference + noise)."""
    from colorvideovdp_tpu_torch.io.yuv import create_yuv_fname

    rng = np.random.RandomState(seed)
    ref = rng.randint(64, 940, n * h * w * 3 // 2)
    test = np.clip(ref + rng.randint(-30, 30, ref.shape), 0, 1023)
    names = []
    for tag, data in (("test", test), ("ref", ref)):
        name = str(tmp_path / create_yuv_fname(tag, dict(width=w, height=h, fps=30,
                                                         bit_depth=10, chroma_ss="420",
                                                         color_space="2020")))
        data.astype("<u2").tofile(name)
        names.append(name)
    return names


@pytest.mark.parametrize("fsr", [None, "bicubic"])
def test_yuv_unpack_on_the_card_matches_cpu(dev, tmp_path, fsr):
    from colorvideovdp_tpu_torch.io.yuv import video_source_yuv_file

    vs = video_source_yuv_file(*_yuv_pair_files(tmp_path, 270, 482, 3),
                               display_photometry="standard_hdr_pq")
    vs.full_screen_resize, vs.resize_resolution = fsr, (301, 150)
    raw = vs.get_raw_block("test", 0, 3).view(np.int16)
    cpu = vs.unpack_raw_block(torch.from_numpy(raw))
    card = vs.unpack_raw_block(torch.from_numpy(raw).to(dev))
    assert card.is_cuda and card.shape == cpu.shape
    # The card divides by a constant through its reciprocal: an ulp or two.
    assert float((card.cpu() - cpu).abs().max()) <= 1e-6


@pytest.mark.parametrize("route", ["file", "per-frame"])
def test_file_route_kernels_match_plain(dev, tmp_path, route):
    """A .yuv pair through video_source_file in two blocks, kernels against
    plain; the file route launches ingest, the per-frame route does not."""
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file

    names = _yuv_pair_files(tmp_path, 192, 320, 7)
    jods = []
    for fused in (True, False):
        vs = video_source_file(*names, display_photometry="standard_hdr_pq")
        if route == "per-frame":
            vs = _HideRaw(vs)  # read frame by frame
        m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda")
        m.enable_fused_kernels = fused
        m.gpu_mem = m.block_gpu_mem(192 * 320, 4, 30, reference_model=route == "per-frame")
        before = (ing.ingest.launches, prd.pyramid_reduce.launches, bp.band_pooled.launches)
        Q, st = m.predict_video_source(vs)
        assert st["block_N_frames"] == 4
        after = (ing.ingest.launches, prd.pyramid_reduce.launches, bp.band_pooled.launches)
        launched = [a > b for a, b in zip(after, before)]
        assert launched == ([route == "file", True, True] if fused else [False] * 3)
        jods.append(float(Q))
    assert abs(jods[0] - jods[1]) <= 1e-4, jods


class _HideRaw:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        if name in ("get_raw_block", "get_raw_frame_list", "unpack_raw_block"):
            raise AttributeError(name)
        return getattr(self.inner, name)


def test_aux_metrics_on_the_card_match_cpu(dev, tmp_path):
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file

    vs = video_source_file(*_yuv_pair_files(tmp_path, 136, 242, 2),
                           display_photometry="standard_hdr_pq")
    for cls, tol in ((ct.psnr_rgb, 1e-4), (ct.pu_psnr_y, 1e-4), (ct.pu_psnr_rgb2020, 1e-4),
                     (ct.ssim_metric, 1e-5)):
        card, _ = cls(display_name="standard_hdr_pq").predict_video_source(vs)
        cpu, _ = cls(display_name="standard_hdr_pq", device="cpu").predict_video_source(vs)
        assert card.is_cuda
        assert float((card.cpu() - cpu).abs().max()) <= tol, cls


class _Frames:
    """A writer that keeps the frames it is given, by file stem."""

    frames = {}

    def __init__(self, fname, fps=0, **kw):
        self.fname = fname
        self.stem = fname.replace("\\", "/").split("/")[-1].split(".")[0]
        _Frames.frames[self.stem] = []

    def write_frame_rgb(self, rgb):
        _Frames.frames[self.stem].append(np.array(rgb))

    def close(self):
        pass


def test_dump_route_kernels_match_plain(dev, tmp_path, monkeypatch):
    """All three dumps of a 2-block .yuv video: the D route (band_pooled_d),
    the dumped frames kernels against plain within 1 code value, and the JOD
    with dumps the pooled-only JOD."""
    from colorvideovdp_tpu_torch import dump_channels as dc
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file

    monkeypatch.setattr(dc, "VideoWriter", _Frames)
    names = _yuv_pair_files(tmp_path, 136, 242, 6)
    res = {}
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda",
                     dump_channels=dc.DumpChannels())
        m.enable_fused_kernels = fused
        m.gpu_mem = m.block_gpu_mem(136 * 242, 3, 30)
        _Frames.frames = {}
        before = bp.band_pooled_d.launches
        Q, st = m.predict_video_source(video_source_file(*names,
                                                         display_photometry="standard_hdr_pq"))
        assert st["block_N_frames"] == 3
        assert (bp.band_pooled_d.launches > before) == fused
        res[fused] = (float(Q), {k: np.stack(v) for k, v in _Frames.frames.items()})
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda")
    q_pooled, _ = m.predict_video_source(video_source_file(*names,
                                                           display_photometry="standard_hdr_pq"))
    assert abs(res[True][0] - float(q_pooled)) <= 1e-4
    assert abs(res[True][0] - res[False][0]) <= 1e-4
    assert sorted(res[True][1]) == ["diff", "lpyr", "temp_channels"]
    for stem, a in res[True][1].items():
        b = res[False][1][stem]
        assert a.shape == b.shape and a.shape[0] == 6
        assert int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= 1, stem


def test_cli_kernels_match_plain(dev, tmp_path, monkeypatch):
    """The CLI on the card (its default device) on a .yuv pair: the CSV's JOD
    against the API's on the same files, and with cvvdp's kernels off."""
    import csv

    from colorvideovdp_tpu_torch import cli
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file
    from colorvideovdp_tpu_torch.metrics.base import vq_metric_dict

    names = _yuv_pair_files(tmp_path, 136, 242, 5)

    class cvvdp_plain(ct.cvvdp):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.enable_fused_kernels = False

    jods = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setitem(vq_metric_dict, "cvvdp", cvvdp_plain)
        res = str(tmp_path / f"res{int(fused)}.csv")
        before = _ingest_launches()
        cli.run_on_args(cli.parse_args(["-t", names[0], "-r", names[1], "--display",
                                        "standard_hdr_pq", "--result", res, "-q"]))
        assert (_ingest_launches() > before) == fused
        with open(res) as f:
            jods.append(float(list(csv.reader(f))[1][2]))
    q_api, _ = ct.cvvdp(display_name="standard_hdr_pq", temp_padding="symmetric"
                        ).predict_video_source(video_source_file(
                            *names, display_photometry="standard_hdr_pq"))
    assert abs(jods[0] - float(q_api)) <= 1e-4 and abs(jods[0] - jods[1]) <= 1e-3, jods
