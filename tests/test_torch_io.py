"""The port's file sources against the JAX package (CPU): file-name
metadata, the planar YUV unpack and the resize it uses, the decoded-video
unpack, .mat, image and EXR files, the dispatch, the per-frame API, and the
JOD of each kind of file pair and of the per-frame route."""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.io import ffcodec as ff_j  # noqa: E402
from colorvideovdp_tpu.io import video_source_file as vsf_j  # noqa: E402
from colorvideovdp_tpu.io import yuv as yuv_j  # noqa: E402
from colorvideovdp_tpu.utils import exr as exr_j  # noqa: E402
from colorvideovdp_tpu_torch.io import ffcodec as ff_t  # noqa: E402
from colorvideovdp_tpu_torch.io import video_source_file as vsf_t  # noqa: E402
from colorvideovdp_tpu_torch.io import yuv as yuv_t  # noqa: E402
from colorvideovdp_tpu_torch.ops import resize as rs_t  # noqa: E402
from colorvideovdp_tpu_torch.utils import exr as exr_t  # noqa: E402

JOD_TOL = 1e-4
# The unpack: fixed point -> float, bilinear chroma, the 3x3 sum, clip.
UNPACK_TOL = 1e-6
# jax.image.resize's Keys cubic weights, compiled by XLA on the CPU, come out
# up to 4.8e-7 from the same formula evaluated in float32 (XLA contracts the
# polynomial into fused multiply-adds): a cubic resize differs by up to
# 1.1e-6, while the port is within 3e-7 of a float64 evaluation of its
# float32 weights (test_resize_matches_jax_image_resize).
CUBIC_TOL = 1.5e-6
H, W, N = 38, 54, 5  # even luma; odd 4:2:0 chroma (19 x 27)


def _packed(raw):
    """A reader's packed block as the metric uploads it."""
    raw = np.ascontiguousarray(raw)
    return torch.from_numpy(raw.view(np.int16) if raw.dtype == np.uint16 else raw)


def _write_yuv(path, frames, bit_depth):
    dt = "<u2" if bit_depth > 8 else np.uint8
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                f.write(np.ascontiguousarray(p, dt).tobytes())


def _planar(rng, h, w, chroma, bit_depth, smooth=False):
    uh, uw = {"420": (h // 2, w // 2), "422": (h, w // 2), "444": (h, w)}[chroma]
    hi = 2 ** bit_depth
    dt = np.uint16 if bit_depth > 8 else np.uint8
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        base = (0.5 + 0.3 * np.sin(xx / 7.0 + rng.rand() * 6) * np.cos(yy / 5.0)) * hi
        Y = np.clip(base + rng.randn(h, w) * 0.02 * hi, 0, hi - 1).astype(dt)
    else:
        Y = rng.randint(0, hi, (h, w)).astype(dt)
    return Y, rng.randint(0, hi, (uh, uw)).astype(dt), rng.randint(0, hi, (uh, uw)).astype(dt)


def _yuv_pair(tmp_path, chroma="420", bit_depth=10, space="2020", smooth=True, seed=0):
    rng = np.random.RandomState(seed)
    names = []
    for tag in ("test", "ref"):
        path = str(tmp_path / f"{tag}_{W}x{H}p24_{chroma}_{bit_depth}b_{space}.yuv")
        _write_yuv(path, [_planar(rng, H, W, chroma, bit_depth, smooth) for _ in range(N)],
                   bit_depth)
        names.append(path)
    return names


@pytest.mark.parametrize("name", [
    "/x/seq_1280x720p25_420_8bit_sdr.yuv", "/x/a_1920x1080_10b_444_2020_59.94fps.yuv",
    "clip_640x360_422_10bit_pq2020.yuv", "b_3840x2160p60_hdr.yuv", "plain.yuv",
    "c_720x480_bt709_8b_23.976fps.yuv"])
def test_decode_video_props_matches_jax(name):
    p = yuv_t.decode_video_props(name)
    assert p == yuv_j.decode_video_props(name)
    assert yuv_t.create_yuv_fname("x", p) == yuv_j.create_yuv_fname("x", p)
    assert yuv_t.decode_video_props(yuv_t.create_yuv_fname("x", p)) == p


@pytest.mark.parametrize("chroma,bit_depth,space", [
    ("420", 10, "2020"), ("420", 8, "709"), ("422", 8, "2020"), ("422", 10, "709"),
    ("444", 8, "709"), ("444", 10, "2020")])
@pytest.mark.parametrize("fsr,res", [(None, None), ("bilinear", (80, 61)),
                                     ("bicubic", (31, 20)), ("nearest", (75, 50)),
                                     ("bilinear", (27, 19)), ("bicubic", (100, 70)),
                                     ("nearest", (20, 13))])
def test_yuv_unpack_matches_jax(tmp_path, chroma, bit_depth, space, fsr, res):
    test, ref = _yuv_pair(tmp_path, chroma, bit_depth, space, smooth=False)
    kw = dict(display_photometry="standard_hdr_pq")
    sj, st = yuv_j.video_source_yuv_file(test, ref, **kw), yuv_t.video_source_yuv_file(
        test, ref, **kw)
    for s in (sj, st):
        s.full_screen_resize, s.resize_resolution = fsr, res
    assert st.get_video_size() == sj.get_video_size()
    raw = st.get_raw_block("test", 1, 3)
    np.testing.assert_array_equal(raw, sj.get_raw_block("test", 1, 3))
    a = np.asarray(sj.unpack_raw_block(jnp.asarray(raw)))
    b = st.unpack_raw_block(_packed(raw))
    assert b.dtype == torch.float32 and b.shape == a.shape
    tol = CUBIC_TOL if fsr == "bicubic" else UNPACK_TOL
    assert np.abs(b.numpy() - a).max() <= tol


def test_yuv_709_matrix_is_the_bt601_coefficients():
    """The .yuv reader's "709" is 1.402 / 1.772 (BT.601), as the JAX package's."""
    np.testing.assert_array_equal(yuv_t._YCBCR2RGB["709"], yuv_j._YCBCR2RGB["709"])
    assert yuv_t._YCBCR2RGB["709"][0, 2] == np.float32(1.402)
    assert yuv_t._YCBCR2RGB["709"][2, 1] == np.float32(1.772)
    np.testing.assert_array_equal(yuv_t._YCBCR2RGB["2020"], yuv_j._YCBCR2RGB["2020"])


@pytest.mark.parametrize("method", ["linear", "cubic", "nearest"])
@pytest.mark.parametrize("size", [(76, 108), (20, 31), (38, 80), (13, 54), (57, 81)])
def test_resize_matches_jax_image_resize(method, size):
    x = np.random.RandomState(1).rand(2, 3, 38, 54).astype(np.float32)
    a = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + size, method=method))
    b = rs_t.resize(torch.from_numpy(x), size, method).numpy()
    assert b.shape == a.shape
    assert np.abs(b - a).max() <= (CUBIC_TOL if method == "cubic" else UNPACK_TOL)
    if method == "nearest":
        np.testing.assert_array_equal(b, a)
        return
    from jax._src.image import scale as jscale

    kernel = {"linear": jscale._fill_triangle_kernel, "cubic": jscale._fill_keys_cubic_kernel}
    for n_in, n_out in zip((38, 54), size):
        if n_in == n_out:
            continue
        want = np.asarray(jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                                    kernel[method], True))
        # The column sums round in another order: one ulp of 1 at most.
        assert np.abs(rs_t.weight_matrix(n_in, n_out, method) - want).max() <= 1.2e-7
    # Against a float64 evaluation of the same weights.
    wh = rs_t.weight_matrix(38, size[0], method).astype(np.float64) if size[0] != 38 \
        else np.eye(38)
    ww = rs_t.weight_matrix(54, size[1], method).astype(np.float64) if size[1] != 54 \
        else np.eye(54)
    exact = np.einsum("bchw,hH,wW->bcHW", x.astype(np.float64), wh, ww)
    assert np.abs(b - exact).max() <= 3e-7


def _need_codec():
    if not (ff_t.available() and ff_j.available()):
        pytest.skip("native codec library not built (make -C native)")


def _mp4(path, frames, bit_depth, codec, fps=24):
    h, w = frames[0][0].shape
    wr = ff_j.CodecVideoWriter(str(path), w, h, fps, bit_depth=bit_depth, codec=codec,
                               crf=-1.0, hdr_tags=bit_depth > 8)
    for y, u, v in frames:
        wr.write_frame_yuv(y, u, v)
    wr.close()


@pytest.mark.parametrize("h,w,bit_depth,ext,codec", [(37, 53, 8, "mkv", "ffv1"),
                                                     (38, 54, 8, "mp4", "libx264"),
                                                     (38, 54, 10, "mp4", "libx265")])
def test_codec_unpack_matches_jax(tmp_path, h, w, bit_depth, ext, codec):
    """A video written by the JAX package's writer (at odd sizes, in ffv1:
    the 4:2:0 chroma is the ceiling of half) read by both packages'
    readers, unpacked by both."""
    _need_codec()
    rng = np.random.RandomState(3)
    dt = np.uint16 if bit_depth > 8 else np.uint8
    frames = [(rng.randint(0, 2 ** bit_depth, (h, w)).astype(dt),
               rng.randint(0, 2 ** bit_depth, ((h + 1) // 2, (w + 1) // 2)).astype(dt),
               rng.randint(0, 2 ** bit_depth, ((h + 1) // 2, (w + 1) // 2)).astype(dt))
              for _ in range(4)]
    path = tmp_path / f"c.{ext}"
    _mp4(path, frames, bit_depth, codec)
    kw = dict(display_photometry="standard_fhd")
    sj = vsf_j.video_source_codec_file(str(path), str(path), **kw)
    st = vsf_t.video_source_codec_file(str(path), str(path), **kw)
    assert st.raw_block_key() == sj.raw_block_key()
    assert st.get_video_size() == sj.get_video_size() == (h, w, 4)
    raw = st.get_raw_block("test", 0, 4)
    np.testing.assert_array_equal(raw, sj.get_raw_block("test", 0, 4))
    a = np.asarray(sj.unpack_raw_block(jnp.asarray(raw)))
    b = st.unpack_raw_block(_packed(raw)).numpy()
    assert np.abs(b - a).max() <= UNPACK_TOL
    np.testing.assert_array_equal(ff_t.ycbcr_to_rgb_matrix("709"),
                                  ff_j.ycbcr_to_rgb_matrix("709"))
    for got, want in zip(ff_t.rgb_to_ycbcr_coeffs("2020"), ff_j.rgb_to_ycbcr_coeffs("2020")):
        np.testing.assert_array_equal(got, want)


def test_codec_dispatch_and_fallback(tmp_path, monkeypatch):
    _need_codec()
    rng = np.random.RandomState(5)
    p8 = tmp_path / "a.mp4"
    _mp4(p8, [_planar(rng, 48, 64, "420", 8) for _ in range(3)], 8, "libx264")
    kw = dict(display_photometry="standard_fhd")
    assert isinstance(vsf_t.video_source_file(str(p8), str(p8), **kw),
                      vsf_t.video_source_codec_file)
    monkeypatch.setenv("CVVDP_NO_NATIVE_DECODE", "1")
    assert not ff_t.enabled()
    src = vsf_t.video_source_file(str(p8), str(p8), **kw)
    assert type(src) is vsf_t.video_source_video_file
    np.testing.assert_array_equal(src.get_raw_block("test", 0, 2),
                                  vsf_j.video_source_video_file(str(p8), str(p8), **kw)
                                  .get_raw_block("test", 0, 2))
    monkeypatch.delenv("CVVDP_NO_NATIVE_DECODE")
    p10 = tmp_path / "b.mp4"
    _mp4(p10, [_planar(rng, 48, 64, "420", 10) for _ in range(3)], 10, "libx265")
    assert type(vsf_t.video_source_file(str(p8), str(p10), **kw)) \
        is vsf_t.video_source_video_file


@pytest.mark.parametrize("half,compression,C", [(False, "zip", 3), (True, "zip", 3),
                                                (False, "none", 1), (True, "zips", 3)])
def test_exr_round_trip_and_interop_with_jax(tmp_path, half, compression, C):
    img = np.random.RandomState(2).rand(19, 37, C).astype(np.float32) * 50
    mine, theirs = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    exr_t.write(mine, img, half=half, compression=compression)
    exr_j.write(theirs, img, half=half, compression=compression)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = exr_t.read(mine)
    np.testing.assert_array_equal(back, exr_j.read(mine))
    np.testing.assert_allclose(back, img, rtol=1e-3 if half else 0, atol=0)


def test_exr_numpy_fallback_matches_native_path(tmp_path, monkeypatch):
    from colorvideovdp_tpu_torch.utils import native

    img = np.random.RandomState(3).rand(21, 45, 3).astype(np.float32) * 10
    path = str(tmp_path / "n.exr")
    exr_t.write(path, img)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", True)
    np.testing.assert_array_equal(exr_t.read(path), img)
    exr_t.write(str(tmp_path / "p.exr"), img)
    np.testing.assert_array_equal(exr_t.read(str(tmp_path / "p.exr")), img)


def _png_sequences(tmp_path, frames=N):
    import imageio.v2 as iio

    rng = np.random.RandomState(4)
    os.makedirs(tmp_path / "seq", exist_ok=True)
    for i in range(frames):
        ref = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        test = np.clip(ref.astype(np.int16) + rng.randint(-30, 30, ref.shape), 0, 255)
        iio.imwrite(str(tmp_path / "seq" / f"t_{i:03d}.png"), test.astype(np.uint8))
        iio.imwrite(str(tmp_path / "seq" / f"r_{i:03d}.png"), ref)
    return str(tmp_path / "seq" / "t_%03d.png"), str(tmp_path / "seq" / "r_%03d.png")


def test_image_mat_and_exr_sources_match_jax(tmp_path):
    from scipy.io import savemat

    t_pat, r_pat = _png_sequences(tmp_path, 3)
    rng = np.random.RandomState(6)
    vid = (rng.rand(H, W, 3, 4) * 200).astype(np.float32)
    savemat(str(tmp_path / "flat.mat"), {"I_vid": vid, "fps": 25.0})
    savemat(str(tmp_path / "nested.mat"), {"data": {"clip": {"I_vid": vid, "fps": 25.0}}})
    img = (rng.rand(H, W, 3) * 80).astype(np.float32)
    exr_t.write(str(tmp_path / "i.exr"), img)
    cases = [((t_pat, r_pat), dict(fps=30), vsf_t.video_source_image_frames, (H, W, 3)),
             ((t_pat % 1,) * 2, {}, vsf_t.video_source_image_frames, (H, W, 1)),
             ((str(tmp_path / "flat.mat"),) * 2, {}, vsf_t.video_source_matlab, (H, W, 4)),
             ((str(tmp_path / "nested.mat"),) * 2, {}, vsf_t.video_source_matlab, (H, W, 4)),
             ((str(tmp_path / "i.exr"),) * 2, {}, vsf_t.video_source_image_frames, (H, W, 1))]
    for files, kw, cls, size in cases:
        st = ct.video_source_file(*files, display_photometry="standard_4k", **kw)
        assert type(st) is cls and st.get_video_size() == size
        blk = st.get_raw_block("test", 0, size[2] + 1)
        if files[0].endswith(".exr"):
            # The JAX package reads .exr through cv2, built here without
            # OpenEXR: compare with the image written.
            np.testing.assert_array_equal(blk[0, 0], img.transpose(2, 0, 1))
            continue
        sj = vsf_j.video_source_file(*files, display_photometry="standard_4k", **kw)
        np.testing.assert_array_equal(blk, sj.get_raw_block("test", 0, size[2] + 1))
        assert st.get_frames_per_second() == sj.get_frames_per_second()
        # The per-frame API on the CPU.
        for which in ("test_frame", "reference_frame"):
            a = np.asarray(getattr(sj, "get_" + which)(size[2] - 1, colorspace="DKLd65"))
            b = getattr(st, "get_" + which)(size[2] - 1, device="cpu", colorspace="DKLd65")
            assert b.device.type == "cpu"
            assert np.abs(b.numpy() - a).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "rgba8", "rgba16", "grey8", "grey16"])
def test_png_without_imageio_reads_as_imageio_and_jax(tmp_path, monkeypatch, kind):
    """Where imageio is not installed, PNGs are read
    through OpenCV: the same array as imageio's and the JAX package's (a
    16-bit colour PNG as its high bytes, as imageio's Pillow reader gives
    it)."""
    import cv2

    rng = np.random.RandomState(len(kind))
    dt = np.uint16 if kind.endswith("16") else np.uint8
    shape = (H, W) if kind.startswith("grey") else (H, W, 4 if kind in ("rgba8", "rgba16") else 3)
    img = rng.randint(0, np.iinfo(dt).max + 1, shape).astype(dt)
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, img if img.ndim == 2 else img[..., [2, 1, 0, 3][: shape[2]]])
    want = vsf_j.load_image_as_array(path)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    got = vsf_t.load_image_as_array(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if img.ndim == 3 and dt == np.uint16:
        img = (img >> 8).astype(np.uint8)
    np.testing.assert_array_equal(got, img[..., :3] if img.ndim == 3 else img[..., None])


def test_per_frame_api_of_yuv_and_array_sources_match_jax(tmp_path):
    test, ref = _yuv_pair(tmp_path, seed=8)
    sj = yuv_j.video_source_yuv_file(test, ref, display_photometry="standard_hdr_pq")
    st = yuv_t.video_source_yuv_file(test, ref, display_photometry="standard_hdr_pq")
    # A PQ display: 1e-4 relative, as the ingest stage is held (JAX's float32
    # PQ curve is ill-conditioned near the peak; the port rounds its powers
    # correctly).
    for cs in ("DKLd65", "Y", "display_encoded_100nit", "RGB2020"):
        a = np.asarray(sj.get_test_frame(2, colorspace=cs))
        b = st.get_test_frame(2, device="cpu", colorspace=cs).numpy()
        assert np.abs(b - a).max() <= 1e-4 * max(1.0, np.abs(a).max())
    arr = np.random.RandomState(9).rand(2, 3, 3, 8, 12).astype(np.float32)
    aj = cj.video_source_array(arr, arr, 24, dim_order="BFCHW")
    at = ct.video_source_array(arr, arr, 24, dim_order="BFCHW")
    a = np.asarray(aj.get_reference_frame(1, colorspace="XYZ"))
    b = at.get_reference_frame(1, device="cpu", colorspace="XYZ").numpy()
    assert b.shape == a.shape == (2, 3, 1, 8, 12)
    assert np.abs(b - a).max() <= 1e-6 * np.abs(a).max()
    assert at.get_frame_count() == 3 and at.get_batch_size() == 2


def test_check_if_valid_warns_once(caplog):
    arr = np.full((1, 3, 2, 4, 4), 0.2, np.float32)
    arr[0, 0, 0, 0, 0] = np.nan
    vs = ct.video_source_array(arr, arr, 24, display_photometry="standard_hdr_linear")
    with caplog.at_level("WARNING"):
        vs.get_test_frame(0, device="cpu", colorspace="XYZ")
        vs.get_test_frame(1, device="cpu", colorspace="XYZ")
    assert [r.getMessage() for r in caplog.records] == ["Image contains one or more NaN values"]
    dim = ct.video_source_array(np.full((1, 3, 1, 4, 4), 0.001, np.float32),
                                np.zeros((1, 3, 1, 4, 4), np.float32), 0,
                                display_photometry="standard_hdr_linear")
    caplog.clear()
    with caplog.at_level("WARNING"):
        dim.get_test_frame(0, device="cpu", colorspace="XYZ")
    assert "not be scaled in absolute photometric units" in caplog.records[0].getMessage()


class _PerFrame:
    """A source with the raw-block methods hidden: the metrics read it frame
    by frame."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        if name in ("get_raw_block", "get_raw_frame_list", "unpack_raw_block"):
            raise AttributeError(name)
        return getattr(self.inner, name)


def _jods(src_j, src_t, display, padding="replicate", gpu_mem=None):
    mj = cj.cvvdp(display_name=display, temp_padding=padding, quiet=True)
    mt = ct.cvvdp(display_name=display, temp_padding=padding, device="cpu", gpu_mem=gpu_mem)
    mj.gpu_mem = gpu_mem
    qj, _ = mj.predict_video_source(src_j)
    qt, st = mt.predict_video_source(src_t)
    return float(qj), float(qt), st


def test_yuv_pair_jod_matches_jax(tmp_path):
    test, ref = _yuv_pair(tmp_path, seed=1)
    kw = dict(display_photometry="standard_hdr_pq")
    qj, qt, _ = _jods(yuv_j.video_source_yuv_file(test, ref, **kw),
                      yuv_t.video_source_yuv_file(test, ref, **kw), "standard_hdr_pq")
    assert np.isfinite(qt) and abs(qt - qj) <= JOD_TOL


@pytest.mark.parametrize("padding", ["replicate", "symmetric"])
def test_per_frame_route_jod_matches_jax_and_block_route(tmp_path, padding):
    """The per-frame route (no get_raw_block) in two-frame blocks with a
    trailing partial block, against the JAX package's generic route and the
    port's own block route."""
    test, ref = _yuv_pair(tmp_path, seed=2)
    kw = dict(display_photometry="standard_hdr_pq")
    sj, st = (yuv_j.video_source_yuv_file(test, ref, **kw),
              yuv_t.video_source_yuv_file(test, ref, **kw))
    mt = ct.cvvdp(display_name="standard_hdr_pq", device="cpu")
    gpu_mem = mt.block_gpu_mem(H * W, 2, 24)
    qj, qt, stats = _jods(_PerFrame(sj), _PerFrame(st), "standard_hdr_pq", padding, gpu_mem)
    assert stats["block_N_frames"] == 2
    _, q_block, _ = _jods(sj, st, "standard_hdr_pq", padding, gpu_mem)
    assert abs(qt - qj) <= JOD_TOL and abs(qt - q_block) <= JOD_TOL


def test_mp4_pair_jod_matches_jax(tmp_path):
    _need_codec()
    rng = np.random.RandomState(11)
    paths = []
    for tag in ("t", "r"):
        path = tmp_path / f"{tag}.mp4"
        _mp4(path, [_planar(rng, H, W, "420", 10, smooth=True) for _ in range(N)], 10,
             "libx265")
        paths.append(str(path))
    kw = dict(display_photometry="standard_hdr_pq")
    sj = vsf_j.video_source_file(*paths, **kw)
    st = vsf_t.video_source_file(*paths, **kw)
    assert type(st) is vsf_t.video_source_codec_file
    qj, qt, _ = _jods(sj, st, "standard_hdr_pq")
    assert np.isfinite(qt) and abs(qt - qj) <= JOD_TOL


def test_image_sequence_and_mat_pair_jods_match_jax(tmp_path):
    from scipy.io import savemat

    t_pat, r_pat = _png_sequences(tmp_path)
    kw = dict(display_photometry="standard_4k", fps=24)
    qj, qt, _ = _jods(vsf_j.video_source_file(t_pat, r_pat, **kw),
                      vsf_t.video_source_file(t_pat, r_pat, **kw), "standard_4k")
    assert np.isfinite(qt) and abs(qt - qj) <= JOD_TOL
    rng = np.random.RandomState(12)
    ref = (rng.rand(H, W, 3, N) * 0.8 + 0.1).astype(np.float32)
    for tag, arr in (("t", np.clip(ref + rng.randn(*ref.shape) * 0.05, 0, 1)), ("r", ref)):
        savemat(str(tmp_path / f"{tag}.mat"), {"I": arr.astype(np.float32), "fps": 24.0})
    mats = (str(tmp_path / "t.mat"), str(tmp_path / "r.mat"))
    kw = dict(display_photometry="standard_4k")
    qj, qt, _ = _jods(vsf_j.video_source_file(*mats, **kw),
                      vsf_t.video_source_file(*mats, **kw), "standard_4k")
    assert np.isfinite(qt) and abs(qt - qj) <= JOD_TOL


def test_packed_route_equals_array_route_on_unpacked_frames(tmp_path):
    """The .yuv pair scores as the array route fed the source's own unpacked
    float32 frames, for cvvdp (two blocks, symmetric padding) and the ML
    metrics; a luminance-only unpack is broadcast to three channels."""
    test, ref = _yuv_pair(tmp_path, seed=3)
    vs = yuv_t.video_source_yuv_file(test, ref, display_photometry="standard_hdr_pq")
    rgb = [vs.unpack_raw_block(_packed(vs.get_raw_block(s, 0, N))).numpy()
           for s in ("test", "reference")]
    for m in (ct.cvvdp(display_name="standard_hdr_pq", device="cpu", temp_padding="symmetric"),
              ct.cvvdp_ml_saliency(display_name="standard_hdr_pq", device="cpu",
                                   random_init=True)):
        m.gpu_mem = m.block_gpu_mem(H * W, 3, 24)
        q_file, st = m.predict_video_source(vs)
        q_arr, _ = m.predict(rgb[0], rgb[1], dim_order="BCFHW", frames_per_second=24)
        assert st["block_N_frames"] == 3
        assert abs(float(q_file) - float(q_arr)) <= 1e-6

    class Grey(yuv_t.video_source_yuv_file):
        def unpack_raw_block(self, x):
            return super().unpack_raw_block(x)[:, 1:2]

    m = ct.cvvdp(display_name="standard_hdr_pq", device="cpu")
    q_grey, _ = m.predict_video_source(Grey(test, ref, display_photometry="standard_hdr_pq"))
    q_arr, _ = m.predict(np.repeat(rgb[0][:, 1:2], 3, axis=1),
                         np.repeat(rgb[1][:, 1:2], 3, axis=1), dim_order="BCFHW",
                         frames_per_second=24)
    assert abs(float(q_grey) - float(q_arr)) <= 1e-6


def test_prefetch_reads_each_block_once_in_order(tmp_path):
    """The block loop reads the next block on a worker while the current one
    is scored: every block once, in order, and under symmetric padding the
    second block only after the head frames."""
    test, ref = _yuv_pair(tmp_path, seed=4)
    calls = []

    class Logged(yuv_t.video_source_yuv_file):
        def get_raw_block(self, which, start, count):
            calls.append(("block", which, start))
            return super().get_raw_block(which, start, count)

        def get_raw_frame_list(self, which, indices):
            calls.append(("head", which, None))
            return super().get_raw_frame_list(which, indices)

    for padding in ("replicate", "symmetric"):
        calls.clear()
        m = ct.cvvdp(display_name="standard_hdr_pq", device="cpu", temp_padding=padding)
        m.gpu_mem = m.block_gpu_mem(H * W, 2, 24)
        m.predict_video_source(Logged(test, ref, display_photometry="standard_hdr_pq"))
        blocks = [c for c in calls if c[0] == "block"]
        assert blocks == [("block", s, f) for f in (0, 2, 4) for s in ("test", "reference")]
        if padding == "symmetric":
            assert calls.index(("head", "reference", None)) < calls.index(
                ("block", "test", 2))


def test_temp_resample_file_source_matches_jax(tmp_path):
    """Videos at 24 and 30 fps resampled to a common rate (the nearest frame,
    native decode, preloaded): the frame indices, the blocks and the JOD."""
    _need_codec()
    rng = np.random.RandomState(13)
    paths = []
    for tag, fps, n in (("t", 24, 4), ("r", 30, 5)):
        path = tmp_path / f"{tag}.mp4"
        _mp4(path, [_planar(rng, H, W, "420", 8, smooth=True) for _ in range(n)], 8,
             "libx264", fps=fps)
        paths.append(str(path))
    kw = dict(display_photometry="standard_4k")
    sj = vsf_j.video_source_temp_resample_file(*paths, **kw)
    st = vsf_t.video_source_temp_resample_file(*paths, **kw)
    assert st.get_frames_per_second() == sj.get_frames_per_second() == 120
    assert st.get_video_size() == sj.get_video_size()
    n = st.get_video_size()[2]
    assert [st._src_index("test", i) for i in range(n)] == [
        sj._src_index("test", i) for i in range(n)]
    np.testing.assert_array_equal(st.get_raw_block("reference", 3, 7),
                                  sj.get_raw_block("reference", 3, 7))
    qj, qt, _ = _jods(sj, st, "standard_4k")
    assert np.isfinite(qt) and abs(qt - qj) <= JOD_TOL


@pytest.mark.parametrize("route", ["blocks", "frames"])
def test_scored_block_is_freed_before_the_next(tmp_path, monkeypatch, route):
    """Neither block producer keeps the scored block alive while the next
    one is formed (device memory holds one block at a time)."""
    import weakref

    from colorvideovdp_tpu_torch.ops.kernels import ingest as ing

    test, ref = _yuv_pair(tmp_path, seed=5)
    name = "ingest_plain" if route == "blocks" else "temporal_fir"
    real, alive = getattr(ing, name), []

    def spy(*args, **kwargs):
        assert all(r() is None for r in alive), "the previous block is still referenced"
        out = real(*args, **kwargs)
        alive.append(weakref.ref(out[0]))
        return out

    monkeypatch.setattr(ing, name, spy)
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cpu")
    m.gpu_mem = m.block_gpu_mem(H * W, 2, 24)
    vs = yuv_t.video_source_yuv_file(test, ref, display_photometry="standard_hdr_pq")
    m.predict_video_source(vs if route == "blocks" else _PerFrame(vs))
    assert len(alive) == 3
