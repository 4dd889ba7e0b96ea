"""The port's writers and display-model previews against the JAX package's
(CPU): YUV4MPEG2 bytes, the video writer's back-end dispatch (the SDR
``.y4m`` deviation where neither the native core nor cv2 imports), EXR and
PNG images, and every ``dm_preview`` variant's files.

Tolerances: ``.y4m`` and PNG bytes equal where both packages quantise the
same float32 frames; the previews' ``.y4m`` samples within 1 code value;
their EXR pixels (linear cd/m^2) within 1e-6 relative from an SDR display
and 1e-4 relative from a PQ one, whose float32 EOTF is ill-conditioned near
the peak (the repo's PQ bound; 6.3e-5 seen); the SDR ``.y4m`` luma within 1
code value of BT.601 limited-range luma."""

import logging
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.io import ffcodec as ff_j  # noqa: E402
from colorvideovdp_tpu.io import writers as wr_j  # noqa: E402
from colorvideovdp_tpu.io.video_source_file import video_source_file as vsf_j  # noqa: E402
from colorvideovdp_tpu.metrics import dm_preview as dm_j  # noqa: E402
from colorvideovdp_tpu.utils import exr as exr_j  # noqa: E402
from colorvideovdp_tpu_torch.io import ffcodec as ff_t  # noqa: E402
from colorvideovdp_tpu_torch.io import writers as wr_t  # noqa: E402
from colorvideovdp_tpu_torch.metrics import dm_preview as dm_t  # noqa: E402
from colorvideovdp_tpu_torch.utils import exr as exr_t  # noqa: E402

import _torch_media as media  # noqa: E402

PREVIEW_EXR_RTOL = {"standard_fhd": 1e-6, "standard_hdr_pq": 1e-4}
PREVIEW_CODE_TOL = 1


def _frames(seed, n=3, h=37, w=54):
    """Float RGB frames in 0..1 with values outside it; odd height."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 3) * 1.1 - 0.05).astype(np.float32)


def _read_y4m(path):
    """(header, list of (Y, U, V) planes) of a 4:2:0 .y4m file."""
    with open(path, "rb") as f:
        data = f.read()
    header, rest = data.split(b"\n", 1)
    tags = dict((t[:1], t[1:]) for t in header.split()[1:])
    W, H = int(tags[b"W"]), int(tags[b"H"])
    dt = np.dtype("<u2") if b"p10" in tags[b"C"] else np.dtype(np.uint8)
    n = (W * H + 2 * (W // 2) * (H // 2)) * dt.itemsize
    planes = []
    while rest:
        assert rest.startswith(b"FRAME\n")
        buf = np.frombuffer(rest[6:6 + n], dt)
        planes.append((buf[:W * H].reshape(H, W), buf[W * H:].reshape(2, H // 2, W // 2)))
        rest = rest[6 + n:]
    return header.decode(), planes


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_y4m_writer_bytes_match_jax(tmp_path, bit_depth):
    frames = _frames(bit_depth)
    for mod, tag in ((wr_j, "j"), (wr_t, "t")):
        with mod.Y4MWriter(str(tmp_path / f"{tag}.y4m"), fps=23.976, bit_depth=bit_depth) as w:
            for fr in frames:
                w.write_frame_rgb(fr)
    with open(tmp_path / "t.y4m", "rb") as f, open(tmp_path / "j.y4m", "rb") as g:
        assert f.read() == g.read()
    header, planes = _read_y4m(tmp_path / "t.y4m")
    assert "W54 H36" in header and len(planes) == 3  # the odd row cropped


@pytest.mark.parametrize("route", ["native", "y4m_name", "hdr", "sdr_cv2", "sdr_no_cv2"])
def test_video_writer_dispatch(tmp_path, monkeypatch, caplog, route):
    """The back end each package picks, and what the port writes: the native
    mp4 where the core is enabled, a 10-bit .y4m for a .y4m name or HDR,
    OpenCV for SDR, and without cv2 an 8-bit .y4m beside the name."""
    native = route == "native"
    if native and not ff_t.enabled():
        pytest.skip("the native codec core is not built")
    for ff in (ff_j, ff_t):
        monkeypatch.setattr(ff, "enabled", lambda native=native: native)
    if route == "sdr_no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    name = "v.y4m" if route == "y4m_name" else "v.mp4"
    hdr = route == "hdr"
    frames = _frames(7, n=4, h=36, w=48)
    paths = {}
    for mod, tag in ((wr_t, "t"), (wr_j, "j")):
        os.makedirs(tmp_path / tag)
        if route == "sdr_no_cv2" and mod is wr_j:
            continue  # the JAX package fails on the import of cv2 here
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            vw = mod.VideoWriter(str(tmp_path / tag / name), fps=24, hdr_mode=hdr)
            for fr in frames:
                vw.write_frame_rgb(fr)
            vw.close()
        paths[tag] = sorted(os.listdir(tmp_path / tag))
        if mod is wr_t:
            warned = any(".y4m" in r.getMessage() for r in caplog.records)
            assert warned == (route in ("hdr", "sdr_no_cv2"))
            written = vw.fname
    expect = {"native": ["v.mp4"], "y4m_name": ["v.y4m"], "hdr": ["v.y4m"],
              "sdr_cv2": ["v.mp4"], "sdr_no_cv2": ["v.y4m"]}[route]
    assert paths["t"] == expect and written == str(tmp_path / "t" / expect[0])
    if "j" in paths:
        assert paths["j"] == paths["t"]
    if route in ("y4m_name", "hdr", "sdr_cv2"):
        with open(tmp_path / "t" / expect[0], "rb") as f, \
                open(tmp_path / "j" / expect[0], "rb") as g:
            assert f.read() == g.read()
    if route == "sdr_no_cv2":
        header, planes = _read_y4m(tmp_path / "t" / "v.y4m")
        assert "C420jpeg" in header and len(planes) == len(frames)
        luma = np.clip(frames.astype(np.float64), 0, 1) @ np.array([0.299, 0.587, 0.114])
        expected = np.round(luma * 219.0 + 16.0)
        got = np.stack([p[0] for p in planes]).astype(np.float64)
        assert np.abs(got - expected).max() <= 1


def test_image_writer_exr_and_np2img_match_jax(tmp_path):
    rgb = _frames(3, n=1, h=33, w=20)
    for mod, tag in ((wr_j, "j"), (wr_t, "t")):
        mod.ImageWriter(str(tmp_path / f"{tag}.exr")).write_frame_rgb(rgb[0])
        mod.np2img(rgb, str(tmp_path / f"{tag}.png"))
        mod.np2img(rgb[..., :1], str(tmp_path / f"{tag}_grey.png"))
    np.testing.assert_array_equal(exr_t.read(str(tmp_path / "t.exr")),
                                  exr_j.read(str(tmp_path / "j.exr")))
    np.testing.assert_array_equal(exr_t.read(str(tmp_path / "t.exr")), rgb[0])
    for stem in ("", "_grey"):
        with open(tmp_path / f"t{stem}.png", "rb") as f, \
                open(tmp_path / f"j{stem}.png", "rb") as g:
            assert f.read() == g.read()


@pytest.fixture(scope="module")
def preview_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("preview_media")
    return {"video": media.write_yuv_pair(str(d), H=32, W=48, N=2, seed=4),
            "image": media.write_png_pair(str(d), H=32, W=48, seed=5)}


@pytest.mark.parametrize("kind", ["video", "image"])
@pytest.mark.parametrize("variant", ["dm_preview", "dm_preview_exr", "dm_preview_sbs",
                                     "dm_preview_exr_sbs"])
def test_dm_preview_matches_jax(preview_files, tmp_path, monkeypatch, kind, variant):
    """Each variant's files, the HDR videos as .y4m in both packages (the
    native core switched off), against the JAX package's."""
    for ff in (ff_j, ff_t):
        monkeypatch.setattr(ff, "enabled", lambda: False)
    display = "standard_hdr_pq" if kind == "video" else "standard_fhd"
    outs = {}
    for tag, mod, kw in (("j", dm_j, {}), ("t", dm_t, dict(device="cpu"))):
        os.makedirs(tmp_path / tag)
        vs = (vsf_j if tag == "j" else ct.video_source_file)(
            *preview_files[kind], display_photometry=display)
        m = getattr(mod, variant)(display_name=display, **kw)
        m.set_base_fname(str(tmp_path / tag / "clip"))
        q, stats = m.predict_video_source(vs)
        assert float(q) == -1 and stats is None
        outs[tag] = sorted(os.listdir(tmp_path / tag))
    assert outs["t"] == outs["j"]
    exr_out = kind == "image" or "exr" in variant
    sbs = "sbs" in variant
    n_files = (1 if sbs else 2) * (2 if kind == "video" and exr_out else 1)
    assert len(outs["t"]) == n_files and all(
        f.endswith(".exr" if exr_out else ".y4m") for f in outs["t"])
    for f in outs["t"]:
        a, b = (str(tmp_path / tag / f) for tag in ("t", "j"))
        if exr_out:
            x, y = exr_t.read(a), exr_t.read(b)
            # Side by side: stacked along the shorter dimension.
            assert x.shape == y.shape == ((64, 48, 3) if sbs else (32, 48, 3))
            np.testing.assert_allclose(x, y, rtol=PREVIEW_EXR_RTOL[display], atol=0)
        else:
            (hx, px), (hy, py) = _read_y4m(a), _read_y4m(b)
            assert hx == hy and len(px) == len(py) == 2
            for (yx, cx), (yy, cy) in zip(px, py):
                assert np.abs(yx.astype(int) - yy.astype(int)).max() <= PREVIEW_CODE_TOL
                assert np.abs(cx.astype(int) - cy.astype(int)).max() <= PREVIEW_CODE_TOL
