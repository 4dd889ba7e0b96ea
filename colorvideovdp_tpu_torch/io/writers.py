"""Video and image writers (counterpart of ``colorvideovdp_tpu/io/writers.py``).

Host-side numpy, as in the JAX package: the CLI's heatmaps, the channel
dumps and the display-model previews are written frame by frame from host
arrays. The back ends are tried in the JAX package's order: the native codec
core (``io/ffcodec.py``) writes mp4 with the reference's encoder settings
(SDR mpeg4 at qscale 3, HDR 10-bit libx265 with the BT.2020/PQ tags); without
it an HDR video, or any video given a ``.y4m`` name, is written as a
YUV4MPEG2 stream, and an SDR ``.mp4`` goes to OpenCV's encoder (mp4v).

One deviation from the JAX package: where neither the native core nor cv2
imports, an SDR video is written as an 8-bit ``.y4m`` beside the requested
name (with a warning) instead of failing on the import of cv2. With cv2
present the port writes what the JAX package writes.
"""

from __future__ import annotations

import fractions
import logging
import os

import numpy as np


class Y4MWriter:
    """YUV4MPEG2 writer: 10-bit C420p10 (HDR/PQ route) or 8-bit C420.

    Expects display-encoded RGB in 0..1 (PQ + BT.2020 for HDR). The
    limited-range quantisation and the RGB <-> YCbCr matrices are the exact
    inverses of the .yuv reader (``io/yuv.py``), so that a write and a read
    round-trip within one code value.
    """

    def __init__(self, fname, fps=24, bit_depth=10, color_space="2020", verbose=False):
        from .yuv import _YCBCR2RGB

        self.fname = fname
        self.fps = fps
        self.bit_depth = int(bit_depth)
        self.color_space = color_space
        self.verbose = verbose
        self._M = np.linalg.inv(_YCBCR2RGB[color_space]).astype(np.float64)
        self._f = None

    def _open(self, H, W):
        fr = fractions.Fraction(self.fps).limit_denominator(65535)
        ctag = "C420p10 XCOLORRANGE=LIMITED" if self.bit_depth == 10 else "C420jpeg"
        self._f = open(self.fname, "wb")
        self._f.write(f"YUV4MPEG2 W{W} H{H} F{fr.numerator}:{fr.denominator} "
                      f"Ip A1:1 {ctag}\n".encode())

    def write_frame_rgb(self, rgb):
        rgb = np.asarray(rgb, np.float64)
        H, W = rgb.shape[0], rgb.shape[1]
        if rgb.ndim == 2 or rgb.shape[2] == 1:
            rgb = np.repeat(rgb.reshape(H, W, 1), 3, axis=2)
        if H % 2 or W % 2:  # 4:2:0 needs even dimensions: crop one row/column
            H, W = H - H % 2, W - W % 2
            rgb = rgb[:H, :W]
        if self._f is None:
            self._open(H, W)
        ycbcr = np.einsum("hwc,dc->hwd", np.clip(rgb, 0.0, 1.0), self._M)
        # The chroma planes: the mean of each 2x2 block.
        u = ycbcr[:, :, 1].reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
        v = ycbcr[:, :, 2].reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
        d = 2.0 ** (self.bit_depth - 8)
        maxc = 2 ** self.bit_depth - 1
        Yq = np.clip((ycbcr[:, :, 0] * 219.0 + 16.0) * d + 0.5, 0, maxc)
        uq = np.clip((u * 224.0 + 128.0) * d + 0.5, 0, maxc)
        vq = np.clip((v * 224.0 + 128.0) * d + 0.5, 0, maxc)
        dt = "<u2" if self.bit_depth > 8 else np.uint8
        self._f.write(b"FRAME\n")
        self._f.write(Yq.astype(dt).tobytes())
        self._f.write(uq.astype(dt).tobytes())
        self._f.write(vq.astype(dt).tobytes())

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()


class NativeMp4Writer:
    """HDR/SDR mp4 writer through the native codec core (``io/ffcodec.py``).

    HDR: 10-bit libx265 main10 at crf 12 with the BT.2020/PQ stream tags.
    SDR: mpeg4 at qscale 3. The RGB -> YCbCr matrix, the limited-range
    quantisation and the 2x2 chroma mean run in numpy."""

    def __init__(self, fname, fps=24, hdr_mode=False, codec="h265", verbose=False):
        from .ffcodec import rgb_to_ycbcr_coeffs

        self.fname = fname
        self.fps = fps
        self.hdr_mode = hdr_mode
        self.codec = codec
        self._w = None
        self._coeffs = rgb_to_ycbcr_coeffs("2020" if hdr_mode else "601")

    def _open(self, H, W):
        from .ffcodec import CodecVideoWriter

        if self.hdr_mode:
            enc = {"h265": "libx265", "vp9": "libvpx-vp9"}.get(self.codec)
            if enc is None:
                raise RuntimeError(f"Unknown codec {self.codec}")
            self._w = CodecVideoWriter(self.fname, W, H, self.fps, bit_depth=10, codec=enc,
                                       crf=12.0, hdr_tags=True)
        else:
            self._w = CodecVideoWriter(self.fname, W, H, self.fps, bit_depth=8, codec="mpeg4",
                                       crf=3.0)

    def write_frame_rgb(self, rgb):
        rgb = np.asarray(rgb)
        if rgb.dtype == np.uint8:  # before the float cast, or 0..255 clips
            rgb = rgb.astype(np.float64) / 255.0
        else:
            rgb = rgb.astype(np.float64)
        H, W = rgb.shape[0], rgb.shape[1]
        if rgb.ndim == 2 or rgb.shape[2] == 1:
            rgb = np.repeat(rgb.reshape(H, W, 1), 3, axis=2)
        if H % 2 or W % 2:  # 4:2:0 needs even dimensions: crop one row/column
            H, W = H - H % 2, W - W % 2
            rgb = rgb[:H, :W]
        if self._w is None:
            self._open(H, W)
        rgb = np.clip(rgb, 0.0, 1.0)
        luma, cb, cr = self._coeffs
        Y = rgb @ luma
        u = (rgb @ cb).reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
        v = (rgb @ cr).reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
        bd = self._w.bit_depth
        d = 2.0 ** (bd - 8)
        maxc = 2 ** bd - 1
        dt = "<u2" if bd > 8 else np.uint8
        self._w.write_frame_yuv(
            np.clip((Y * 219.0 + 16.0) * d + 0.5, 0, maxc).astype(dt),
            np.clip((u * 224.0 + 128.0) * d + 0.5, 0, maxc).astype(dt),
            np.clip((v * 224.0 + 128.0) * d + 0.5, 0, maxc).astype(dt))

    def close(self):
        if self._w is not None:
            self._w.close()
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()


def _y4m_name(fname):
    return fname if fname.lower().endswith(".y4m") else os.path.splitext(fname)[0] + ".y4m"


class VideoWriter:
    """Frame-push video writer. The native codec core writes real mp4 for SDR
    and HDR; otherwise HDR (or a ``.y4m`` name) goes to a 10-bit ``.y4m``
    beside the requested name, SDR to OpenCV's mp4 writer, and, where cv2
    does not import either, to an 8-bit ``.y4m`` beside the requested name.
    ``self.fname`` is the name of the file written."""

    def __init__(self, fname, fps=24, hdr_mode=False, codec="h265", verbose=False):
        from . import ffcodec

        self.fname = fname
        self.fps = fps
        self.verbose = verbose
        self.hdr_mode = hdr_mode
        self.codec = codec
        self.writer = None
        self._y4m = None
        self._native = None
        is_y4m = fname.lower().endswith(".y4m")
        if ffcodec.enabled() and not is_y4m:
            self._native = NativeMp4Writer(fname, fps=fps, hdr_mode=hdr_mode, codec=codec,
                                           verbose=verbose)
            return
        if hdr_mode or is_y4m:
            self.fname = _y4m_name(fname)
            if self.fname != fname:
                logging.warning(
                    "No 10-bit HDR mp4 encoder in this environment; writing uncompressed "
                    f"10-bit PQ {self.fname} instead (transcode with: ffmpeg -i in.y4m -c:v "
                    "libx265 -pix_fmt yuv420p10 -x265-params "
                    "colorprim=bt2020:transfer=smpte2084 out.mp4)")
            self._y4m = Y4MWriter(self.fname, fps=fps, bit_depth=10, color_space="2020",
                                  verbose=verbose)
            return
        try:
            import cv2  # noqa: F401
        except ImportError:
            self.fname = _y4m_name(fname)
            logging.warning(
                f"No mp4 encoder in this environment (neither the native codec core nor "
                f"OpenCV); writing uncompressed 8-bit {self.fname} instead (transcode with: "
                "ffmpeg -i in.y4m -c:v libx264 out.mp4)")
            self._y4m = Y4MWriter(self.fname, fps=fps, bit_depth=8, color_space="709",
                                  verbose=verbose)

    def write_frame_rgb(self, rgb):
        """rgb: (H, W, C) float 0..1 (uint8 accepted for SDR), display-encoded:
        BT.709 + sRGB for SDR, BT.2020 + PQ for HDR."""
        if self._native is not None:
            self._native.write_frame_rgb(rgb)
            return
        if self._y4m is not None:
            rgb = np.asarray(rgb)
            if rgb.dtype == np.uint8:
                rgb = rgb.astype(np.float32) / 255.0
            self._y4m.write_frame_rgb(rgb)
            return
        import cv2

        H, W = rgb.shape[0], rgb.shape[1]
        if rgb.ndim == 2 or rgb.shape[2] == 1:
            rgb = np.repeat(rgb.reshape(H, W, 1), 3, axis=2)
        if self.writer is None:
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self.writer = cv2.VideoWriter(self.fname, fourcc, self.fps, (W, H))
            if not self.writer.isOpened():
                raise RuntimeError(f"Cannot open video writer for {self.fname}")
        if rgb.dtype == np.uint8:
            frame8 = rgb
        else:
            frame8 = (np.clip(rgb, 0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        self.writer.write(frame8[:, :, ::-1])  # RGB -> BGR

    def close(self):
        if self._native is not None:
            self._native.close()
        if self._y4m is not None:
            self._y4m.close()
        if self.writer is not None:
            self.writer.release()
            self.writer = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()


class ImageWriter:
    """Single-image writer: ``.exr`` through ``utils/exr.py``, anything else
    through imageio."""

    def __init__(self, fname, verbose=False):
        self.fname = fname
        self.verbose = verbose

    def write_frame_rgb(self, rgb):
        if os.path.splitext(self.fname)[1].lower() == ".exr":
            from ..utils import exr

            exr.write(self.fname, np.asarray(rgb, np.float32))
            return
        import imageio.v2 as iio

        iio.imwrite(self.fname, rgb)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, type, value, tb):
        self.close()


def np2vid(np_srgb, vidfile, fps, verbose=False):
    """(N, H, W, C) float sRGB frames -> a video file; returns the name of the
    file written (``VideoWriter.fname``)."""
    vw = VideoWriter(vidfile, fps=fps, verbose=verbose)
    for fid in range(np_srgb.shape[0]):
        vw.write_frame_rgb(np_srgb[fid])
    vw.close()
    return vw.fname


def np2img(np_srgb, imgfile):
    """(1, H, W, C) float sRGB -> an 8-bit image file."""
    import imageio.v2 as iio

    N, H, W, C = np_srgb.shape
    if C == 1:
        np_srgb = np.concatenate([np_srgb] * 3, -1)
    if N > 1:
        raise RuntimeError("Expecting an image, found video")
    iio.imwrite(imgfile, (np.clip(np_srgb, 0.0, 1.0)[0] * 255.0).astype(np.uint8))
