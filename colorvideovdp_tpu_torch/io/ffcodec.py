"""Native video decode/encode via the system FFmpeg libraries.

Counterpart of the JAX package's ``io/ffcodec.py``, on the same shared
library, ``native/libcvvdp_codec.so`` (``native/cvvdp_codec.cpp``, loaded
with ctypes): it demuxes and decodes video files in-process and hands back
native-depth planar YUV blocks. The fixed-point -> float conversion, chroma
upsample and YCbCr->RGB matrix run on the metric's device
(``io/yuv.py`` ``unpack_planar``), at float32.

``available()`` is False where the shared library or the system FFmpeg is
absent, and callers use the OpenCV reader (8-bit ceiling) instead;
``enabled()`` is also False under ``CVVDP_NO_NATIVE_DECODE``.
"""

from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

_LIB = None
_SEARCHED = False

# AVColorSpace / AVColorTransferCharacteristic values we care about
# (libavutil/pixfmt.h).
_AVCOL_SPC = {
    1: "709", 5: "601", 6: "601", 9: "2020", 10: "2020",
}
_AVCOL_RANGE_FULL = 2
_AVCOL_PRI_BT2020 = 9


def _find_lib():
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    candidates = [
        os.path.join(here, "native", "libcvvdp_codec.so"),
        "libcvvdp_codec.so",
    ]
    for c in candidates:
        try:
            lib = ctypes.CDLL(c)
        except OSError:
            continue
        lib.vdec_open.restype = ctypes.c_void_p
        lib.vdec_open.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.vdec_next.restype = ctypes.c_int
        lib.vdec_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.vdec_rewind.restype = ctypes.c_int
        lib.vdec_rewind.argtypes = [ctypes.c_void_p]
        lib.vdec_close.argtypes = [ctypes.c_void_p]
        lib.venc_open.restype = ctypes.c_void_p
        lib.venc_open.argtypes = (
            [ctypes.c_char_p] + [ctypes.c_int] * 6
            + [ctypes.c_char_p, ctypes.c_double, ctypes.c_int]
        )
        lib.venc_write.restype = ctypes.c_int
        lib.venc_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.venc_close.restype = ctypes.c_int
        lib.venc_close.argtypes = [ctypes.c_void_p]
        lib.vcodec_last_error.restype = ctypes.c_char_p
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    """True when the native codec library is loadable."""
    return _find_lib() is not None


def enabled() -> bool:
    """Native codec available AND not disabled via the env kill-switch
    (single gate for all dispatch sites)."""
    return available() and not os.environ.get("CVVDP_NO_NATIVE_DECODE")


def _last_error() -> str:
    lib = _find_lib()
    return lib.vcodec_last_error().decode() if lib else "library not loaded"


class CodecVideoReader:
    """Sequential planar-YUV video reader (YUVReader-compatible surface:
    width/height/bit_depth/chroma_ss/avg_fps/frames + get_packed_frames)."""

    def __init__(self, file_name: str, frames: int = -1):
        lib = _find_lib()
        if lib is None:
            raise RuntimeError("native codec library not available")
        if not os.path.isfile(file_name):
            raise FileNotFoundError(f"File {file_name} not found")
        self.file_name = file_name
        info = (ctypes.c_int64 * 12)()
        self._h = lib.vdec_open(file_name.encode(), info)
        if not self._h:
            raise RuntimeError(
                f"cannot open '{file_name}': {_last_error()}"
            )
        self._lib = lib
        self.width = int(info[0])
        self.height = int(info[1])
        self.bit_depth = int(info[2])
        self.chroma_ss = str(int(info[3]))
        self.avg_fps = (float(info[4]) / float(info[5])) if info[5] else 0.0
        meta_frames = int(info[6])
        self.color_range_full = int(info[8]) == _AVCOL_RANGE_FULL
        self.color_trc = int(info[9])
        spc, pri = int(info[7]), int(info[10])
        if spc in _AVCOL_SPC:
            # Explicit stream tags are honoured with their true matrices
            # (the reference's default reader only distinguishes bt2020nc
            # vs everything-else-709, video_source_file.py:268-277; using
            # the real 601 matrix for 601-tagged content is a deliberate
            # correctness improvement on rare content).
            self.color_space = _AVCOL_SPC[spc]
        elif pri == _AVCOL_PRI_BT2020:
            self.color_space = "2020"
        else:
            # Untagged: BT.709 — the reference's DEFAULT mp4 route (raw-YUV
            # ffmpeg pipe + torch-side conversion) applies the 709 matrix
            # to every non-bt2020 stream regardless of tags or size
            # (video_source_file.py:268-277). (Its non-default --ffmpeg-cc
            # rgb24 pipe would say 601; the two reference paths disagree —
            # the default is followed.)
            self.color_space = "709"
        self.frame_bytes = int(info[11])
        self.dtype = np.uint16 if self.bit_depth > 8 else np.uint8
        self.frame_pixels = self.frame_bytes // self.dtype().itemsize

        self.y_pixels = self.width * self.height
        self.y_shape = (self.height, self.width)
        # Chroma dims round UP for odd luma sizes (AVFrame semantics; the
        # C core's plane layout matches).
        if self.chroma_ss == "444":
            self.uv_shape = self.y_shape
        elif self.chroma_ss == "422":
            self.uv_shape = (self.height, (self.width + 1) // 2)
        else:
            self.uv_shape = ((self.height + 1) // 2, (self.width + 1) // 2)
        self.uv_pixels = self.uv_shape[0] * self.uv_shape[1]

        self._next = 0  # index the next vdec_next call returns
        self._last = None  # most recent decoded frame (tail repeat)
        self._eof = False  # end-of-stream or latched decode error
        self._scratch = np.empty(self.frame_pixels, self.dtype)
        if meta_frames <= 0 or frames == -2:
            meta_frames = self._count_frames()
        self.frames = meta_frames if frames in (-1, -2) else min(
            frames, meta_frames)

    def _count_frames(self) -> int:
        n = 0
        while self._decode_into(self._scratch):
            n += 1
        self._next = 0
        self._rewind()
        return n

    def _rewind(self):
        if self._lib.vdec_rewind(self._h) != 0:
            raise RuntimeError(f"rewind failed: {_last_error()}")
        self._next = 0
        self._eof = False  # the stream is seekable; early frames decode

    def _decode_into(self, arr: np.ndarray) -> bool:
        """Decode the next frame DIRECTLY into ``arr`` (a contiguous
        frame_pixels-sized view) — the C core memcpys plane rows straight
        into the caller's block, no intermediate staging buffer.

        Mid-stream decode/demux errors (truncated or damaged files) degrade
        to end-of-stream with ONE warning: the error latches as EOF (no
        further native calls until a rewind) and callers repeat the last
        good frame, exactly how the reference behaves when its ffmpeg pipe
        dies mid-clip (short pipe read -> get_frame None -> repeat).
        """
        if self._eof:
            return False
        r = self._lib.vdec_next(
            self._h, arr.ctypes.data_as(ctypes.c_void_p))
        if r < 0:
            logger.warning(
                f"decode error in '{self.file_name}' at frame "
                f"{self._next} ({_last_error()}); treating as end of "
                "stream — remaining frames repeat the last good one"
            )
            self._eof = True
            return False
        if r == 0:
            self._eof = True
            return False
        self._next += 1
        return True

    def get_frame_count(self) -> int:
        return self.frames

    def seek_to_start(self):
        self._rewind()

    def get_packed_frames(self, start: int, count: int) -> np.ndarray:
        """Packed planar frames (count, frame_pixels); indices past the end
        repeat the last frame (same contract as YUVReader). Frames decode
        zero-copy into the returned block."""
        if start < self._next - 1 or (start == self._next - 1
                                      and self._last is None):
            self._rewind()
        out = np.empty((count, self.frame_pixels), self.dtype)
        for i in range(count):
            idx = start + i
            if idx < self.frames:
                while self._next < idx:  # discard frames we skip over
                    if not self._decode_into(self._scratch):
                        break  # container shorter than metadata claimed
                    self._last = self._scratch
                if idx == self._next - 1 and self._last is not None:
                    out[i] = self._last  # re-serve of the previous frame
                    continue
                if self._next == idx and self._decode_into(out[i]):
                    self._last = out[i]
                    continue
            out[i] = self._last if self._last is not None else 0
        return out

    def unload(self):
        if self._h:
            self._lib.vdec_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.unload()
        except Exception:
            pass


class CodecVideoWriter:
    """Planar-YUV video encoder (libx265/libx264/mpeg4/libvpx-vp9).

    ``crf < 0`` selects lossless mode; ``hdr_tags`` writes the BT.2020 / PQ
    stream metadata and x265 HDR parameter block the reference writer uses
    (reference: pycvvdp/video_writer.py:32-43).
    """

    def __init__(self, fname: str, width: int, height: int, fps: float,
                 bit_depth: int = 8, chroma: int = 420,
                 codec: str = "libx264", crf: float = -1.0,
                 hdr_tags: bool = False):
        lib = _find_lib()
        if lib is None:
            raise RuntimeError("native codec library not available")
        fps_num, fps_den = _fps_to_rational(fps)
        self._lib = lib
        self.width, self.height = width, height
        self.bit_depth, self.chroma = bit_depth, chroma
        self._h = lib.venc_open(fname.encode(), width, height, fps_num,
                                fps_den, bit_depth, chroma, codec.encode(),
                                float(crf), int(bool(hdr_tags)))
        if not self._h:
            raise RuntimeError(f"cannot open encoder: {_last_error()}")

    def write_frame_yuv(self, y: np.ndarray, u: np.ndarray, v: np.ndarray):
        dt = np.dtype("<u2") if self.bit_depth > 8 else np.dtype(np.uint8)
        buf = np.concatenate([
            np.ascontiguousarray(y, dt).ravel(),
            np.ascontiguousarray(u, dt).ravel(),
            np.ascontiguousarray(v, dt).ravel(),
        ]).tobytes()
        if self._lib.venc_write(self._h, buf) != 0:
            raise RuntimeError(f"encode failed: {_last_error()}")

    def close(self):
        if self._h:
            rc = self._lib.venc_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError(f"finalize failed: {_last_error()}")

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def _fps_to_rational(fps: float):
    if abs(fps - round(fps)) < 1e-6:
        return int(round(fps)), 1
    # NTSC-style rates (29.97 = 30000/1001 etc.)
    if abs(fps * 1001 / 1000 - round(fps * 1001 / 1000)) < 1e-3:
        return int(round(fps * 1001 / 1000)) * 1000, 1001
    return int(round(fps * 1000)), 1000


# Exact coefficients for each matrix (Kr, Kb); the RGB reconstruction is
# derived in float64 (R = Y + 2(1-Kr)V etc.) instead of hard-coding the
# rounded constants. NOTE: the .yuv path keeps the reference's quirky "709"
# matrix (1.402/1.772 — actually BT.601 coefficients,
# video_source_yuv.py:162-171) for parity; decoded *files* carry real
# colour metadata, so this path uses the true matrices — matching what
# ffmpeg's own yuv->rgb conversion does for the reference tool.
_KR_KB = {
    "601": (0.299, 0.114),
    "709": (0.2126, 0.0722),
    "2020": (0.2627, 0.0593),
}


def ycbcr_to_rgb_matrix(color_space: str) -> np.ndarray:
    kr, kb = _KR_KB[color_space]
    kg = 1.0 - kr - kb
    return np.array([
        [1.0, 0.0, 2.0 * (1.0 - kr)],
        [1.0, -2.0 * kb * (1.0 - kb) / kg, -2.0 * kr * (1.0 - kr) / kg],
        [1.0, 2.0 * (1.0 - kb), 0.0],
    ], np.float32)


def rgb_to_ycbcr_coeffs(color_space: str):
    """(luma_row, cb_row, cr_row) of the RGB->YCbCr analysis matrix."""
    kr, kb = _KR_KB[color_space]
    kg = 1.0 - kr - kb
    luma = np.array([kr, kg, kb], np.float64)
    cb = (np.array([0.0, 0.0, 1.0]) - luma) / (2.0 * (1.0 - kb))
    cr = (np.array([1.0, 0.0, 0.0]) - luma) / (2.0 * (1.0 - kr))
    return luma, cb, cr
