"""ctypes loader for the native IO helper library (``native/cvvdp_io.cpp``,
built by ``make -C native``), the counterpart of the JAX package's
``utils/native.py``. Every call site falls back to numpy when the shared
library has not been built."""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_SEARCHED = False


def _find_lib():
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for c in (os.path.join(repo, "native", "libcvvdp_io.so"), "libcvvdp_io.so"):
        try:
            lib = ctypes.CDLL(c)
        except OSError:
            continue
        lib.exr_zip_compress.restype = ctypes.c_long
        lib.exr_zip_compress.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                         ctypes.c_long]
        lib.exr_zip_decompress.restype = ctypes.c_int
        lib.exr_zip_decompress.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                                           ctypes.c_long]
        lib.pack_frame_block.restype = None
        lib.pack_frame_block.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                         ctypes.c_long, ctypes.c_long, ctypes.c_void_p]
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def exr_zip_compress(data: bytes) -> bytes | None:
    """Native EXR-zip transform + deflate; None if the library is absent. The
    data come back as they were where compression would not shrink them."""
    lib = _find_lib()
    if lib is None:
        return None
    n = len(data)
    cap = n + n // 100 + 64
    dst = ctypes.create_string_buffer(cap)
    r = lib.exr_zip_compress(data, n, dst, cap)
    if r < 0:
        raise RuntimeError("native exr_zip_compress failed")
    if r == 0:
        return data
    return dst.raw[:r]


def exr_zip_decompress(data: bytes, expected: int) -> bytes | None:
    lib = _find_lib()
    if lib is None:
        return None
    if len(data) == expected:
        return data
    dst = ctypes.create_string_buffer(expected)
    if lib.exr_zip_decompress(data, len(data), dst, expected) != 0:
        raise RuntimeError("native exr_zip_decompress failed")
    return dst.raw


def pack_frame_block(src: np.ndarray, start: int, count: int) -> np.ndarray | None:
    """Frames [start, start+count) of a contiguous (n, frame_pixels)
    uint8/uint16 array, the tail padded with the last frame; None if the
    library is absent."""
    lib = _find_lib()
    if lib is None:
        return None
    if not src.flags["C_CONTIGUOUS"]:
        raise ValueError("pack_frame_block needs a C-contiguous source")
    out = np.empty((count,) + src.shape[1:], src.dtype)
    lib.pack_frame_block(src.ctypes.data_as(ctypes.c_void_p), src.strides[0], src.shape[0],
                         start, count, out.ctypes.data_as(ctypes.c_void_p))
    return out
