"""Video front end: raw frames -> DKL -> four temporal channels, T/R interleaved.

Replaces ``colorvideovdp_tpu/ops/kernels/ingest.py:322`` (``make_ingest_fn``
in "tail" mode). Kernel: ``csrc/ingest.cu``, one thread per pixel and
source and batch item; it converts every buffer slot to the metric colour
space once (DKLd65, or logLMS_DKLd65 for the log contrast, which the JAX
package computes in XLA rather than in its Pallas kernel) and is
bound by memory (raw bytes and the carried tail in, the (B, 8, blk, H, W)
block and the next tail out). Both the kernel and ``ingest_plain``, the same
chain in plain PyTorch, take any batch, uint8 / uint16 / float16 / float32
frames and 3-channel or luminance-only content.
"""

from __future__ import annotations

import numpy as np
import torch

from ...display import vvdp_display_photo_eotf
from .. import colorspace as cs
from ..temporal import apply_temporal_filters
from . import _build

_EOTF_CODES = {"sRGB": 0, "PQ": 1, "linear": 2, "HLG": 3, "gamma": 4}
# Metric colour space -> the kernel's log_lms flag.
_COLORSPACES = {"DKLd65": 0, "logLMS_DKLd65": 1}
# Source dtype -> the kernel's SrcType (int16 carries uint16 bits).
_SRC_TYPES = {torch.uint8: 0, torch.int16: 1, torch.uint16: 1, torch.float16: 2,
              torch.float32: 3}


def raw_to_float(x: torch.Tensor) -> torch.Tensor:
    """Source dtype ladder -> float32 (true division; int16 carries uint16
    bits, the upload format for uint16 content)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    if x.dtype in (torch.int16, torch.uint16):
        return (x.to(torch.int32) & 0xFFFF).to(torch.float32) / 65535.0
    if x.dtype in (torch.float16, torch.float32):
        return x.to(torch.float32)
    raise RuntimeError(f"Unsupported frame dtype {x.dtype}")


def raw_to_met(dm, raw: torch.Tensor, colorspace: str = "DKLd65") -> torch.Tensor:
    """Raw (B, F, C, H, W) frames -> (B, 3, F, H, W) in the metric colour
    space; luminance-only content is broadcast into all three channels."""
    I = dm.source_2_target_colorspace(raw_to_float(raw).transpose(1, 2), colorspace)
    if I.shape[1] == 1:
        I = I.expand(-1, 3, -1, -1, -1)
    return I


def interleave_tr(T: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) x2 -> (B, 2C, F, H, W), test even / reference odd."""
    B, C = T.shape[:2]
    return torch.stack([T, R], dim=2).reshape((B, 2 * C) + tuple(T.shape[2:]))


def ingest_plain(tail_t, tail_r, raw_t, raw_r, dm, filt, colorspace="DKLd65"):
    """tails (B, 3, fl-1, H, W) DKL; raws (B, blk, C, H, W) source frames.
    Returns (R (B, 8, blk, H, W), next tail_t, next tail_r)."""
    outs, tails = [], []
    for tail, raw in ((tail_t, raw_t), (tail_r, raw_r)):
        new = raw_to_met(dm, raw, colorspace)
        buf = torch.cat([tail, new], dim=2)
        outs.append(apply_temporal_filters(buf, filt))
        tails.append(buf[:, :, new.shape[2]:].contiguous())
    return interleave_tr(outs[0], outs[1]), tails[0], tails[1]


def _eotf_name(dm):
    eotf = dm.EOTF
    if eotf not in _EOTF_CODES and eotf[0].isnumeric():
        return "gamma"
    return eotf


def _display_consts(dm):
    """The kernel's display constants, each rounded once from the host's
    double value (the plain version rounds its Python scalars the same way)."""
    Y_black, Y_refl = dm.get_black_level()
    eotf = _eotf_name(dm)
    gamma = float(dm.EOTF) if eotf == "gamma" else 0.0
    hlg_gamma = dm.hlg_gamma() if eotf == "HLG" else 1.2
    return eotf, np.array([dm.Y_peak - Y_black, Y_black, Y_refl, dm.exposure, dm.Y_peak,
                           max(0.005, Y_black), gamma, hlg_gamma - 1.0, cs.HLG_B, cs.HLG_C],
                          np.float32)


def ingest(tail_t, tail_r, raw_t, raw_r, dm, filt, colorspace="DKLd65"):
    """CPU tensors take ``ingest_plain``; CUDA tensors launch the kernel, or
    raise where it does not apply."""
    if raw_t.device.type == "cpu":
        return ingest_plain(tail_t, tail_r, raw_t, raw_r, dm, filt, colorspace)
    if colorspace not in _COLORSPACES or not isinstance(dm, vvdp_display_photo_eotf) \
            or _eotf_name(dm) not in _EOTF_CODES:
        raise ValueError(f"ingest: no kernel for colour space {colorspace} "
                         f"and display {type(dm).__name__} (EOTF {dm.EOTF})")
    if raw_t.dtype not in _SRC_TYPES:
        raise ValueError(f"ingest: unsupported frame dtype {raw_t.dtype}")
    _build.require_cuda("ingest", raw_t, raw_r, dtype=raw_t.dtype)
    _build.require_cuda("ingest", tail_t, tail_r)
    B, blk, C, H, W = raw_t.shape
    filt = np.ascontiguousarray(filt, np.float32)
    fl = filt.shape[1]
    if C not in (1, 3) or tuple(raw_r.shape) != tuple(raw_t.shape) \
            or tuple(tail_t.shape) != (B, 3, fl - 1, H, W) \
            or tuple(tail_r.shape) != (B, 3, fl - 1, H, W) or filt.shape[0] != 4:
        raise ValueError("ingest: shape mismatch between raws, tails and taps")
    eotf, consts = _display_consts(dm)
    log_lms = _COLORSPACES[colorspace]
    M = np.ascontiguousarray(dm.rgb2lms() if log_lms else dm.rgb2dkl())
    M2 = np.ascontiguousarray(cs.LMS2006_to_DKLd65, np.float32)
    dev = raw_t.device
    out = torch.empty((B, 8, blk, H, W), dtype=torch.float32, device=dev)
    new_t = torch.empty_like(tail_t)
    new_r = torch.empty_like(tail_r)
    lib = _build.library()
    rc = lib.cvvdp_ingest(
        tail_t.data_ptr(), tail_r.data_ptr(), raw_t.data_ptr(), raw_r.data_ptr(),
        out.data_ptr(), new_t.data_ptr(), new_r.data_ptr(), B, blk, C, fl, H * W,
        _SRC_TYPES[raw_t.dtype], _EOTF_CODES[eotf],
        consts.ctypes.data, M.ctypes.data, log_lms, M2.ctypes.data, filt.ctypes.data,
        _build.stream_handle(dev))
    _build.check_cuda(rc, "cvvdp_ingest")
    ingest.launches += 1
    return out, new_t, new_r


ingest.launches = 0

