"""Video front end: raw frames -> DKL -> four temporal channels, T/R interleaved.

Replaces ``colorvideovdp_tpu/ops/kernels/ingest.py:322`` (``make_ingest_fn``)
in its three modes: "tail" (``ingest``: the fl-1 frames of the metric colour
space carried from the previous block), and the first block's "replicate"
(``ingest_replicate``: frame 0 repeated) and "head" (``ingest_head``: fl-1
raw head frames, the symmetric padding). Kernel: ``csrc/ingest.cu``, the
temporal window in registers at the metric's common filter lengths (fl = 7,
9, 17) and in shared memory otherwise; it converts every
buffer slot to the metric colour space once (DKLd65, or logLMS_DKLd65 for
the log contrast, which the JAX package computes in XLA rather than in its
Pallas kernel), uint8 / uint16 / float16 samples in DKLd65 through a table
of the EOTF of every code value that a small kernel builds first
(``eotf_table_plain`` is its plain version, ``eotf_from_table`` the lookup
in plain PyTorch), and is bound by memory (raw bytes and the carried tail
or the raw head in, the (B, 8, blk, H, W) block and the next tail out). The
kernel and the plain versions (``ingest_plain``, ``ingest_first_plain``,
the same chain in plain PyTorch) take any batch, uint8 / uint16 / float16 /
float32 frames and 3-channel or luminance-only content.
"""

from __future__ import annotations

import numpy as np
import torch

from ...display import vvdp_display_photo_eotf
from .. import colorspace as cs
from ..clip import clip
from ..temporal import apply_temporal_filters
from . import _build

_EOTF_CODES = {"sRGB": 0, "PQ": 1, "linear": 2, "HLG": 3, "gamma": 4}
# Metric colour space -> the kernel's log_lms flag.
_COLORSPACES = {"DKLd65": 0, "logLMS_DKLd65": 1}
# The kernel's PadMode: where the fl-1 slots before the new frames come from.
_TAIL, _REPLICATE, _HEAD = 0, 1, 2
# Source dtype -> the kernel's SrcType (int16 carries uint16 bits).
_SRC_TYPES = {torch.uint8: 0, torch.int16: 1, torch.uint16: 1, torch.float16: 2,
              torch.float32: 3}
# Source dtypes whose samples the kernel looks up in a code-value table, and
# the table's length.
_TABLE_SIZES = {torch.uint8: 256, torch.int16: 65536, torch.uint16: 65536,
                torch.float16: 65536}


def raw_to_float(x: torch.Tensor) -> torch.Tensor:
    """Source dtype ladder -> float32 (true division; int16 carries uint16
    bits, the upload format for uint16 content), in C order: a channel-last
    upload is made planar first, so the plain colour chain after it runs as
    on planar frames."""
    x = x.contiguous()
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    if x.dtype in (torch.int16, torch.uint16):
        return (x.to(torch.int32) & 0xFFFF).to(torch.float32) / 65535.0
    if x.dtype in (torch.float16, torch.float32):
        return x.to(torch.float32)
    raise RuntimeError(f"Unsupported frame dtype {x.dtype}")


def raw_to_met(dm, raw: torch.Tensor, colorspace: str = "DKLd65") -> torch.Tensor:
    """Raw (B, F, C, H, W) frames, planar or channel-last, -> (B, 3, F, H, W)
    in the metric colour space; luminance-only content is broadcast into all
    three channels."""
    I = dm.source_2_target_colorspace(raw_to_float(raw).transpose(1, 2), colorspace)
    if I.shape[1] == 1:
        I = I.expand(-1, 3, -1, -1, -1)
    return I


def interleave_tr(T: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """(B, C, F, H, W) x2 -> (B, 2C, F, H, W), test even / reference odd."""
    B, C = T.shape[:2]
    return torch.stack([T, R], dim=2).reshape((B, 2 * C) + tuple(T.shape[2:]))


def temporal_fir(pads, news, filt):
    """The temporal FIR over [pad, new] per source, pads and new frames
    (B, 3, F, H, W) in the metric colour space; returns (R, next tail_t,
    next tail_r)."""
    outs, tails = [], []
    for pad, new in zip(pads, news):
        buf = torch.cat([pad, new], dim=2)
        outs.append(apply_temporal_filters(buf, filt))
        tails.append(buf[:, :, new.shape[2]:].contiguous())
    return interleave_tr(outs[0], outs[1]), tails[0], tails[1]


def ingest_plain(tail_t, tail_r, raw_t, raw_r, dm, filt, colorspace="DKLd65"):
    """tails (B, 3, fl-1, H, W) DKL; raws (B, blk, C, H, W) source frames.
    Returns (R (B, 8, blk, H, W), next tail_t, next tail_r)."""
    news = [raw_to_met(dm, raw, colorspace) for raw in (raw_t, raw_r)]
    return temporal_fir((tail_t, tail_r), news, filt)


def ingest_first_plain(raw_t, raw_r, dm, filt, colorspace="DKLd65", head_t=None, head_r=None):
    """The first block: its fl-1 padding frames are frame 0 repeated
    ("replicate"), or the raw (B, fl-1, C, H, W) head frames converted as the
    new ones are ("head", when ``head_t`` and ``head_r`` are given). Returns
    what ``ingest_plain`` returns."""
    fl = np.asarray(filt).shape[1]
    news = [raw_to_met(dm, raw, colorspace) for raw in (raw_t, raw_r)]
    if head_t is None:
        pads = [new[:, :, :1].expand(-1, -1, fl - 1, -1, -1) for new in news]
    else:
        pads = [raw_to_met(dm, head, colorspace) for head in (head_t, head_r)]
    return temporal_fir(pads, news, filt)


def _code_index(raw: torch.Tensor) -> torch.Tensor:
    """Each sample's code value, the index of its table entry (float16 by
    its bit pattern)."""
    if raw.dtype == torch.uint8:
        return raw.long()
    if raw.dtype == torch.float16:
        raw = raw.view(torch.int16)
    return raw.to(torch.int64) & 0xFFFF


def eotf_table_plain(dm, dtype) -> torch.Tensor:
    """Plain version of the kernel's code-value table: for every code value
    of ``dtype`` (uint8: 256; uint16, its int16 upload and float16, by bit
    pattern: 65,536), (n,) float32 on the CPU, what the per-channel EOTF of
    ``dm`` gives a sample with that code: the display luminance for sRGB, PQ,
    linear and gamma displays, and for HLG the inverse OETF ``cs.hlg_s``, to
    which the pixel's OOTF is applied after the lookup
    (``eotf_from_table``)."""
    n = _TABLE_SIZES[dtype]
    codes = torch.arange(n, dtype=torch.int64)
    if n == 256:
        raw = codes.to(torch.uint8)
    else:
        raw = codes.to(torch.int32).to(torch.int16)  # uint16 bits
        if dtype == torch.float16:
            raw = raw.view(torch.float16)
    V = raw_to_float(raw)
    if _eotf_name(dm) == "HLG":
        return cs.hlg_s(clip(V, 0.0, 1.0))
    return dm.forward(V)


def eotf_from_table(dm, table: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """The kernel's table route in plain PyTorch: raw (B, F, C, H, W) frames
    -> the display's luminance (B, C, F, H, W), each sample looked up in
    ``table`` (``eotf_table_plain``), then for HLG the pixel's OOTF."""
    L = table.to(raw.device)[_code_index(raw)].transpose(1, 2)
    return dm.hlg_from_s(L) if _eotf_name(dm) == "HLG" else L


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


def _is_channel_last(x: torch.Tensor) -> bool:
    """Whether (B, F, C, H, W) ``x`` lies in memory as a dense (B, F, H, W, C)
    array."""
    B, F, C, H, W = x.shape
    want = (F * H * W * C, H * W * C, 1, W * C, C)
    return all(n == 1 or s == w for n, s, w in zip(x.shape, x.stride(), want))


def _raw_layout(*xs):
    """The kernel's (channel stride, pixel stride) for the (B, F, C, H, W)
    raws (and heads) ``xs``, and the tensors it reads: as they lie where all
    are planar (hw, 1) or all channel-last (1, C), else made contiguous on
    the device."""
    if all(_is_channel_last(x) for x in xs) and not all(x.is_contiguous() for x in xs):
        return (1, xs[0].shape[2]), xs
    H, W = xs[0].shape[3:]
    return (H * W, 1), [x.contiguous() for x in xs]


def _launch(mode, pad_t, pad_r, raw_t, raw_r, dm, filt, colorspace):
    """Check the raws and launch ``cvvdp_ingest`` in ``mode``; the caller has
    checked the pads. Planar and channel-last raws (and raw heads) are read
    where they lie. Returns (R, next tail_t, next tail_r)."""
    if colorspace not in _COLORSPACES or not isinstance(dm, vvdp_display_photo_eotf) \
            or _eotf_name(dm) not in _EOTF_CODES:
        raise ValueError(f"ingest: no kernel for colour space {colorspace} "
                         f"and display {type(dm).__name__} (EOTF {dm.EOTF})")
    if raw_t.dtype not in _SRC_TYPES:
        raise ValueError(f"ingest: unsupported frame dtype {raw_t.dtype}")
    _build.require_cuda("ingest", raw_t, raw_r, dtype=raw_t.dtype, contiguous=False)
    B, blk, C, H, W = raw_t.shape
    fl = filt.shape[1]
    if C not in (1, 3) or tuple(raw_r.shape) != tuple(raw_t.shape) or filt.shape[0] != 4:
        raise ValueError("ingest: shape mismatch between raws and taps")
    if mode == _HEAD:
        (cstride, pstride), (raw_t, raw_r, pad_t, pad_r) = _raw_layout(raw_t, raw_r, pad_t, pad_r)
    else:
        (cstride, pstride), (raw_t, raw_r) = _raw_layout(raw_t, raw_r)
    eotf, consts = _display_consts(dm)
    log_lms = _COLORSPACES[colorspace]
    M = np.ascontiguousarray(dm.rgb2lms() if log_lms else dm.rgb2dkl())
    M2 = np.ascontiguousarray(cs.LMS2006_to_DKLd65, np.float32)
    dev = raw_t.device
    out = torch.empty((B, 8, blk, H, W), dtype=torch.float32, device=dev)
    new_t = torch.empty((B, 3, fl - 1, H, W), dtype=torch.float32, device=dev)
    new_r = torch.empty_like(new_t)
    # The code-value table, built by the kernel's first launch.
    table = (torch.empty(_TABLE_SIZES[raw_t.dtype], dtype=torch.float32, device=dev)
             if raw_t.dtype in _TABLE_SIZES and not log_lms else None)
    lib = _build.library()
    rc = lib.cvvdp_ingest(
        mode, None if pad_t is None else pad_t.data_ptr(),
        None if pad_r is None else pad_r.data_ptr(), raw_t.data_ptr(), raw_r.data_ptr(),
        out.data_ptr(), new_t.data_ptr(), new_r.data_ptr(), B, blk, C, fl, H * W,
        cstride, pstride, _SRC_TYPES[raw_t.dtype], _EOTF_CODES[eotf],
        consts.ctypes.data, M.ctypes.data, log_lms, M2.ctypes.data, filt.ctypes.data,
        None if table is None else table.data_ptr(), _build.stream_handle(dev))
    _build.check_cuda(rc, "cvvdp_ingest")
    return out, new_t, new_r


def ingest(tail_t, tail_r, raw_t, raw_r, dm, filt, colorspace="DKLd65"):
    """Tail mode. CPU tensors take ``ingest_plain``; CUDA tensors launch the
    kernel, or raise where it does not apply."""
    if raw_t.device.type == "cpu":
        return ingest_plain(tail_t, tail_r, raw_t, raw_r, dm, filt, colorspace)
    filt = np.ascontiguousarray(filt, np.float32)
    _build.require_cuda("ingest", tail_t, tail_r)
    B, _, _, H, W = raw_t.shape
    for tail in (tail_t, tail_r):
        if tuple(tail.shape) != (B, 3, filt.shape[1] - 1, H, W):
            raise ValueError("ingest: shape mismatch between raws, tails and taps")
    out = _launch(_TAIL, tail_t, tail_r, raw_t, raw_r, dm, filt, colorspace)
    ingest.launches += 1
    return out


def ingest_replicate(raw_t, raw_r, dm, filt, colorspace="DKLd65"):
    """The first block with replicate padding (frame 0 repeated fl-1 times).
    CPU tensors take ``ingest_first_plain``; CUDA tensors launch the kernel."""
    if raw_t.device.type == "cpu":
        return ingest_first_plain(raw_t, raw_r, dm, filt, colorspace)
    filt = np.ascontiguousarray(filt, np.float32)
    out = _launch(_REPLICATE, None, None, raw_t, raw_r, dm, filt, colorspace)
    ingest_replicate.launches += 1
    return out


def ingest_head(head_t, head_r, raw_t, raw_r, dm, filt, colorspace="DKLd65"):
    """The first block with symmetric padding: ``head_t``/``head_r`` are the
    raw (B, fl-1, C, H, W) head frames in the raws' dtype. CPU tensors take
    ``ingest_first_plain``; CUDA tensors launch the kernel."""
    if raw_t.device.type == "cpu":
        return ingest_first_plain(raw_t, raw_r, dm, filt, colorspace, head_t, head_r)
    filt = np.ascontiguousarray(filt, np.float32)
    _build.require_cuda("ingest", head_t, head_r, dtype=raw_t.dtype, contiguous=False)
    B, _, C, H, W = raw_t.shape
    for head in (head_t, head_r):
        if tuple(head.shape) != (B, filt.shape[1] - 1, C, H, W):
            raise ValueError("ingest: shape mismatch between raws, heads and taps")
    out = _launch(_HEAD, head_t, head_r, raw_t, raw_r, dm, filt, colorspace)
    ingest_head.launches += 1
    return out


ingest.launches = 0
ingest_replicate.launches = 0
ingest_head.launches = 0
