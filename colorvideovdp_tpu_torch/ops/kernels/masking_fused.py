"""Band masking: CSF + Weber contrast + mutual masking + pooled score.

Replaces three TPU kernels: ``colorvideovdp_tpu/ops/kernels/masking_fused.py``
``fused_csf_contrast_raw`` (:440) and ``fused_blur_transducer`` (:352), run
per wide band, and ``band_stack.py`` ``make_band_stack`` (:253), which takes
all narrow bands in one launch. Here one kernel takes any 1..8 bands. Kernel: ``csrc/band_masking.cu`` (stage A
elementwise contrast + LUT, stage B tiled blur + transducer + tile sums,
stage C fixed-order reduction); it is bound by memory. ``band_groups`` picks
which bands share a launch. The inputs of a band
are the raw Gaussian level ``gi`` and the expanded next level ``E``, both
(B, 2C, F, h, w) with test/reference channels interleaved; the result is
sum(safe_pow(D, beta)) over each image plane, (n_bands, B, C, F).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..blur import gaussian_kernel1d
from ..masking import (_EPS, MaskingParams, _pow_static, _safe_pow_static,
                       apply_masking_model)
from . import _build
from .csf_lut import csf_lut_plain

MAX_BANDS = 8
# Consecutive interior bands share one launch while the memory the launch
# holds stays within this budget: per band the expanded next level E (2C
# planes) and the kernel's M_pre and diff scratch (C planes each), float32.
# Small bands then share a launch (their time is launch latency), and a band
# whose share alone exceeds the budget runs by itself.
GROUP_BYTES = 1 << 28
# Frames per plain-version chunk are chosen so that one chunk holds at most
# this many pixels per channel: bounds the plain version's temporaries.
_PLAIN_CHUNK_PIXELS = 1 << 24


@dataclass(frozen=True)
class BandConsts:
    """The constants every band of one metric shares."""

    x0: float
    x1: float
    sens_corr: float
    gains: np.ndarray  # (C,) channel gain x sensitivity correction
    ref_only: bool
    qs: np.ndarray  # (C,)
    p: float
    xcm: np.ndarray  # (C, C), [c, d]
    max_v: float
    blur_scale: float
    taps: np.ndarray
    beta: float
    params: MaskingParams

    @classmethod
    def make(cls, params: MaskingParams, C: int, x0: float, x1: float, sens_corr: float,
             ref_only: bool, beta: float):
        params.check_supported()
        gains = np.array([1.0, 1.45, 1.0, 1.0], np.float32)[:C] * np.float32(sens_corr)
        return cls(
            x0=float(x0), x1=float(x1), sens_corr=float(sens_corr),
            gains=gains.astype(np.float32), ref_only=bool(ref_only),
            qs=np.asarray(params.mask_q, np.float32)[:C].copy(), p=float(params.mask_p),
            xcm=params.xcm(C), max_v=float(10.0 ** float(params.d_max)),
            blur_scale=float(10.0 ** params.mask_c),
            taps=gaussian_kernel1d(params.pu_kernel_size, params.pu_dilate).astype(np.float32),
            beta=float(beta), params=params,
        )


def _band_sums_plain(gi, E, lut, mul, k: BandConsts) -> torch.Tensor:
    """Weber contrast and CSF of one band as the JAX package's decompose +
    get_band + CSF chain forms them, then ``masking.apply_masking_model``."""
    lb_r = torch.clamp(E[:, 1:2], min=0.01)
    lb_t = lb_r if k.ref_only else torch.clamp(E[:, 0:1], min=0.01)
    T = torch.clamp((gi[:, 0::2] - E[:, 0::2]) / lb_t, max=1000.0) * mul
    R = torch.clamp((gi[:, 1::2] - E[:, 1::2]) / lb_r, max=1000.0) * mul
    S = csf_lut_plain(torch.log10(lb_r[:, 0]), lut, k.x0, k.x1).movedim(0, 1) * k.sens_corr
    D = apply_masking_model(T, R, S, k.params)
    return torch.sum(_pow_static(D + _EPS, k.beta) - _EPS ** k.beta, dim=(-2, -1))


def band_masking_plain(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts):
    """Plain PyTorch version: returns (n_bands, B, C, F) pooled sums."""
    outs = []
    for i, (gi, E) in enumerate(zip(gi_list, E_list)):
        B, C2, F, h, w = gi.shape
        fc = max(1, _PLAIN_CHUNK_PIXELS // (B * h * w))
        parts = [_band_sums_plain(gi[:, :, f0:f0 + fc], E[:, :, f0:f0 + fc], luts[i],
                                  muls[i], k)
                 for f0 in range(0, F, fc)]
        outs.append(torch.cat(parts, dim=2))
    return torch.stack(outs)


def band_groups(shapes, B: int, C: int, F: int):
    """Split the interior bands, given by their (h, w), into launches:
    lists of consecutive band indices."""
    groups, cur, used = [], [], 0
    for i, (h, w) in enumerate(shapes):
        need = 4 * C * B * F * int(h) * int(w) * 4
        if cur and (used + need > GROUP_BYTES or len(cur) == MAX_BANDS):
            groups.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += need
    return groups + [cur] if cur else groups


def pooled_norm(sums: torch.Tensor, h: int, w: int, beta: float) -> torch.Tensor:
    """lp_norm tail over the pooled sums: safe_pow(sum / (h w), 1 / beta)."""
    return _safe_pow_static(sums / float(h * w), 1.0 / float(beta))


def band_masking(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts):
    """CPU tensors take ``band_masking_plain``; CUDA tensors launch the
    kernel over all the given bands at once."""
    if gi_list[0].device.type == "cpu":
        return band_masking_plain(gi_list, E_list, luts, muls, k)
    n = len(gi_list)
    if not 1 <= n <= MAX_BANDS or len(E_list) != n or len(muls) != n:
        raise ValueError(f"band_masking: 1..{MAX_BANDS} bands, got {n}")
    B, C2, F = gi_list[0].shape[:3]
    C = C2 // 2
    _build.require_cuda("band_masking", luts, *gi_list, *E_list)
    if tuple(luts.shape[:2]) != (n, C) or C > 4 or len(k.taps) > 17:
        raise ValueError("band_masking: table or channel count mismatch")
    dims = np.zeros((n, 2), np.int32)
    for i, (gi, E) in enumerate(zip(gi_list, E_list)):
        if gi.shape != E.shape or tuple(gi.shape[:3]) != (B, C2, F):
            raise ValueError("band_masking: gi/E shape mismatch")
        dims[i] = gi.shape[-2:]
    dev = gi_list[0].device
    sizes = [B * C * F * int(h) * int(w) for h, w in dims]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    mpre = torch.empty(int(offs[-1]), dtype=torch.float32, device=dev)
    diff = torch.empty(int(offs[-1]), dtype=torch.float32, device=dev)
    ptrs = np.array([[gi.data_ptr(), E.data_ptr(), mpre.data_ptr() + 4 * int(o),
                      diff.data_ptr() + 4 * int(o)]
                     for gi, E, o in zip(gi_list, E_list, offs[:-1])], np.int64)
    blur = np.array([int(k.params.blurs(int(h), int(w))) for h, w in dims], np.int32)
    muls_a = np.asarray(muls, np.float32)
    lib = _build.library()
    n_tiles = lib.cvvdp_band_masking_tiles(n, B, F, dims.ctypes.data)
    partials = torch.empty(n_tiles * C, dtype=torch.float32, device=dev)
    out = torch.empty((n, B, C, F), dtype=torch.float32, device=dev)
    gains = np.ascontiguousarray(k.gains, np.float32)
    qs = np.ascontiguousarray(k.qs, np.float32)
    xcm = np.ascontiguousarray(k.xcm, np.float32)
    taps = np.ascontiguousarray(k.taps, np.float32)
    rc = lib.cvvdp_band_masking(
        n, B, C, F, luts.shape[2], ptrs.ctypes.data, dims.ctypes.data, muls_a.ctypes.data,
        blur.ctypes.data, luts.data_ptr(), k.x0, (luts.shape[2] - 1) / (k.x1 - k.x0),
        gains.ctypes.data, int(k.ref_only), qs.ctypes.data, k.p, xcm.ctypes.data, k.max_v,
        k.blur_scale, taps.ctypes.data, len(taps), k.beta, partials.data_ptr(),
        out.data_ptr(), _build.stream_handle(dev))
    _build.check_cuda(rc, "cvvdp_band_masking")
    band_masking.launches += 1
    return out


band_masking.launches = 0
