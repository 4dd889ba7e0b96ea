"""The interior band stage: its constants, its grouping into launches and its
plain chains.

Every interior band of the metric goes through the one-pass band kernel,
``band_pooled.py`` (``csrc/band_pooled.cu``), pooled, with D for the heatmap,
or in the halo mode under a mesh. This module holds what that kernel and its
callers share:

* ``BandConsts``, the constants every band of one metric shares, and the
  constants ``MAX_BANDS``, ``HALO_ROWS``, ``RAW_CODINGS``, ``CODINGS`` and
  ``GROUP_BYTES``;
* ``band_groups``, which splits the interior bands into launches, and
  ``pooled_norm``, the lp_norm tail over the pooled sums;
* the plain chains, the JAX package's band routes in plain PyTorch, which
  ``band_pooled``'s plain versions and backward recompute and which the CPU
  tests hold against the JAX kernels
  (``colorvideovdp_tpu/ops/kernels/masking_fused.py``
  ``fused_csf_contrast_raw`` :440, ``fused_csf_contrast`` :403,
  ``fused_blur_transducer`` :352, ``fused_masking_transducer`` :463;
  ``band_stack.py`` ``make_band_stack`` :253):

  - raw pairs, the band's Gaussian level ``gi`` and the expanded next level
    ``E``, both (B, 2C, F, h, w) with test/reference channels interleaved:
    ``raw_stage_a_plain`` (stage A, the Weber contrast and CSF),
    ``_band_D_plain`` (D), ``_band_sums_plain`` (the pooled sums);
  - contrast bands, the band (B, 2C, F, h, w) at full band gain and its
    adaptation field ``logL`` (B, 1, F, h, w): ``csf_contrast_plain`` and
    ``_band_D_contrast_plain`` (``make_fused_mult_mutual``'s chain);
  - the halo mode's stage B on a rank's row slab with ``HALO_ROWS``
    neighbour rows on each side: ``halo_D_plain`` and ``halo_pool_plain``
    (``fused_blur_transducer``'s ``row_off`` / ``h_valid`` mode);
  - over lists of bands, per frame chunk: ``band_masking_plain`` (pooled),
    ``band_masking_d_plain`` (D) and ``band_masking_halo_plain`` (halo).

``use_kernel`` runs the CSF LUT and blur kernels inside a chain, as the JAX
package's recompute reaches its Pallas LUT and blur.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..blur import _blur_1d, gaussian_kernel1d
from ..clip import clip
from ..masking import (_EPS, MaskingParams, _pow_static, _safe_pow_static,
                       apply_masking_model, clamp_diffs, mask_pool, safe_pow)
from .blur import Blur
from .csf_lut import CsfLut

MAX_BANDS = 8
# The contrast codings of the band kernel: the raw codings, the Weber
# contrast of gi and E, then those the JAX package forms as contrast bands;
# band_pooled.cu forms all four from gi and gn.
RAW_CODINGS = ("weber_g1", "weber_g1_ref")
CODINGS = RAW_CODINGS + ("weber_g0_ref", "log")
# Consecutive interior bands share one launch while the memory the launch
# holds stays within this budget, float32: a ``band_pooled`` band counts
# what it reads, gi's 2C planes and the next level's 2C quarter planes; the
# D modes add D (C planes). (Bands fed E, the expanded next level, count
# E's 2C planes, or a contrast band's logL plane, and M_pre and diff
# scratch of C planes each.)
# Small bands then share a launch (their time is launch latency), and a band
# whose share alone exceeds the budget runs by itself.
GROUP_BYTES = 1 << 28
# The halo mode's neighbour rows on each side of a row slab (the JAX
# package's r = 8, ``masking_fused.py:570``): at least the blur radius.
HALO_ROWS = 8
# Frames per plain-version chunk are chosen so that one chunk holds at most
# this many pixels per channel: bounds the plain version's temporaries.
_PLAIN_CHUNK_PIXELS = 1 << 24


@dataclass(frozen=True)
class BandConsts:
    """The constants every band of one metric shares."""

    x0: float
    x1: float
    sens_corr: float
    ch_gain: np.ndarray  # (C,) channel gain
    ref_only: bool
    qs: np.ndarray  # (C,)
    p: float
    xcm: np.ndarray  # (C, C), [c, d]
    max_v: float
    blur_scale: float
    taps: np.ndarray
    beta: float
    params: MaskingParams
    # The contrast coding the one-pass kernel forms from gi and gn: a raw
    # coding (weber_g1 or weber_g1_ref, which ``ref_only`` tells apart) or a
    # contrast-band coding (weber_g0_ref, log).
    coding: str = "weber_g1"

    @classmethod
    def make(cls, params: MaskingParams, C: int, x0: float, x1: float, sens_corr: float,
             ref_only: bool, beta: float, coding: str | None = None):
        params.check_supported()
        if coding is None:
            coding = "weber_g1_ref" if ref_only else "weber_g1"
        if coding not in CODINGS:
            raise ValueError(f"band kernel: no contrast coding {coding!r}")
        return cls(
            x0=float(x0), x1=float(x1), sens_corr=float(sens_corr),
            ch_gain=np.array([1.0, 1.45, 1.0, 1.0], np.float32)[:C], ref_only=bool(ref_only),
            qs=np.asarray(params.mask_q, np.float32)[:C].copy(), p=float(params.mask_p),
            xcm=params.xcm(C), max_v=float(10.0 ** float(params.d_max)),
            blur_scale=float(10.0 ** params.mask_c),
            taps=gaussian_kernel1d(params.pu_kernel_size, params.pu_dilate).astype(np.float32),
            beta=float(beta), params=params, coding=coding,
        )


def _raw_contrast(gi, E, lut, mul, k: BandConsts, use_kernel: bool = False):
    """(T, R, S) of raw pairs: the Weber contrast and CSF as the JAX package's
    decompose + get_band + CSF chain forms them."""
    lb_r = clip(E[:, 1:2], 0.01)
    lb_t = lb_r if k.ref_only else clip(E[:, 0:1], 0.01)
    T = clip((gi[:, 0::2] - E[:, 0::2]) / lb_t, hi=1000.0) * mul
    R = clip((gi[:, 1::2] - E[:, 1::2]) / lb_r, hi=1000.0) * mul
    S = CsfLut.apply(torch.log10(lb_r[:, 0]), lut, k.x0, k.x1, use_kernel)
    return T, R, S.movedim(0, 1) * k.sens_corr


def _band_D_plain(gi, E, lut, mul, k: BandConsts, use_kernel: bool = False) -> torch.Tensor:
    """D (B, C, F, h, w) of one band: ``_raw_contrast``, then
    ``masking.apply_masking_model``. ``use_kernel`` runs the CSF LUT and blur
    kernels inside the chain."""
    return apply_masking_model(*_raw_contrast(gi, E, lut, mul, k, use_kernel), k.params,
                               use_kernel)


def raw_stage_a_plain(gi, E, lut, mul, k: BandConsts, use_kernel: bool = False):
    """Stage A on raw pairs: (M_pre, diff), each (B, C, F, h, w), with the
    products rounded as ``masking.apply_masking_model`` rounds them
    (``use_kernel``: the CSF LUT through its kernel)."""
    T, R, S = _raw_contrast(gi, E, lut, mul, k, use_kernel)
    g = torch.as_tensor(k.ch_gain, device=gi.device).reshape(1, -1, 1, 1, 1)
    T_p, R_p = T * S * g, R * S * g
    return torch.minimum(torch.abs(T_p), torch.abs(R_p)), torch.abs(T_p - R_p)


def halo_D_plain(m_h, d_h, k: BandConsts, h_valid: int, use_kernel: bool = False) -> torch.Tensor:
    """Stage B of the halo mode: D (B, C, F, h_valid, w) of the owned rows
    [HALO_ROWS, HALO_ROWS + h_valid) of a row slab's M_pre and diff,
    (B, C, F, h_valid + 2 HALO_ROWS, w). The vertical blur reads the
    neighbour rows as they are (no reflection); the horizontal one reflects
    as ``ops/blur.py`` does. The JAX package's
    ``fused_blur_transducer(..., row_off=8, h_valid=h_valid, pool_beta=None)``.
    ``use_kernel`` blurs the whole slab with the blur kernel (``Blur``, whose
    backward is its adjoint mode) and keeps the owned rows: the radius is at
    most HALO_ROWS, so no owned row reads a reflected one, and the rows are
    the tap loop's bit for bit."""
    r, rb = HALO_ROWS, (len(k.taps) - 1) // 2
    if use_kernel:
        M_mm = Blur.apply(m_h, k.taps)[..., r:r + h_valid, :] * k.blur_scale
    else:
        y = None
        for i, t in enumerate(k.taps):
            term = float(t) * m_h[..., r - rb + i:r - rb + i + h_valid, :]
            y = term if y is None else y + term
        M_mm = _blur_1d(y, k.taps, y.ndim - 1) * k.blur_scale
    q = torch.as_tensor(k.qs, device=m_h.device).reshape(-1, 1, 1, 1)
    M = mask_pool(safe_pow(torch.abs(M_mm), q), k.params)
    return clamp_diffs(safe_pow(d_h[..., r:r + h_valid, :], k.p) / (1.0 + M), k.params)


def halo_pool_plain(m_h, d_h, k: BandConsts, h_valid: int) -> torch.Tensor:
    """Stages B and C of the halo mode: (B, C, F) sums of safe_pow(D, beta)
    over the owned rows of ``halo_D_plain``. The JAX package's
    ``fused_blur_transducer(..., row_off=8, h_valid=h_valid)``."""
    D = halo_D_plain(m_h, d_h, k, h_valid)
    return torch.sum(_pow_static(D + _EPS, k.beta) - _EPS ** k.beta, dim=(-2, -1))


def csf_contrast_plain(band, logL, lut, k: BandConsts, use_kernel: bool = False):
    """Stage A on contrast bands, the JAX package's ``fused_csf_contrast``:
    (M_pre, diff), each (B, C, F, h, w), from the band (B, 2C, F, h, w) and
    its logL (B, 1, F, h, w), with the products rounded as
    ``masking.apply_masking_model`` rounds them (``use_kernel``: the CSF LUT
    through its kernel)."""
    S = CsfLut.apply(logL[:, 0], lut, k.x0, k.x1, use_kernel).movedim(0, 1) * k.sens_corr
    g = torch.as_tensor(k.ch_gain, device=band.device).reshape(1, -1, 1, 1, 1)
    T_p = band[:, 0::2] * S * g
    R_p = band[:, 1::2] * S * g
    return torch.minimum(torch.abs(T_p), torch.abs(R_p)), torch.abs(T_p - R_p)


def _band_D_contrast_plain(band, logL, lut, k: BandConsts,
                           use_kernel: bool = False) -> torch.Tensor:
    """D (B, C, F, h, w) of one contrast band: the JAX package's
    ``make_fused_mult_mutual.jnp_impl``, the CSF of logL then
    ``masking.apply_masking_model``."""
    S = CsfLut.apply(logL[:, 0], lut, k.x0, k.x1, use_kernel).movedim(0, 1) * k.sens_corr
    return apply_masking_model(band[:, 0::2], band[:, 1::2], S, k.params, use_kernel)


def _band_D_any(x, y, lut, mul, k: BandConsts, contrast: bool, use_kernel: bool = False):
    if contrast:
        return _band_D_contrast_plain(x, y, lut, k, use_kernel)
    return _band_D_plain(x, y, lut, mul, k, use_kernel)


def _band_sums_plain(gi, E, lut, mul, k: BandConsts, use_kernel: bool = False,
                     contrast: bool = False) -> torch.Tensor:
    """sum(safe_pow(D, beta)) over each image plane of the band's plain D."""
    D = _band_D_any(gi, E, lut, mul, k, contrast, use_kernel)
    return torch.sum(_pow_static(D + _EPS, k.beta) - _EPS ** k.beta, dim=(-2, -1))


def _frame_chunks(gi):
    """Frame slices of one band that bound the plain chain's temporaries."""
    B, _, F, h, w = gi.shape
    fc = max(1, _PLAIN_CHUNK_PIXELS // (B * h * w))
    return [slice(f0, f0 + fc) for f0 in range(0, F, fc)]


def band_masking_plain(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts,
                       contrast: bool = False):
    """Plain PyTorch version: returns (n_bands, B, C, F) pooled sums. With
    ``contrast`` the lists hold contrast bands and their logL."""
    return torch.stack([
        torch.cat([_band_sums_plain(gi[:, :, fs], E[:, :, fs], luts[i], muls[i], k,
                                    contrast=contrast)
                   for fs in _frame_chunks(gi)], dim=2)
        for i, (gi, E) in enumerate(zip(gi_list, E_list))])


def band_masking_d_plain(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts,
                         contrast: bool = False):
    """Plain PyTorch version of the D mode: a list of D (B, C, F, h, w)."""
    return [torch.cat([_band_D_any(gi[:, :, fs], E[:, :, fs], luts[i], muls[i], k, contrast)
                       for fs in _frame_chunks(gi)], dim=2)
            for i, (gi, E) in enumerate(zip(gi_list, E_list))]


def band_masking_halo_plain(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts,
                            h_valids):
    """Plain version of the halo mode: (n_bands, B, C, F) pooled sums over
    each slab's owned rows."""
    return torch.stack([
        torch.cat([halo_pool_plain(*raw_stage_a_plain(gi[:, :, fs], E[:, :, fs], luts[i],
                                                      muls[i], k), k, h_valids[i])
                   for fs in _frame_chunks(gi)], dim=2)
        for i, (gi, E) in enumerate(zip(gi_list, E_list))])


def band_groups(shapes, B: int, C: int, F: int, d_blurs=None, contrast: bool = False,
                gn: bool = False):
    """Split the interior bands, given by their (h, w), into launches:
    lists of consecutive band indices. ``d_blurs``, the bands' blur flags,
    asks for the D mode: each band then also holds its D output (C planes),
    and, for bands fed E, a band whose flag differs from the previous
    band's starts a new launch. ``contrast``: the bands are contrast bands,
    which hold one logL plane in place of E's 2C planes. ``gn``: raw bands
    for ``band_pooled`` (or ``band_pooled_d`` with ``d_blurs``), which reads
    the next level's 2C quarter planes in place of E's 2C planes and takes
    bands with and without the blur in one launch; every caller in the
    package groups so."""
    planes = 2 * C + (1 if contrast else C / 2 if gn else 2 * C) + (0 if d_blurs is None else C)
    groups, cur, used = [], [], 0
    for i, (h, w) in enumerate(shapes):
        need = int(planes * B * F * int(h) * int(w) * 4)
        split = (d_blurs is not None and not gn and cur
                 and d_blurs[i] != d_blurs[cur[-1]])
        if cur and (split or used + need > GROUP_BYTES or len(cur) == MAX_BANDS):
            groups.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += need
    return groups + [cur] if cur else groups


def pooled_norm(sums: torch.Tensor, h: int, w: int, beta: float) -> torch.Tensor:
    """lp_norm tail over the pooled sums: safe_pow(sum / (h w), 1 / beta)."""
    return _safe_pow_static(sums / float(h * w), 1.0 / float(beta))
