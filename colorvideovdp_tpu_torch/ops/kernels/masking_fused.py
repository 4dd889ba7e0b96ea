"""Band masking: CSF + contrast + mutual masking, pooled or per pixel.

Replaces five TPU kernels: ``colorvideovdp_tpu/ops/kernels/masking_fused.py``
``fused_csf_contrast_raw`` (:440) and ``fused_blur_transducer`` (:352), run
per wide band, ``fused_csf_contrast`` (:403), the same stage on contrast
bands the decomposition has already formed, ``fused_masking_transducer``
(:463), the transducer on a band whose blur is skipped, and ``band_stack.py``
``make_band_stack`` (:253), which takes all narrow bands in one launch. Here
one kernel takes any 1..8 bands. Kernel: ``csrc/band_masking.cu`` (stage A
elementwise contrast + LUT, stage B tiled blur + transducer, then either tile
sums and stage C's fixed-order reduction, or the per-pixel D map); it is
bound by memory. ``band_groups`` picks which bands share a launch. It takes
the band-kernel configuration only (``MaskingParams.fusable``).

Stage A has two input modes:

* raw pairs (``band_masking``, ``band_masking_d``, ``band_masking_d_noblur``):
  the raw Gaussian level ``gi`` and the expanded next level ``E``, both
  (B, 2C, F, h, w) with test/reference channels interleaved; the Weber
  contrast (weber_g1, weber_g1_ref) is formed in the kernel. The metric's
  raw bands take ``band_pooled`` (pooled) and ``band_pooled_d`` (D, for the
  heatmap) instead (``csrc/band_pooled.cu``, the expand inside, the same
  bits); ``band_masking``, ``band_masking_d`` and ``band_masking_d_noblur``
  stay as their yardsticks, and ``band_masking`` shares its stages with the
  halo mode.
* contrast bands (``band_masking_contrast``, ``band_masking_contrast_d``): the
  band (B, 2C, F, h, w) as the non-raw decomposition gives it, interleaved and
  at full band gain, and its adaptation field ``logL`` (B, 1, F, h, w). The
  JAX package takes this route (``make_fused_mult_mutual``) for every
  interior band off the raw-pair route: the weber_g0_ref and log contrasts.
  The metric forms those codings in ``band_pooled`` from gi and gn instead
  (``BandConsts.coding``); these two stay as its yardsticks.

Two output modes share stages A and B and one plain chain per input mode
(``_band_D_plain``, ``_band_D_contrast_plain``):

* pooled: sum(safe_pow(D, beta)) over each image plane, (n_bands, B, C, F);
  D never reaches memory. ``BandMasking`` makes it differentiable: its
  backward recomputes the plain chain and returns its vector-Jacobian
  product, as the custom VJPs of the JAX package do
  (``masking_fused.py:649-661``, ``:745-757``, ``band_stack.py:289-304``).
  With the kernels on, that recompute runs the CSF LUT and blur kernels with
  their own backward rules, as JAX's recompute reaches its Pallas LUT and
  blur.
* halo (``band_masking_halo``, pooled, raw pairs): each band is one rank's
  row slab of a band sharded over image rows (``parallel/sharding.py``), with
  ``HALO_ROWS`` neighbour rows above and below; the slab's blur reads them as
  they are, and only the owned rows are pooled. The counterpart of the halo'd
  shard mode of ``fused_blur_transducer`` (``row_off``/``h_valid``, JAX
  ``masking_fused.py:553-602``). The caller sums the ranks' sums. Forward
  only; the plain version is ``band_masking_halo_plain``. The sharded
  route takes ``band_pooled_halo`` (gi slabs and gn rows, the expand
  inside) instead; this one stays as its yardstick.
* D: the distortion map D, (B, C, F, h, w) per band, for the heatmap
  (forward only). The JAX package runs ``fused_blur_transducer(pool_beta=
  None)`` on bands its fused blur takes and ``blur_fn`` +
  ``fused_masking_transducer`` on the rest; the port's stage B blurs
  in-kernel at every size, so on raw pairs the second kernel is the same
  launch on bands whose blur ``phase_uncertainty`` skips (h or w <=
  ``pu_padsize``, ``band_masking_d_noblur``), which ``band_groups`` keeps
  apart. ``band_masking_contrast_d`` takes either kind, one kind per launch.
  (``band_pooled_d`` takes both kinds in one launch.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..blur import _blur_1d, gaussian_kernel1d
from ..clip import clip
from ..masking import (_EPS, MaskingParams, _pow_static, _safe_pow_static,
                       apply_masking_model, clamp_diffs, mask_pool, safe_pow)
from . import _build
from .csf_lut import CsfLut

MAX_BANDS = 8
# The contrast codings of the band kernels: the raw codings, whose Weber
# contrast band_masking.cu forms from gi and E, then those it takes as
# pre-formed contrast bands; band_pooled.cu forms all four from gi and gn.
RAW_CODINGS = ("weber_g1", "weber_g1_ref")
CODINGS = RAW_CODINGS + ("weber_g0_ref", "log")
# Consecutive interior bands share one launch while the memory the launch
# holds stays within this budget: per band the expanded next level E (2C
# planes; a contrast band's logL, 1 plane) and the kernel's M_pre and diff
# scratch (C planes each), float32. A ``band_pooled`` launch holds no
# scratch; its bands count what it reads, gi's 2C planes and the next
# level's 2C quarter planes, in place. The D modes add D (C planes).
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


def raw_stage_a_plain(gi, E, lut, mul, k: BandConsts):
    """Stage A on raw pairs: (M_pre, diff), each (B, C, F, h, w), with the
    products rounded as ``masking.apply_masking_model`` rounds them."""
    T, R, S = _raw_contrast(gi, E, lut, mul, k)
    g = torch.as_tensor(k.ch_gain, device=gi.device).reshape(1, -1, 1, 1, 1)
    T_p, R_p = T * S * g, R * S * g
    return torch.minimum(torch.abs(T_p), torch.abs(R_p)), torch.abs(T_p - R_p)


def halo_pool_plain(m_h, d_h, k: BandConsts, h_valid: int) -> torch.Tensor:
    """Stages B and C of the halo mode: (B, C, F) sums of safe_pow(D, beta)
    over the owned rows [HALO_ROWS, HALO_ROWS + h_valid) of a row slab's
    M_pre and diff, (B, C, F, h_valid + 2 HALO_ROWS, w). The vertical blur
    reads the neighbour rows as they are (no reflection); the horizontal one
    reflects as ``ops/blur.py`` does. The JAX package's
    ``fused_blur_transducer(..., row_off=8, h_valid=h_valid)``."""
    r, rb = HALO_ROWS, (len(k.taps) - 1) // 2
    y = None
    for i, t in enumerate(k.taps):
        term = float(t) * m_h[..., r - rb + i:r - rb + i + h_valid, :]
        y = term if y is None else y + term
    M_mm = _blur_1d(y, k.taps, y.ndim - 1) * k.blur_scale
    q = torch.as_tensor(k.qs, device=m_h.device).reshape(-1, 1, 1, 1)
    M = mask_pool(safe_pow(torch.abs(M_mm), q), k.params)
    D = clamp_diffs(safe_pow(d_h[..., r:r + h_valid, :], k.p) / (1.0 + M), k.params)
    return torch.sum(_pow_static(D + _EPS, k.beta) - _EPS ** k.beta, dim=(-2, -1))


def csf_contrast_plain(band, logL, lut, k: BandConsts):
    """Stage A on contrast bands, the JAX package's ``fused_csf_contrast``:
    (M_pre, diff), each (B, C, F, h, w), from the band (B, 2C, F, h, w) and
    its logL (B, 1, F, h, w), with the products rounded as
    ``masking.apply_masking_model`` rounds them."""
    S = CsfLut.apply(logL[:, 0], lut, k.x0, k.x1, False).movedim(0, 1) * k.sens_corr
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


def band_groups(shapes, B: int, C: int, F: int, d_blurs=None, contrast: bool = False,
                gn: bool = False):
    """Split the interior bands, given by their (h, w), into launches:
    lists of consecutive band indices. ``d_blurs``, the bands' blur flags,
    asks for the D mode: each band then also holds its D output (C planes),
    and a band whose flag differs from the previous band's starts a new
    launch, so that a band without blur runs as ``band_masking_d_noblur``.
    ``contrast``: the bands are contrast bands, which hold one logL plane in
    place of E's 2C planes. ``gn``: raw bands for ``band_pooled`` (or
    ``band_pooled_d`` with ``d_blurs``), which reads the next level's 2C
    quarter planes in place of E's 2C planes and takes bands with and
    without the blur in one launch."""
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


def _launch(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts, d_out: bool,
            contrast: bool = False, h_valids=None):
    """One ``cvvdp_band_masking`` launch over the given bands on the card:
    the (n_bands, B, C, F) pooled sums, or with ``d_out`` the list of D.
    ``contrast``: the lists hold contrast bands and their logL. ``h_valids``
    (the halo mode, pooled only): each band is a row slab of h_valid owned
    rows with ``HALO_ROWS`` neighbour rows above and below."""
    n = len(gi_list)
    if not 1 <= n <= MAX_BANDS or len(E_list) != n or len(muls) != n:
        raise ValueError(f"band_masking: 1..{MAX_BANDS} bands, got {n}")
    B, C2, F = gi_list[0].shape[:3]
    C = C2 // 2
    _build.require_cuda("band_masking", luts, *gi_list, *E_list)
    if tuple(luts.shape[:2]) != (n, C) or C > 4 or len(k.taps) > 17:
        raise ValueError("band_masking: table or channel count mismatch")
    dims = np.zeros((n, 2), np.int32)
    halo = np.zeros((n, 2), np.int32)
    for i, (gi, E) in enumerate(zip(gi_list, E_list)):
        h, w = gi.shape[-2:]
        e_shape = (B, 1, F, h, w) if contrast else gi.shape
        if tuple(E.shape) != tuple(e_shape) or tuple(gi.shape[:3]) != (B, C2, F):
            raise ValueError("band_masking: band/second input shape mismatch")
        dims[i] = gi.shape[-2:]
        halo[i] = (0, dims[i][0]) if h_valids is None else (HALO_ROWS, h_valids[i])
    dev = gi_list[0].device
    sizes = [B * C * F * int(h) * int(w) for h, w in dims]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    mpre = torch.empty(int(offs[-1]), dtype=torch.float32, device=dev)
    diff = torch.empty(int(offs[-1]), dtype=torch.float32, device=dev)
    Ds = ([torch.empty((B, C, F, int(h), int(w)), dtype=torch.float32, device=dev)
           for h, w in dims] if d_out else [None] * n)
    ptrs = np.array([[gi.data_ptr(), E.data_ptr(), mpre.data_ptr() + 4 * int(o),
                      diff.data_ptr() + 4 * int(o), 0 if D is None else D.data_ptr()]
                     for gi, E, o, D in zip(gi_list, E_list, offs[:-1], Ds)], np.int64)
    blur = np.array([int(k.params.blurs(int(h), int(w))) for h, w in dims], np.int32)
    muls_a = np.asarray(muls, np.float32)
    lib = _build.library()
    if d_out:
        partials = out = None
    else:
        n_tiles = lib.cvvdp_band_masking_tiles(n, B, F, dims.ctypes.data, halo.ctypes.data)
        partials = torch.empty(n_tiles * C, dtype=torch.float32, device=dev)
        out = torch.empty((n, B, C, F), dtype=torch.float32, device=dev)
    ch_gain = np.ascontiguousarray(k.ch_gain, np.float32)
    qs = np.ascontiguousarray(k.qs, np.float32)
    xcm = np.ascontiguousarray(k.xcm, np.float32)
    taps = np.ascontiguousarray(k.taps, np.float32)
    rc = lib.cvvdp_band_masking(
        n, B, C, F, luts.shape[2], ptrs.ctypes.data, dims.ctypes.data, halo.ctypes.data,
        muls_a.ctypes.data,
        blur.ctypes.data, luts.data_ptr(), k.x0, (luts.shape[2] - 1) / (k.x1 - k.x0),
        ch_gain.ctypes.data, k.sens_corr, int(k.ref_only), int(contrast), qs.ctypes.data, k.p,
        xcm.ctypes.data, k.max_v, k.blur_scale, taps.ctypes.data, len(taps), k.beta, int(d_out),
        None if partials is None else partials.data_ptr(),
        None if out is None else out.data_ptr(), _build.stream_handle(dev))
    _build.check_cuda(rc, "cvvdp_band_masking")
    return Ds if d_out else out


def band_masking(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts):
    """CPU tensors take ``band_masking_plain``; CUDA tensors launch the
    kernel over all the given bands at once: (n_bands, B, C, F) pooled sums."""
    if gi_list[0].device.type == "cpu":
        return band_masking_plain(gi_list, E_list, luts, muls, k)
    out = _launch(gi_list, E_list, luts, muls, k, d_out=False)
    band_masking.launches += 1
    return out


band_masking.launches = 0


def band_masking_halo_plain(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts,
                            h_valids):
    """Plain version of the halo mode: (n_bands, B, C, F) pooled sums over
    each slab's owned rows."""
    return torch.stack([
        torch.cat([halo_pool_plain(*raw_stage_a_plain(gi[:, :, fs], E[:, :, fs], luts[i],
                                                      muls[i], k), k, h_valids[i])
                   for fs in _frame_chunks(gi)], dim=2)
        for i, (gi, E) in enumerate(zip(gi_list, E_list))])


def band_masking_halo(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts, h_valids):
    """The halo mode on raw pairs: each gi and E (B, 2C, F, h_valid +
    2 HALO_ROWS, w) is a rank's row slab with its neighbour rows; returns the
    (n_bands, B, C, F) pooled sums over the owned rows, for the caller to sum
    over the ranks. CPU tensors take ``band_masking_halo_plain``."""
    if any(gi.shape[-2] != hv + 2 * HALO_ROWS for gi, hv in zip(gi_list, h_valids)):
        raise ValueError("band_masking_halo: each slab needs HALO_ROWS rows on each side")
    if gi_list[0].device.type == "cpu":
        return band_masking_halo_plain(gi_list, E_list, luts, muls, k, h_valids)
    _check_blur("band_masking_halo", gi_list, k, True)
    out = _launch(gi_list, E_list, luts, muls, k, d_out=False, h_valids=h_valids)
    band_masking_halo.launches += 1
    return out


band_masking_halo.launches = 0


def _check_blur(name, gi_list, k: BandConsts, want: bool):
    if any(k.params.blurs(*gi.shape[-2:]) != want for gi in gi_list):
        raise ValueError(f"{name}: every band must {'' if want else 'not '}take the blur")


def band_masking_d(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts):
    """The D mode on bands that take the masking blur (the JAX package's
    ``fused_blur_transducer`` with ``pool_beta=None``): a list of D
    (B, C, F, h, w). CPU tensors take ``band_masking_d_plain``."""
    if gi_list[0].device.type == "cpu":
        return band_masking_d_plain(gi_list, E_list, luts, muls, k)
    _check_blur("band_masking_d", gi_list, k, True)
    Ds = _launch(gi_list, E_list, luts, muls, k, d_out=True)
    band_masking_d.launches += 1
    return Ds


band_masking_d.launches = 0


def band_masking_d_noblur(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts):
    """The D mode on bands whose blur ``phase_uncertainty`` skips (the JAX
    package's ``fused_masking_transducer`` on M x 10^mask_c): a list of D.
    CPU tensors take ``band_masking_d_plain``."""
    if gi_list[0].device.type == "cpu":
        return band_masking_d_plain(gi_list, E_list, luts, muls, k)
    _check_blur("band_masking_d_noblur", gi_list, k, False)
    Ds = _launch(gi_list, E_list, luts, muls, k, d_out=True)
    band_masking_d_noblur.launches += 1
    return Ds


band_masking_d_noblur.launches = 0


def band_masking_contrast(bands, logLs, luts: torch.Tensor, k: BandConsts):
    """Pooled sums (n_bands, B, C, F) of contrast bands (the JAX package's
    ``fused_csf_contrast`` + ``fused_blur_transducer``). CPU tensors take
    ``band_masking_plain(..., contrast=True)``."""
    ones = [1.0] * len(bands)
    if bands[0].device.type == "cpu":
        return band_masking_plain(bands, logLs, luts, ones, k, contrast=True)
    out = _launch(bands, logLs, luts, ones, k, d_out=False, contrast=True)
    band_masking_contrast.launches += 1
    return out


band_masking_contrast.launches = 0


def band_masking_contrast_d(bands, logLs, luts: torch.Tensor, k: BandConsts):
    """D of contrast bands that share one blur flag (the JAX package's
    ``make_fused_mult_mutual``: ``fused_csf_contrast``, then the blur and
    ``fused_masking_transducer``): a list of D (B, C, F, h, w). CPU tensors
    take ``band_masking_d_plain(..., contrast=True)``."""
    ones = [1.0] * len(bands)
    if bands[0].device.type == "cpu":
        return band_masking_d_plain(bands, logLs, luts, ones, k, contrast=True)
    _check_blur("band_masking_contrast_d", bands, k, k.params.blurs(*bands[0].shape[-2:]))
    Ds = _launch(bands, logLs, luts, ones, k, d_out=True, contrast=True)
    band_masking_contrast_d.launches += 1
    return Ds


band_masking_contrast_d.launches = 0


def band_D(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts, use_kernel: bool = True,
           contrast: bool = False):
    """D of one ``band_groups`` launch (all its bands share the blur flag):
    the kernel that fits the group, or the plain version without
    ``use_kernel``. Forward only."""
    if not use_kernel:
        return band_masking_d_plain(gi_list, E_list, luts, muls, k, contrast)
    if contrast:
        return band_masking_contrast_d(gi_list, E_list, luts, k)
    fn = band_masking_d if k.params.blurs(*gi_list[0].shape[-2:]) else band_masking_d_noblur
    return fn(gi_list, E_list, luts, muls, k)


class BandMasking(torch.autograd.Function):
    """Pooled band sums, differentiable in every input: ``band_masking`` or
    ``band_masking_contrast`` (or the plain version without ``use_kernel``)
    forward; the backward recomputes the band's plain chain per band and frame
    chunk and returns its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, luts, muls, k, use_kernel, contrast, *gi_and_E):
        n = len(gi_and_E) // 2
        ctx.save_for_backward(luts, *gi_and_E)
        ctx.args = (muls, k, use_kernel, contrast)
        x, y = list(gi_and_E[:n]), list(gi_and_E[n:])
        if not use_kernel:
            return band_masking_plain(x, y, luts, muls, k, contrast)
        if contrast:
            return band_masking_contrast(x, y, luts, k)
        return band_masking(x, y, luts, muls, k)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        luts, *gi_and_E = ctx.saved_tensors
        muls, k, use_kernel, contrast = ctx.args
        n = len(gi_and_E) // 2
        d_gi, d_E = [], []
        for i, (gi, E) in enumerate(zip(gi_and_E[:n], gi_and_E[n:])):
            a, b = torch.zeros_like(gi), torch.zeros_like(E)
            for fs in _frame_chunks(gi):
                with torch.enable_grad():
                    gi_c = gi[:, :, fs].detach().requires_grad_()
                    E_c = E[:, :, fs].detach().requires_grad_()
                    s = _band_sums_plain(gi_c, E_c, luts[i], muls[i], k, use_kernel, contrast)
                    a[:, :, fs], b[:, :, fs] = torch.autograd.grad(s, (gi_c, E_c), g[i, :, :, fs])
            d_gi.append(a)
            d_E.append(b)
        return (None, None, None, None, None, *d_gi, *d_E)


def band_sums(gi_list, E_list, luts: torch.Tensor, muls, k: BandConsts, use_kernel: bool = True,
              contrast: bool = False):
    """(n_bands, B, C, F) pooled sums through ``BandMasking``; ``contrast``:
    the lists hold contrast bands and their logL (``muls`` unused)."""
    return BandMasking.apply(luts, muls, k, use_kernel, contrast, *gi_list, *E_list)
