"""Band masking of raw bands in one pass: the default scoring route, the
contrast-band codings, the heatmap's D and the sharded halo mode.

For a list of raw bands, each given by its Gaussian level ``gi``
(B, 2C, F, h, w) and the next level ``gn`` (B, 2C, F, ceil(h/2),
ceil(w/2)), the (n_bands, B, C, F) sums of safe_pow(D, beta) over each image
plane: the expand of gn, the contrast in the metric's coding, the CSF LUT,
the masking blur, the transducer and the pooling. Replaces the JAX package's
pooled raw-pair route, ``colorvideovdp_tpu/ops/kernels/masking_fused.py``
``fused_csf_contrast_raw`` (:440) + ``fused_blur_transducer`` (:352),
``band_stack.py`` ``make_band_stack`` (:253) and, for the bands its gate
admits, the JAX package's band mega-kernel, which XLA feeds the expand;
here it is inside the kernel, and every interior band of the metric takes
it. Kernel: ``csrc/band_pooled.cu``, whose source note states its
bound and design.

The coding is ``BandConsts.coding``. The raw codings (weber_g1,
weber_g1_ref) are the JAX package's raw-pair route. The contrast-band
codings (weber_g0_ref, log) replace its route on pre-formed contrast bands,
``fused_csf_contrast`` (:403) + ``fused_blur_transducer``, fed the bands and
fields its decomposition writes (``colorvideovdp_tpu/ops/pyramid.py
:488-579``): here they are formed per sample, rounded as the plain chain on
the contrast band (``masking_fused.band_masking_plain(contrast=True)`` fed
``ops/pyramid.py`` ``interior_contrast`` x the band gain) rounds them.

* ``band_pooled``: CPU tensors take ``band_pooled_plain``, the plain chain
  (``masking_fused._band_sums_plain``, on the contrast band for a
  contrast-band coding) fed ``gausspyr_expand(gn)`` per frame chunk; CUDA
  tensors launch the kernel over all the given bands at once.
* ``band_pooled_d``: the kernel's D mode for the heatmap, (D list, sums):
  each band's D (B, C, F, h, w) and the same pooled sums, so the heatmap
  run's JOD is the pooled-only JOD. It replaces the JAX package's
  ``fused_blur_transducer`` with ``pool_beta=None`` (``masking_fused.py``
  :352) and, on bands whose blur is skipped, ``fused_masking_transducer``
  (:463), which XLA feeds the expand; one launch takes both kinds. The
  plain version ``band_pooled_d_plain`` is ``masking_fused._band_D_plain``
  fed the expand per frame chunk. Forward only.
* ``band_pooled_halo``: the halo mode, every coding: each band is one
  rank's row slab of a band sharded over image rows, gi with ``HALO_ROWS``
  neighbour rows on each side (``parallel/sharding.py`` ``halo_rows``) and
  the rows of gn its expand reads (``halo_gn``); the expand is taken at each
  buffer row's reflected global row, only the owned rows are pooled, and
  the caller sums the ranks' sums. It replaces the halo'd shard mode of
  ``fused_blur_transducer`` (``masking_fused.py`` :219-227, :540-602); its
  plain version ``band_pooled_halo_plain`` pools ``masking_fused.halo_D_plain``
  on stage A in the coding (``_stage_a``), fed ``halo_expand_plain``, and
  its owned rows' D is, bit for bit, the whole band's. ``BandPooledHalo`` /
  ``band_pooled_halo_sums`` make it differentiable: the backward recomputes
  the plain halo chain per frame chunk, its CSF LUT and blur through their
  kernels on the card.
* ``band_pooled_d_halo``: the halo mode with D, for a sharded heatmap: D of
  the owned rows (B, C, F, h_valid, w) and the pooled mode's sums, from one
  launch of the kernel's D mode with the halo geometry; plain version
  ``band_pooled_d_halo_plain``. Forward only.
* ``BandPooled`` / ``band_pooled_sums``: the same sums, differentiable in
  every gi and gn; the backward (``pooled_vjp``) recomputes the plain chain
  through ``gausspyr_expand`` per frame chunk, as JAX's custom VJPs
  recompute their plain implementations.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..masking import _EPS, _pow_static
from ..pyramid import K5, LOG_A, LOG_B, expand_rows, gausspyr_expand, interior_contrast
from . import _build
from .masking_fused import (HALO_ROWS, MAX_BANDS, RAW_CODINGS, BandConsts, _band_D_contrast_plain,
                            _band_D_plain, _band_sums_plain, _frame_chunks, csf_contrast_plain,
                            halo_D_plain, raw_stage_a_plain)

# The kernel keeps each band's LUT rows in shared memory.
MAX_KNOTS = 64
# The expand taps, 2 * K5, as ops/pyramid.py `_expand_1d` forms them.
_EXPAND_TAPS = np.ascontiguousarray(2.0 * K5.astype(np.float64), np.float32)
# csrc/band_pooled.cu's codings; the raw codings are told apart by ref_only.
_CODING_IDS = {"weber_g0_ref": 2, "log": 3}
# The rows of gn on each side of a rank's slab that the expand of its
# halo'd gi slab reads: HALO_ROWS / 2 and the expand's reach of one.
GN_HALO_ROWS = HALO_ROWS // 2 + 1


def _coding_id(k: BandConsts) -> int:
    return int(k.ref_only) if k.coding in RAW_CODINGS else _CODING_IDS[k.coding]


def _expanded(gi, gn):
    return gausspyr_expand(gn, gi.shape[-2:])


def _contrast_band(gi, E, mul, k: BandConsts):
    """(band at full band gain, adaptation field) of a contrast-band
    coding: the decomposition's band as ``get_band`` scales it."""
    band, logL = interior_contrast(gi, E, k.coding)
    return band * mul, logL


def _sums_of(gi, E, lut, mul, k: BandConsts, use_kernel: bool = False):
    """One band's pooled sums (B, C, F) from gi and E in ``k.coding``."""
    if k.coding in RAW_CODINGS:
        return _band_sums_plain(gi, E, lut, mul, k, use_kernel)
    return _band_sums_plain(*_contrast_band(gi, E, mul, k), lut, 1.0, k, use_kernel,
                            contrast=True)


def _D_of(gi, E, lut, mul, k: BandConsts):
    """One band's D (B, C, F, h, w) from gi and E in ``k.coding``."""
    if k.coding in RAW_CODINGS:
        return _band_D_plain(gi, E, lut, mul, k)
    return _band_D_contrast_plain(*_contrast_band(gi, E, mul, k), lut, k)


def _plain_one(gi, gn, lut, mul, k: BandConsts):
    return torch.cat([_sums_of(gi[:, :, fs], _expanded(gi[:, :, fs], gn[:, :, fs]), lut, mul, k)
                      for fs in _frame_chunks(gi)], dim=2)


def band_pooled_plain(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts):
    """Plain PyTorch version: (n_bands, B, C, F) pooled sums."""
    return torch.stack([_plain_one(gi, gn, luts[i], muls[i], k)
                        for i, (gi, gn) in enumerate(zip(gi_list, gn_list))])


def _pooled(D, k: BandConsts):
    """The (..., B, C, F) sums of safe_pow(D, beta) over each image plane."""
    return torch.sum(_pow_static(D + _EPS, k.beta) - _EPS ** k.beta, dim=(-2, -1))


def _plain_one_d(gi, gn, lut, mul, k: BandConsts):
    """(D, sums) of one band, per frame chunk: the sums are
    ``_band_sums_plain``'s of the same D."""
    Ds, sums = [], []
    for fs in _frame_chunks(gi):
        D = _D_of(gi[:, :, fs], _expanded(gi[:, :, fs], gn[:, :, fs]), lut, mul, k)
        Ds.append(D)
        sums.append(_pooled(D, k))
    return torch.cat(Ds, dim=2), torch.cat(sums, dim=2)


def band_pooled_d_plain(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts):
    """Plain PyTorch version of the D mode: (list of D (B, C, F, h, w),
    (n_bands, B, C, F) pooled sums equal to ``band_pooled_plain``'s)."""
    out = [_plain_one_d(gi, gn, luts[i], muls[i], k)
           for i, (gi, gn) in enumerate(zip(gi_list, gn_list))]
    return [D for D, _ in out], torch.stack([s for _, s in out])


def _reflect_row(g: int, h: int) -> int:
    return -g if g < 0 else (2 * (h - 1) - g if g >= h else g)


def halo_gn_rows(y0: int, h_valid: int, h: int):
    """[first, last] global rows of gn that the expand of a halo'd slab
    reads: its owned rows [y0, y0 + h_valid) of a band of h rows, HALO_ROWS
    more on each side, each at its reflected global row (as
    ``csrc/band_pooled.cu`` ``gn_rows_of``)."""
    G0, G1 = y0 - HALO_ROWS, y0 + h_valid + HALO_ROWS - 1
    lo = 0 if G0 < 0 else min(G0, _reflect_row(G1, h))
    hi = h - 1 if G1 > h - 1 else max(G1, _reflect_row(G0, h))
    return max((lo >> 1) - 1, 0), min((hi >> 1) + 1, (h + 1) // 2 - 1)


def halo_expand_plain(gi, gn, slab):
    """E at every row of a halo'd slab ``gi`` (h_valid + 2 HALO_ROWS rows):
    the expand of gn (rows from global row ``gn_row0`` on) at the row's
    global row, reflected past a global edge as ``halo_rows`` reflects gi;
    ``slab`` = (y0, h, gn_row0): the global first owned row, the band's
    global row count, gn's first row."""
    y0, h, gn_row0 = slab
    g = torch.tensor([_reflect_row(y, h) for y in range(y0 - HALO_ROWS,
                                                        y0 - HALO_ROWS + gi.shape[-2])],
                     device=gi.device)
    return expand_rows(gn, gn_row0, (h + 1) // 2, g, gi.shape[-1])


def _stage_a(gi, E, lut, mul, k: BandConsts, use_kernel: bool = False):
    """Stage A (M_pre, diff) of one band from gi and E in ``k.coding``, each
    product rounded as the whole band's plain chain rounds it."""
    if k.coding in RAW_CODINGS:
        return raw_stage_a_plain(gi, E, lut, mul, k, use_kernel)
    return csf_contrast_plain(*_contrast_band(gi, E, mul, k), lut, k, use_kernel)


def _halo_D_one(gi, gn, lut, mul, k: BandConsts, slab, use_kernel: bool = False):
    """D (B, C, F, h_valid, w) of one halo'd slab's owned rows, per frame
    chunk."""
    E = halo_expand_plain(gi, gn, slab)
    hv = gi.shape[-2] - 2 * HALO_ROWS
    return torch.cat([halo_D_plain(*_stage_a(gi[:, :, fs], E[:, :, fs], lut, mul, k, use_kernel),
                                   k, hv, use_kernel) for fs in _frame_chunks(gi)], dim=2)


def band_pooled_halo_plain(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts, slabs):
    """Plain version of the halo mode: (n_bands, B, C, F) pooled sums over
    each slab's owned rows (``masking_fused.halo_D_plain`` on stage A, in
    the metric's coding, fed ``halo_expand_plain``, then pooled)."""
    return band_pooled_d_halo_plain(gi_list, gn_list, luts, muls, k, slabs)[1]


def band_pooled_d_halo_plain(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts, slabs):
    """Plain version of the halo mode with D: (list of D (B, C, F, h_valid,
    w) of each slab's owned rows, (n_bands, B, C, F) pooled sums)."""
    Ds = [_halo_D_one(gi, gn, luts[i], muls[i], k, slabs[i])
          for i, (gi, gn) in enumerate(zip(gi_list, gn_list))]
    return Ds, torch.stack([_pooled(D, k) for D in Ds])


def launch(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts, d_out: bool = False,
           slabs=None):
    """One ``cvvdp_band_pooled`` launch over the given bands on the card;
    returns the (n_bands, B, C, F) pooled sums, or with ``d_out`` (the D
    mode) the list of each band's D and the sums. ``slabs`` (the halo
    mode): per band (y0, h, gn_row0), gi a halo'd row slab and gn the rows
    of the next level from global row gn_row0 on; D then holds the owned
    rows only."""
    n = len(gi_list)
    if not 1 <= n <= MAX_BANDS or len(gn_list) != n or len(muls) != n:
        raise ValueError(f"band_pooled: 1..{MAX_BANDS} bands, got {n}")
    B, C2, F = gi_list[0].shape[:3]
    C = C2 // 2
    _build.require_cuda("band_pooled", luts, *gi_list, *gn_list)
    if (tuple(luts.shape[:2]) != (n, C) or C > 4 or len(k.taps) > 17
            or luts.shape[2] > MAX_KNOTS):
        raise ValueError("band_pooled: table or channel count mismatch")
    if slabs is not None and len(slabs) != n:
        raise ValueError("band_pooled: the halo mode takes one slab a band")
    dims = np.zeros((n, 2), np.int32)
    geo = np.zeros((n, 5), np.int32)
    for i, (gi, gn) in enumerate(zip(gi_list, gn_list)):
        h, w = gi.shape[-2:]
        hn = (h + 1) // 2 if slabs is None else gn.shape[-2]
        if (tuple(gi.shape[:3]) != (B, C2, F)
                or tuple(gn.shape) != (B, C2, F, hn, (w + 1) // 2)):
            raise ValueError("band_pooled: gi/gn shape mismatch")
        dims[i] = (h, w)
        if slabs is not None:
            y0, h_glob, gn_row0 = slabs[i]
            geo[i] = (HALO_ROWS, y0, h_glob, gn_row0, hn)
    ptrs = np.array([[gi.data_ptr(), gn.data_ptr()] for gi, gn in zip(gi_list, gn_list)],
                    np.int64)
    dev = gi_list[0].device
    rows = [int(h) - (0 if slabs is None else 2 * HALO_ROWS) for h, _ in dims]
    Ds = ([torch.empty((B, C, F, hv, int(w)), dtype=torch.float32, device=dev)
           for hv, (_, w) in zip(rows, dims)] if d_out else [])
    dptrs = np.array([D.data_ptr() for D in Ds], np.int64)
    blur = np.array([int(k.params.blurs(int(h), int(w))) for h, w in dims], np.int32)
    muls_a = np.asarray(muls, np.float32)
    lib = _build.library()
    n_tiles = B * F * sum(-(-hv // 32) * -(-int(w) // 32) for hv, (_, w) in zip(rows, dims))
    partials = torch.empty(n_tiles * C, dtype=torch.float32, device=dev)
    out = torch.empty((n, B, C, F), dtype=torch.float32, device=dev)
    ch_gain = np.ascontiguousarray(k.ch_gain, np.float32)
    qs = np.ascontiguousarray(k.qs, np.float32)
    xcm = np.ascontiguousarray(k.xcm, np.float32)
    taps = np.ascontiguousarray(k.taps, np.float32)
    rc = lib.cvvdp_band_pooled(
        n, B, C, F, luts.shape[2], ptrs.ctypes.data, dptrs.ctypes.data if d_out else None,
        dims.ctypes.data, None if slabs is None else geo.ctypes.data, muls_a.ctypes.data,
        blur.ctypes.data, luts.data_ptr(), k.x0, (luts.shape[2] - 1) / (k.x1 - k.x0),
        ch_gain.ctypes.data, k.sens_corr, _coding_id(k), LOG_A, LOG_B,
        _EXPAND_TAPS.ctypes.data, qs.ctypes.data, k.p, xcm.ctypes.data, k.max_v, k.blur_scale,
        taps.ctypes.data, len(taps), k.beta, partials.data_ptr(), out.data_ptr(),
        _build.stream_handle(dev))
    _build.check_cuda(rc, "cvvdp_band_pooled")
    return (Ds, out) if d_out else out


def band_pooled(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts):
    """(n_bands, B, C, F) pooled sums of raw bands from their levels gi and
    the next levels gn; ``luts`` (n_bands, C, nk). CPU tensors take
    ``band_pooled_plain``; CUDA tensors launch the kernel."""
    if gi_list[0].device.type == "cpu":
        return band_pooled_plain(gi_list, gn_list, luts, muls, k)
    out = launch(gi_list, gn_list, luts, muls, k)
    band_pooled.launches += 1
    return out


band_pooled.launches = 0


def band_pooled_d(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts):
    """The D mode for the heatmap: (list of D (B, C, F, h, w), the
    (n_bands, B, C, F) pooled sums) of raw bands with or without the
    masking blur. CPU tensors take ``band_pooled_d_plain``; CUDA tensors
    launch the kernel over all the given bands at once."""
    if gi_list[0].device.type == "cpu":
        return band_pooled_d_plain(gi_list, gn_list, luts, muls, k)
    out = launch(gi_list, gn_list, luts, muls, k, d_out=True)
    band_pooled_d.launches += 1
    return out


band_pooled_d.launches = 0


def _check_halo(name, gi_list, gn_list, k: BandConsts, slabs):
    """Raise unless each slab holds HALO_ROWS rows on each side of its owned
    rows, gn's rows hold what the slab's expand reads, and every band takes
    the masking blur."""
    for gi, gn, (y0, h, gn_row0) in zip(gi_list, gn_list, slabs):
        if gi.shape[-2] <= 2 * HALO_ROWS:
            raise ValueError(f"{name}: each slab needs HALO_ROWS rows on each side")
        first, last = halo_gn_rows(y0, gi.shape[-2] - 2 * HALO_ROWS, h)
        if not gn_row0 <= first <= last < gn_row0 + gn.shape[-2]:
            raise ValueError(f"{name}: gn rows from {gn_row0} ({gn.shape[-2]}) do "
                             f"not hold the rows [{first}, {last}] the slab's expand reads")
    if not all(k.params.blurs(h, gi.shape[-1]) for gi, (_, h, _) in zip(gi_list, slabs)):
        raise ValueError(f"{name}: every band must take the blur")


def band_pooled_halo(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts, slabs):
    """The halo mode: (n_bands, B, C, F) pooled sums over the owned rows of
    each rank's halo'd slab gi (h_valid + 2 HALO_ROWS rows) from the rows
    of the next level gn that its expand reads; ``slabs``: per band (y0, h,
    gn_row0), the global first owned row, the band's global row count and
    gn's first global row. Every contrast coding; bands that take the
    masking blur. CPU tensors take ``band_pooled_halo_plain``; CUDA tensors
    launch the kernel over all the given bands at once."""
    _check_halo("band_pooled_halo", gi_list, gn_list, k, slabs)
    if gi_list[0].device.type == "cpu":
        return band_pooled_halo_plain(gi_list, gn_list, luts, muls, k, slabs)
    out = launch(gi_list, gn_list, luts, muls, k, slabs=slabs)
    band_pooled_halo.launches += 1
    return out


band_pooled_halo.launches = 0


def band_pooled_d_halo(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts, slabs):
    """The halo mode with D, for a sharded heatmap: (list of D (B, C, F,
    h_valid, w) of each slab's owned rows, the (n_bands, B, C, F) pooled
    sums, those of ``band_pooled_halo``); arguments as ``band_pooled_halo``.
    CPU tensors take ``band_pooled_d_halo_plain``; CUDA tensors launch the
    kernel's D mode over all the given bands at once."""
    _check_halo("band_pooled_d_halo", gi_list, gn_list, k, slabs)
    if gi_list[0].device.type == "cpu":
        return band_pooled_d_halo_plain(gi_list, gn_list, luts, muls, k, slabs)
    out = launch(gi_list, gn_list, luts, muls, k, d_out=True, slabs=slabs)
    band_pooled_d_halo.launches += 1
    return out


band_pooled_d_halo.launches = 0


def pooled_vjp(gi, gn, lut, mul, k: BandConsts, use_kernel: bool, g):
    """(d gi, d gn): the vector-Jacobian product of one band's pooled sums
    (B, C, F) with ``g``, through the plain chain (with the CSF LUT and blur
    kernels inside under ``use_kernel``) recomputed per frame chunk."""
    d_gi, d_gn = torch.zeros_like(gi), torch.zeros_like(gn)
    for fs in _frame_chunks(gi):
        with torch.enable_grad():
            gi_c = gi[:, :, fs].detach().requires_grad_()
            gn_c = gn[:, :, fs].detach().requires_grad_()
            s = _sums_of(gi_c, _expanded(gi_c, gn_c), lut, mul, k, use_kernel)
            d_gi[:, :, fs], d_gn[:, :, fs] = torch.autograd.grad(s, (gi_c, gn_c), g[:, :, fs])
    return d_gi, d_gn


class BandPooled(torch.autograd.Function):
    """Pooled sums (n_bands, B, C, F) of raw bands, differentiable in every
    gi and gn: ``band_pooled``, or the plain version without ``use_kernel``,
    forward; the backward is ``pooled_vjp`` per band."""

    @staticmethod
    def forward(ctx, luts, muls, k, use_kernel, *gi_and_gn):
        n = len(gi_and_gn) // 2
        ctx.save_for_backward(luts, *gi_and_gn)
        ctx.args = (muls, k, use_kernel)
        x, y = list(gi_and_gn[:n]), list(gi_and_gn[n:])
        fn = band_pooled if use_kernel else band_pooled_plain
        return fn(x, y, luts, muls, k)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        luts, *gi_and_gn = ctx.saved_tensors
        muls, k, use_kernel = ctx.args
        n = len(gi_and_gn) // 2
        grads = [pooled_vjp(gi, gn, luts[i], muls[i], k, use_kernel, g[i])
                 for i, (gi, gn) in enumerate(zip(gi_and_gn[:n], gi_and_gn[n:]))]
        return (None, None, None, None, *[a for a, _ in grads], *[b for _, b in grads])


def band_pooled_sums(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts,
                     use_kernel: bool = True):
    """(n_bands, B, C, F) pooled sums through ``BandPooled``."""
    return BandPooled.apply(luts, muls, k, use_kernel, *gi_list, *gn_list)


class BandPooledHalo(torch.autograd.Function):
    """The halo mode's pooled sums (n_bands, B, C, F), differentiable in
    every gi slab and gn's rows: ``band_pooled_halo`` (or its plain version
    without ``use_kernel``) forward; the backward recomputes each band's
    plain halo chain per frame chunk (under ``use_kernel`` the CSF LUT and
    the blur through their kernels, backward ``csf_lut_bwd`` and
    ``blur_adjoint``: the blur runs over the whole slab, ``halo_D_plain``)
    and returns its vector-Jacobian product. The caller's row exchanges
    send the halo rows' gradients to their owners."""

    @staticmethod
    def forward(ctx, luts, muls, k, slabs, use_kernel, *gi_and_gn):
        n = len(gi_and_gn) // 2
        ctx.save_for_backward(luts, *gi_and_gn)
        ctx.args = (muls, k, slabs, use_kernel)
        x, y = list(gi_and_gn[:n]), list(gi_and_gn[n:])
        fn = band_pooled_halo if use_kernel else band_pooled_halo_plain
        return fn(x, y, luts, muls, k, slabs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        luts, *gi_and_gn = ctx.saved_tensors
        muls, k, slabs, use_kernel = ctx.args
        n = len(gi_and_gn) // 2
        d_gi = [torch.zeros_like(gi) for gi in gi_and_gn[:n]]
        d_gn = [torch.zeros_like(gn) for gn in gi_and_gn[n:]]
        for i, (gi, gn) in enumerate(zip(gi_and_gn[:n], gi_and_gn[n:])):
            for fs in _frame_chunks(gi):
                with torch.enable_grad():
                    gi_c = gi[:, :, fs].detach().requires_grad_()
                    gn_c = gn[:, :, fs].detach().requires_grad_()
                    s = _pooled(_halo_D_one(gi_c, gn_c, luts[i], muls[i], k, slabs[i],
                                            use_kernel), k)
                    d_gi[i][:, :, fs], d_gn[i][:, :, fs] = torch.autograd.grad(
                        s, (gi_c, gn_c), g[i][:, :, fs])
        return (None, None, None, None, None, *d_gi, *d_gn)


def band_pooled_halo_sums(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts, slabs,
                          use_kernel: bool = True):
    """(n_bands, B, C, F) halo-mode pooled sums through ``BandPooledHalo``."""
    return BandPooledHalo.apply(luts, muls, k, slabs, use_kernel, *gi_list, *gn_list)
