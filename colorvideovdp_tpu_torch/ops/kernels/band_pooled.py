"""Band masking of raw bands in one pass: the default scoring route, and
the heatmap's D.

For a list of raw bands, each given by its Gaussian level ``gi``
(B, 2C, F, h, w) and the next level ``gn`` (B, 2C, F, ceil(h/2),
ceil(w/2)), the (n_bands, B, C, F) sums of safe_pow(D, beta) over each image
plane: the expand of gn, the Weber contrast, the CSF LUT, the masking blur,
the transducer and the pooling. Replaces the JAX package's pooled raw-pair
route, ``colorvideovdp_tpu/ops/kernels/masking_fused.py``
``fused_csf_contrast_raw`` (:440) + ``fused_blur_transducer`` (:352),
``band_stack.py`` ``make_band_stack`` (:253) and, for the ``use_band_mega``
band, ``band_fused.py`` ``band_fused_tpu`` (:320), which XLA feeds the
expand; here it is inside the kernel. Kernel: ``csrc/band_pooled.cu``,
whose source note states its bound and design; its sums are, bit for bit,
those of ``masking_fused.band_masking`` fed ``gausspyr_expand(gn)``.

* ``band_pooled``: CPU tensors take ``band_pooled_plain``, the plain chain
  (``masking_fused._band_sums_plain``) fed ``gausspyr_expand(gn)`` per frame
  chunk; CUDA tensors launch the kernel over all the given bands at once.
* ``band_pooled_d``: the kernel's D mode for the heatmap, (D list, sums):
  each band's D (B, C, F, h, w) and the same pooled sums, so the heatmap
  run's JOD is the pooled-only JOD. It replaces the JAX package's
  ``fused_blur_transducer`` with ``pool_beta=None`` (``masking_fused.py``
  :352) and, on bands whose blur is skipped, ``fused_masking_transducer``
  (:463), which XLA feeds the expand; one launch takes both kinds. Its D
  is, bit for bit, ``masking_fused.band_masking_d`` /
  ``band_masking_d_noblur`` fed ``gausspyr_expand(gn)``; the plain version
  ``band_pooled_d_plain`` is ``masking_fused._band_D_plain`` fed the expand
  per frame chunk. Forward only.
* ``BandPooled`` / ``band_pooled_sums``: the same sums, differentiable in
  every gi and gn (also ``band_fused.band_fused_sums``, which gives its own
  counted launcher); the backward (``pooled_vjp``) recomputes the plain
  chain through ``gausspyr_expand`` per frame chunk, as JAX's custom VJPs
  recompute their plain implementations.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..masking import _EPS, _pow_static
from ..pyramid import K5, gausspyr_expand
from . import _build
from .masking_fused import MAX_BANDS, BandConsts, _band_D_plain, _band_sums_plain, _frame_chunks

# The kernel keeps each band's LUT rows in shared memory.
MAX_KNOTS = 64
# The expand taps, 2 * K5, as ops/pyramid.py `_expand_1d` forms them.
_EXPAND_TAPS = np.ascontiguousarray(2.0 * K5.astype(np.float64), np.float32)


def _expanded(gi, gn):
    return gausspyr_expand(gn, gi.shape[-2:])


def _plain_one(gi, gn, lut, mul, k: BandConsts):
    return torch.cat([_band_sums_plain(gi[:, :, fs], _expanded(gi[:, :, fs], gn[:, :, fs]),
                                       lut, mul, k)
                      for fs in _frame_chunks(gi)], dim=2)


def band_pooled_plain(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts):
    """Plain PyTorch version: (n_bands, B, C, F) pooled sums."""
    return torch.stack([_plain_one(gi, gn, luts[i], muls[i], k)
                        for i, (gi, gn) in enumerate(zip(gi_list, gn_list))])


def _plain_one_d(gi, gn, lut, mul, k: BandConsts):
    """(D, sums) of one band, per frame chunk: the sums are
    ``_band_sums_plain``'s of the same D."""
    Ds, sums = [], []
    for fs in _frame_chunks(gi):
        D = _band_D_plain(gi[:, :, fs], _expanded(gi[:, :, fs], gn[:, :, fs]), lut, mul, k)
        Ds.append(D)
        sums.append(torch.sum(_pow_static(D + _EPS, k.beta) - _EPS ** k.beta, dim=(-2, -1)))
    return torch.cat(Ds, dim=2), torch.cat(sums, dim=2)


def band_pooled_d_plain(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts):
    """Plain PyTorch version of the D mode: (list of D (B, C, F, h, w),
    (n_bands, B, C, F) pooled sums equal to ``band_pooled_plain``'s)."""
    out = [_plain_one_d(gi, gn, luts[i], muls[i], k)
           for i, (gi, gn) in enumerate(zip(gi_list, gn_list))]
    return [D for D, _ in out], torch.stack([s for _, s in out])


def launch(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts, d_out: bool = False):
    """One ``cvvdp_band_pooled`` launch over the given bands on the card;
    returns the (n_bands, B, C, F) pooled sums, or with ``d_out`` (the D
    mode) the list of each band's D and the sums."""
    n = len(gi_list)
    if not 1 <= n <= MAX_BANDS or len(gn_list) != n or len(muls) != n:
        raise ValueError(f"band_pooled: 1..{MAX_BANDS} bands, got {n}")
    B, C2, F = gi_list[0].shape[:3]
    C = C2 // 2
    _build.require_cuda("band_pooled", luts, *gi_list, *gn_list)
    if (tuple(luts.shape[:2]) != (n, C) or C > 4 or len(k.taps) > 17
            or luts.shape[2] > MAX_KNOTS):
        raise ValueError("band_pooled: table or channel count mismatch")
    dims = np.zeros((n, 2), np.int32)
    for i, (gi, gn) in enumerate(zip(gi_list, gn_list)):
        h, w = gi.shape[-2:]
        if (tuple(gi.shape[:3]) != (B, C2, F)
                or tuple(gn.shape) != (B, C2, F, (h + 1) // 2, (w + 1) // 2)):
            raise ValueError("band_pooled: gi/gn shape mismatch")
        dims[i] = (h, w)
    ptrs = np.array([[gi.data_ptr(), gn.data_ptr()] for gi, gn in zip(gi_list, gn_list)],
                    np.int64)
    dev = gi_list[0].device
    Ds = ([torch.empty((B, C, F, int(h), int(w)), dtype=torch.float32, device=dev)
           for h, w in dims] if d_out else [])
    dptrs = np.array([D.data_ptr() for D in Ds], np.int64)
    blur = np.array([int(k.params.blurs(int(h), int(w))) for h, w in dims], np.int32)
    muls_a = np.asarray(muls, np.float32)
    lib = _build.library()
    n_tiles = B * F * sum(-(-int(h) // 32) * -(-int(w) // 32) for h, w in dims)
    partials = torch.empty(n_tiles * C, dtype=torch.float32, device=dev)
    out = torch.empty((n, B, C, F), dtype=torch.float32, device=dev)
    ch_gain = np.ascontiguousarray(k.ch_gain, np.float32)
    qs = np.ascontiguousarray(k.qs, np.float32)
    xcm = np.ascontiguousarray(k.xcm, np.float32)
    taps = np.ascontiguousarray(k.taps, np.float32)
    rc = lib.cvvdp_band_pooled(
        n, B, C, F, luts.shape[2], ptrs.ctypes.data, dptrs.ctypes.data if d_out else None,
        dims.ctypes.data, muls_a.ctypes.data,
        blur.ctypes.data, luts.data_ptr(), k.x0, (luts.shape[2] - 1) / (k.x1 - k.x0),
        ch_gain.ctypes.data, k.sens_corr, int(k.ref_only), _EXPAND_TAPS.ctypes.data,
        qs.ctypes.data, k.p, xcm.ctypes.data, k.max_v, k.blur_scale, taps.ctypes.data,
        len(taps), k.beta, partials.data_ptr(), out.data_ptr(), _build.stream_handle(dev))
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


def pooled_vjp(gi, gn, lut, mul, k: BandConsts, use_kernel: bool, g):
    """(d gi, d gn): the vector-Jacobian product of one band's pooled sums
    (B, C, F) with ``g``, through the plain chain (with the CSF LUT and blur
    kernels inside under ``use_kernel``) recomputed per frame chunk."""
    d_gi, d_gn = torch.zeros_like(gi), torch.zeros_like(gn)
    for fs in _frame_chunks(gi):
        with torch.enable_grad():
            gi_c = gi[:, :, fs].detach().requires_grad_()
            gn_c = gn[:, :, fs].detach().requires_grad_()
            s = _band_sums_plain(gi_c, _expanded(gi_c, gn_c), lut, mul, k, use_kernel)
            d_gi[:, :, fs], d_gn[:, :, fs] = torch.autograd.grad(s, (gi_c, gn_c), g[:, :, fs])
    return d_gi, d_gn


class BandPooled(torch.autograd.Function):
    """Pooled sums (n_bands, B, C, F) of raw bands, differentiable in every
    gi and gn: ``kernel`` (``band_pooled`` or a wrapper of it that counts its
    own launches), or the plain version without ``use_kernel``, forward; the
    backward is ``pooled_vjp`` per band."""

    @staticmethod
    def forward(ctx, luts, muls, k, use_kernel, kernel, *gi_and_gn):
        n = len(gi_and_gn) // 2
        ctx.save_for_backward(luts, *gi_and_gn)
        ctx.args = (muls, k, use_kernel)
        x, y = list(gi_and_gn[:n]), list(gi_and_gn[n:])
        if not use_kernel:
            return band_pooled_plain(x, y, luts, muls, k)
        return kernel(x, y, luts, muls, k)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        luts, *gi_and_gn = ctx.saved_tensors
        muls, k, use_kernel = ctx.args
        n = len(gi_and_gn) // 2
        grads = [pooled_vjp(gi, gn, luts[i], muls[i], k, use_kernel, g[i])
                 for i, (gi, gn) in enumerate(zip(gi_and_gn[:n], gi_and_gn[n:]))]
        return (None, None, None, None, None, *[a for a, _ in grads], *[b for _, b in grads])


def band_pooled_sums(gi_list, gn_list, luts: torch.Tensor, muls, k: BandConsts,
                     use_kernel: bool = True, kernel=band_pooled):
    """(n_bands, B, C, F) pooled sums through ``BandPooled``."""
    return BandPooled.apply(luts, muls, k, use_kernel, kernel, *gi_list, *gn_list)
