"""The band mega-kernel route: expand, contrast, CSF, masking and pooling of
one raw band in one pass.

Replaces ``colorvideovdp_tpu/ops/kernels/band_fused.py:320``
(``band_fused_tpu``, wrapped by ``make_band_fused`` :346), which the JAX
package runs for the interior raw bands its gate admits when
``cvvdp.use_band_mega`` is set. The default raw-pair route materialises
E = ``gausspyr_expand(gn)`` for the band and the band kernel's M_pre and diff;
here the kernel reads the band's Gaussian level ``gi`` (B, 2C, F, h, w) and
the next level ``gn`` (B, 2C, F, ceil(h/2), ceil(w/2)) and keeps E, M_pre and
diff in shared memory and registers. Kernel: the fused mode of
``csrc/band_masking.cu`` (``expand = 1``), whose source note states its
bound: memory, 40 bytes per pixel pooled and 56 in D mode at C = 4. Its
expand rounds as ``ops/pyramid.py:_expand_1d``, so it gives the bits of the
raw-pair route (``masking_fused.band_masking``) fed the plain expand.

* ``band_fused`` / ``band_fused_d``: the pooled sums (B, C, F) of
  safe_pow(D, beta), or D (B, C, F, h, w) for the heatmap; CPU tensors take
  ``band_fused_plain`` / ``band_fused_d_plain``, which are the raw-pair
  route's plain chain (``masking_fused._band_D_plain``) fed
  ``gausspyr_expand(gn)``.
* ``BandFused``: the pooled sums, differentiable in ``gi`` and ``gn``; the
  backward recomputes the plain chain through ``gausspyr_expand`` per frame
  chunk, as JAX's ``fused_bwd`` recomputes ``jnp_impl``.
* ``can_band_fused``: the JAX package's shape gate (``band_fused.py:79-90``),
  which ``cvvdp._process_block`` applies as the JAX package does. The kernel
  itself takes any band shape.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..pyramid import gausspyr_expand
from .masking_fused import (BandConsts, _band_D_plain, _band_sums_plain, _frame_chunks,
                            _launch)

# The JAX kernel's row tile (``band_fused.py`` ``TH``); only the gate uses it.
TH = 16


def can_band_fused(C: int, H: int, W: int, kernel_size: int, min_w: int = 512) -> bool:
    """The JAX package's gate for the mega-kernel route: blur taps of odd
    count with radius <= 8, W % 256 == 0 within [min_w, 4096], H % 8 == 0,
    H >= 48 and at least two of its 16-row tiles. ``min_w`` is 256 with the
    metric's ``force_fused``."""
    if kernel_size % 2 != 1 or (kernel_size - 1) // 2 > 8:
        return False
    if W % 256 != 0 or not (min_w <= W <= 4096):
        return False
    if H % 8 != 0 or H < 48:
        return False
    return -(-H // TH) >= 2


def _expanded(gi, gn):
    return gausspyr_expand(gn, gi.shape[-2:])


def band_fused_plain(gi, gn, lut, mul, k: BandConsts, use_kernel: bool = False):
    """Plain PyTorch version of the pooled mode: sum(safe_pow(D, beta)) over
    each image plane, (B, C, F), per frame chunk as ``band_masking_plain``."""
    return torch.cat([_band_sums_plain(gi[:, :, fs], _expanded(gi[:, :, fs], gn[:, :, fs]),
                                       lut, mul, k, use_kernel)
                      for fs in _frame_chunks(gi)], dim=2)


def band_fused_d_plain(gi, gn, lut, mul, k: BandConsts):
    """Plain PyTorch version of the D mode: D (B, C, F, h, w)."""
    return torch.cat([_band_D_plain(gi[:, :, fs], _expanded(gi[:, :, fs], gn[:, :, fs]),
                                    lut, mul, k)
                      for fs in _frame_chunks(gi)], dim=2)


def band_fused(gi, gn, lut, mul, k: BandConsts):
    """Pooled sums (B, C, F) of one raw band from its level ``gi`` and the
    next level ``gn``; ``lut`` is the band's (C, nk) table. CPU tensors take
    ``band_fused_plain``; CUDA tensors launch the kernel."""
    if gi.device.type == "cpu":
        return band_fused_plain(gi, gn, lut, mul, k)
    out = _launch([gi], [gn], lut[None].contiguous(), [mul], k, d_out=False, expand=True)[0]
    band_fused.launches += 1
    return out


band_fused.launches = 0


def band_fused_d(gi, gn, lut, mul, k: BandConsts):
    """D (B, C, F, h, w) of one raw band (the heatmap path). CPU tensors take
    ``band_fused_d_plain``; CUDA tensors launch the kernel."""
    if gi.device.type == "cpu":
        return band_fused_d_plain(gi, gn, lut, mul, k)
    D = _launch([gi], [gn], lut[None].contiguous(), [mul], k, d_out=True, expand=True)[0]
    band_fused_d.launches += 1
    return D


band_fused_d.launches = 0


class BandFused(torch.autograd.Function):
    """Pooled sums (B, C, F) of one raw band, differentiable in ``gi`` and
    ``gn``: ``band_fused`` (or the plain version without ``use_kernel``)
    forward; the backward recomputes the plain chain through
    ``gausspyr_expand`` per frame chunk and returns its vector-Jacobian
    product for both levels."""

    @staticmethod
    def forward(ctx, lut, mul, k, use_kernel, gi, gn):
        ctx.save_for_backward(lut, gi, gn)
        ctx.args = (mul, k, use_kernel)
        if not use_kernel:
            return band_fused_plain(gi, gn, lut, mul, k)
        return band_fused(gi, gn, lut, mul, k)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        lut, gi, gn = ctx.saved_tensors
        mul, k, use_kernel = ctx.args
        d_gi, d_gn = torch.zeros_like(gi), torch.zeros_like(gn)
        for fs in _frame_chunks(gi):
            with torch.enable_grad():
                gi_c = gi[:, :, fs].detach().requires_grad_()
                gn_c = gn[:, :, fs].detach().requires_grad_()
                s = _band_sums_plain(gi_c, _expanded(gi_c, gn_c), lut, mul, k, use_kernel)
                d_gi[:, :, fs], d_gn[:, :, fs] = torch.autograd.grad(s, (gi_c, gn_c), g[:, :, fs])
        return None, None, None, None, d_gi, d_gn


def band_fused_sums(gi, gn, lut, mul, k: BandConsts, use_kernel: bool = True):
    """(B, C, F) pooled sums of one raw band through ``BandFused``."""
    return BandFused.apply(lut, mul, k, use_kernel, gi, gn)
