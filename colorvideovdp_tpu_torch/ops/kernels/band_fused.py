"""The band mega-kernel route: expand, contrast, CSF, masking and pooling of
one raw band in one pass.

Replaces ``colorvideovdp_tpu/ops/kernels/band_fused.py:320``
(``band_fused_tpu``, wrapped by ``make_band_fused`` :346), which the JAX
package runs for the interior raw bands its gate admits when
``cvvdp.use_band_mega`` is set. Both modes read the band's Gaussian level
``gi`` (B, 2C, F, h, w) and the next level ``gn`` (B, 2C, F, ceil(h/2),
ceil(w/2)) and keep E = ``gausspyr_expand(gn)``, M_pre and diff in shared
memory and registers; both give the bits of the raw-pair route
(``masking_fused.band_masking`` / ``band_masking_d``) fed the plain expand.
Both are the one-pass kernel of the default route, ``csrc/band_pooled.cu``
(``band_pooled.launch`` for this one band), counted here, not in
``band_pooled.launches`` / ``band_pooled_d.launches``.

* ``band_fused``: the pooled sums (B, C, F) of safe_pow(D, beta). Its plain
  version ``band_fused_plain`` is ``band_pooled``'s.
* ``band_fused_d``: (D (B, C, F, h, w), the pooled sums (B, C, F)) for the
  heatmap, the kernel's D mode; plain version ``band_fused_d_plain``,
  ``band_pooled_d``'s.
* ``band_fused_sums``: the pooled sums, differentiable in ``gi`` and
  ``gn``, through ``band_pooled.BandPooled`` with ``band_fused`` launching;
  its backward recomputes the plain chain through ``gausspyr_expand`` per
  frame chunk, as JAX's ``fused_bwd`` recomputes ``jnp_impl``.
* ``can_band_fused``: the JAX package's shape gate (``band_fused.py:79-90``),
  which ``cvvdp._process_block`` applies as the JAX package does. The
  kernels themselves take any band shape.
"""

from __future__ import annotations

from . import band_pooled as bp
from .masking_fused import BandConsts

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


def band_fused_plain(gi, gn, lut, mul, k: BandConsts):
    """Plain PyTorch version of the pooled mode: sum(safe_pow(D, beta)) over
    each image plane, (B, C, F), per frame chunk as ``band_masking_plain``."""
    return bp.band_pooled_plain([gi], [gn], lut[None], [mul], k)[0]


def band_fused_d_plain(gi, gn, lut, mul, k: BandConsts):
    """Plain PyTorch version of the D mode: (D (B, C, F, h, w), the pooled
    sums (B, C, F))."""
    Ds, sums = bp.band_pooled_d_plain([gi], [gn], lut[None], [mul], k)
    return Ds[0], sums[0]


def band_fused(gi, gn, lut, mul, k: BandConsts):
    """Pooled sums (B, C, F) of one raw band from its level ``gi`` and the
    next level ``gn``; ``lut`` is the band's (C, nk) table. CPU tensors take
    ``band_fused_plain``; CUDA tensors launch the kernel."""
    if gi.device.type == "cpu":
        return band_fused_plain(gi, gn, lut, mul, k)
    out = bp.launch([gi], [gn], lut[None].contiguous(), [mul], k)[0]
    band_fused.launches += 1
    return out


band_fused.launches = 0


def band_fused_d(gi, gn, lut, mul, k: BandConsts):
    """(D (B, C, F, h, w), pooled sums (B, C, F)) of one raw band (the
    heatmap path). CPU tensors take ``band_fused_d_plain``; CUDA tensors
    launch the kernel's D mode."""
    if gi.device.type == "cpu":
        return band_fused_d_plain(gi, gn, lut, mul, k)
    Ds, sums = bp.launch([gi], [gn], lut[None].contiguous(), [mul], k, d_out=True)
    band_fused_d.launches += 1
    return Ds[0], sums[0]


band_fused_d.launches = 0


def _band_fused_list(gi_list, gn_list, luts, muls, k: BandConsts):
    return band_fused(gi_list[0], gn_list[0], luts[0], muls[0], k)[None]


def band_fused_sums(gi, gn, lut, mul, k: BandConsts, use_kernel: bool = True):
    """(B, C, F) pooled sums of one raw band, differentiable in ``gi`` and
    ``gn``."""
    return bp.band_pooled_sums([gi], [gn], lut[None], [mul], k, use_kernel, _band_fused_list)[0]
