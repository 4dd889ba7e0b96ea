"""Decimated Laplacian / Weber-contrast pyramids.

Counterpart of ``colorvideovdp_tpu/ops/pyramid.py``. Parity notes:

* ``reduce_plain`` is the zero-padded stride-2 5-tap filter plus the
  reference's explicit first/last-sample corrections. The last-sample branch
  of BOTH passes is keyed on the ROW count parity, a reference quirk kept on
  purpose (trap 1 of memory/cvvdp-parity-traps.md). The CUDA kernel for a
  level is ``kernels/pyramid_reduce.py``.
* ``gausspyr_expand`` is the polyphase form of the zero-interleaved upsample
  with the 1-sample edge pad (bit-equal to the JAX package's regrouping).
* Interior bands are scored at double gain (the reference stores them at
  half gain and doubles them on read).
* ``WeberContrastPyramid`` and ``LogContrastPyramid`` form the contrast
  bands and the CSF's adaptation field for every contrast coding of the
  JAX package (``ops/pyramid.py:473-579``); ``interior_contrast`` is the
  interior band's step, shared with the plain versions of the band kernel.
  Both pyramids also give raw ``(G_i, G_{i+1})`` pairs for the band kernel,
  which forms every coding from them itself.
* ``LaplacianPyramid.reconstruct`` collapses the per-band heatmap maps; it
  is XLA in the JAX package too, not a kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .clip import clip

KERNEL_A = 0.4
K5 = np.array([0.25 - KERNEL_A / 2, 0.25, KERNEL_A, 0.25, 0.25 - KERNEL_A / 2],
              dtype=np.float32)
# The log contrast's adaptation field a (Y - b) (reference lpyr_dec.py:418-458).
_LMS_D65 = (0.7347, 0.3163, 0.0208)
LOG_A = 0.5
LOG_B = (math.log10(_LMS_D65[0]) - math.log10(_LMS_D65[1])
         + math.log10(_LMS_D65[0] + _LMS_D65[1]))


def ceildiv(a: int, b: int) -> int:
    return -(-a // b)


def pyramid_band_freqs(W: int, H: int, ppd: float, min_freq: float = 0.2):
    """Per-band peak spatial frequencies (cpd) and the Laplacian level count."""
    max_levels = int(np.floor(np.log2(min(H, W)))) - 1
    bands = (np.concatenate([[1.0], np.power(2.0, -np.arange(0.0, 14.0)) * 0.3228], 0)
             * ppd / 2.0)
    invalid = np.nonzero(bands <= min_freq)[0]
    max_band = max_levels if invalid.size == 0 else invalid[0]
    height = int(np.clip(max_band + 1, 0, max_levels))
    band_freqs = np.array([1.0] + [0.3228 * 2.0 ** (-f) for f in range(height)]) * ppd / 2.0
    return band_freqs, height


def _sl(x: torch.Tensor, dim: int, start: int, stop: int, step: int = 1):
    if dim == -1:
        return x[..., start:stop:step]
    return x[..., start:stop:step, :]


def _reduce_1d(x: torch.Tensor, dim: int, odd_correction: bool) -> torch.Tensor:
    """One separable pass along ``dim`` (-1 or -2): zero-padded stride-2
    5-tap filter plus the first/last corrections (``odd_correction`` picks
    the last-sample branch)."""
    n = x.shape[dim]
    n_out = (n + 1) // 2
    pad = [0, 0, 2, 2] if dim == -2 else [2, 2]
    xp = torch.nn.functional.pad(x, pad)
    y = None
    for t in range(5):
        term = float(K5[t]) * _sl(xp, dim, t, t + 2 * n_out - 1, 2)
        y = term if y is None else y + term
    first = _sl(y, dim, 0, 1) + _sl(x, dim, 0, 1) * float(K5[1]) + _sl(x, dim, 1, 2) * float(K5[0])
    if odd_correction:
        last = (_sl(y, dim, n_out - 1, n_out) + _sl(x, dim, n - 1, n) * float(K5[3])
                + _sl(x, dim, n - 2, n - 1) * float(K5[4]))
    else:
        last = _sl(y, dim, n_out - 1, n_out) + _sl(x, dim, n - 1, n) * float(K5[4])
    if n_out > 2:
        return torch.cat([first, _sl(y, dim, 1, n_out - 1), last], dim=dim)
    return torch.cat([first, last], dim=dim)


def reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Gaussian reduce of the last two axes, (..., H, W) -> ceil halves."""
    rows_odd = (x.shape[-2] % 2) == 1
    y = _reduce_1d(x, -2, odd_correction=rows_odd)
    # NOTE: the horizontal pass keys its correction on the ROW parity.
    return _reduce_1d(y, -1, odd_correction=rows_odd)


def reduce_slab_plain(x: torch.Tensor, rows_odd: bool) -> torch.Tensor:
    """One rank's slab of a row-sharded reduce, the plain version of the slab
    kernel (the JAX package's ``reduce_slab_tpu``): ``x`` (..., H_loc + 16, W)
    holds the H_loc owned rows (even) with 8 real neighbour rows above and
    below (zeros at the global edges) -> (..., H_loc / 2, ceil(W / 2)). The
    vertical pass has no edge corrections (the caller adds them at the global
    edges); the horizontal pass keys its last-column branch on ``rows_odd``,
    the parity of the level's GLOBAL row count (trap 1)."""
    n_out = (x.shape[-2] - 16) // 2
    y = None
    for t in range(5):
        # Output row i reads slab rows 2i - 2 + t, buffer rows 2i + 6 + t.
        term = float(K5[t]) * x[..., 6 + t:6 + t + 2 * n_out - 1:2, :]
        y = term if y is None else y + term
    return _reduce_1d(y, -1, odd_correction=rows_odd)


def gausspyr_reduce(x: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """The reduce kernel (differentiable, ``kernels.pyramid_reduce.Reduce``)
    or the plain version under native autograd."""
    if use_kernel:
        from .kernels.pyramid_reduce import Reduce

        return Reduce.apply(x)
    return reduce_plain(x)


def _expand_1d(x: torch.Tensor, dim: int, exp_size: int) -> torch.Tensor:
    n = x.shape[dim]
    xp = torch.cat([_sl(x, dim, 0, 1), x, _sl(x, dim, n - 1, n)], dim=dim)
    n_even = (exp_size + 1) // 2
    n_odd = exp_size // 2
    ev = ((2.0 * float(K5[0])) * _sl(xp, dim, 0, n_even)
          + (2.0 * float(K5[2])) * _sl(xp, dim, 1, 1 + n_even)
          + (2.0 * float(K5[4])) * _sl(xp, dim, 2, 2 + n_even))
    od = ((2.0 * float(K5[1])) * _sl(xp, dim, 1, 1 + n_odd)
          + (2.0 * float(K5[3])) * _sl(xp, dim, 2, 2 + n_odd))
    ev_t = _sl(ev, dim, 0, n_odd) if n_even > n_odd else ev
    ax = dim % x.ndim
    sh = list(x.shape)
    sh[ax] = 2 * n_odd
    out = torch.stack([ev_t, od], dim=ax + 1).reshape(sh)
    if n_even > n_odd:
        out = torch.cat([out, _sl(ev, dim, n_even - 1, n_even)], dim=dim)
    return out


def gausspyr_expand(x: torch.Tensor, sz=None) -> torch.Tensor:
    """Gaussian pyramid expand of the last two axes to ``sz`` = (H, W)."""
    if sz is None:
        sz = (x.shape[-2] * 2, x.shape[-1] * 2)
    return _expand_1d(_expand_1d(x, -2, sz[0]), -1, sz[1])


def expand_rows(src: torch.Tensor, row0: int, hn: int, y: torch.Tensor, w: int) -> torch.Tensor:
    """Rows ``y`` (global row indices, any order) of ``gausspyr_expand(gn,
    (h, w))``, bit for bit, from ``src``, the rows of gn from global row
    ``row0`` on (a slab of it, or all of it with ``row0`` = 0); ``hn`` is gn's
    global row count. Each row is formed from its edge-clamped rows of gn as
    ``_expand_1d`` forms it, then the columns are expanded whole."""
    even = (y % 2) == 0
    m_e, m_o = y[even] // 2, y[~even] // 2

    def rows(idx):
        return src.index_select(-2, idx.clamp(0, hn - 1) - row0)

    k = [2.0 * float(K5[t]) for t in range(5)]
    ev = (k[0] * rows(m_e - 1) + k[2] * rows(m_e)) + k[4] * rows(m_e + 1)
    od = k[1] * rows(m_o) + k[3] * rows(m_o + 1)
    out = src.new_empty(src.shape[:-2] + (y.numel(), src.shape[-1]))
    out[..., even, :] = ev
    out[..., ~even, :] = od
    return _expand_1d(out, -1, w)


class LaplacianPyramid:
    """Static-shape decimated pyramid geometry and the Gaussian levels."""

    def __init__(self, W: int, H: int, ppd: float):
        self.W = W
        self.H = H
        self.ppd = ppd
        self.min_freq = 0.2
        self.band_freqs, self.height = pyramid_band_freqs(W, H, ppd, self.min_freq)
        self.pyr_shape = []
        cH, cW = H, W
        for _ in range(self.height + 1):
            self.pyr_shape.append((cH, cW))
            cH, cW = ceildiv(cH, 2), ceildiv(cW, 2)

    def get_freqs(self):
        return self.band_freqs.copy()

    def get_band_count(self) -> int:
        return self.height + 1

    @staticmethod
    def get_band(bands, band):
        """A band at full gain: interior bands are stored at half gain."""
        mul = 1.0 if band == 0 or band == len(bands) - 1 else 2.0
        return bands[band] * mul

    @staticmethod
    def set_band(bands, band, data):
        mul = 1.0 if band == 0 or band == len(bands) - 1 else 2.0
        bands[band] = data / mul

    def reconstruct(self, bands):
        """Collapse the pyramid: expand from the baseband up, adding each band."""
        img = bands[-1]
        for i in reversed(range(len(bands) - 1)):
            img = gausspyr_expand(img, bands[i].shape[-2:]) + bands[i]
        return img

    def gaussian_pyramid(self, image, levels: int, use_kernel: bool = True):
        res = [image]
        for _ in range(1, levels):
            res.append(gausspyr_reduce(res[-1], use_kernel))
        return res

    def decompose_sharded(self, image, mesh, use_kernel: bool = True):
        """The raw-pair decomposition of this rank's row slab ``image`` under
        ``mesh`` (``parallel/sharding.py``): the interior levels as pairs of
        ``sharding.Level`` objects, each the rank's slab of a row-sharded
        level or a whole, replicated one, with ``None`` fields, then the
        baseband and its field, whole on every rank."""
        from ..parallel.sharding import sharded_levels

        levels = sharded_levels(image, self.height + 1, mesh, use_kernel)
        base, field = self._contrast(levels[-1].full(mesh), None)
        n = len(levels)
        return ([(levels[i], levels[i + 1]) for i in range(n - 1)] + [base],
                [None] * (n - 1) + [field])


class WeberContrastPyramid(LaplacianPyramid):
    """Pyramid + Weber contrast for interleaved test/reference channels at
    axis -4 (test even, reference odd), for the contrasts ``weber_g1``,
    ``weber_g1_ref`` and ``weber_g0_ref``."""

    CONTRASTS = ("weber_g1", "weber_g1_ref", "weber_g0_ref")

    def __init__(self, W, H, ppd, contrast: str = "weber_g1"):
        super().__init__(W, H, ppd)
        if contrast not in self.CONTRASTS:
            raise RuntimeError(f"Contrast {contrast} not supported")
        self.contrast = contrast

    def decompose(self, image, raw_pairs=False, use_kernel: bool = True, mesh=None):
        """``(contrast_bands, log10_L_bkg_bands)``; the log-luminance bands
        carry one channel, the reference's adaptation field. With
        ``raw_pairs`` the interior levels come back as raw ``(G_i, G_{i+1})``
        pairs with ``None`` log-luminance (the Weber contrast is then formed
        inside the band kernel); the baseband is the same either way.

        Adaptation, as in the JAX package: ``weber_g1_ref`` to the reference
        Y of the expanded next level, ``weber_g1`` each side to its own
        expanded Y, ``weber_g0_ref`` to the reference Y of G_i itself.

        ``mesh`` (raw pairs only): ``decompose_sharded``."""
        if mesh is not None:
            if not raw_pairs:
                raise ValueError("a mesh takes the raw-pair decomposition only")
            return self.decompose_sharded(image, mesh, use_kernel)
        gpyr = self.gaussian_pyramid(image, self.height + 1, use_kernel)
        lpyr, L_bkg_pyr = [], []
        for i in range(len(gpyr)):
            if raw_pairs and i < len(gpyr) - 1:
                lpyr.append((gpyr[i], gpyr[i + 1]))
                L_bkg_pyr.append(None)
                continue
            contrast, logL = self._contrast(gpyr[i], gpyr[i + 1] if i < len(gpyr) - 1 else None)
            lpyr.append(contrast)
            L_bkg_pyr.append(logL)
        return lpyr, L_bkg_pyr

    def _contrast(self, g, g_next):
        """The contrast band of level ``g`` and its log10 adaptation field;
        ``g_next``, the next level, is None at the baseband."""
        if g_next is not None:
            return interior_contrast(g, gausspyr_expand(g_next, g.shape[-2:]), self.contrast)
        if self.contrast.endswith("ref"):
            L_bkg = clip(g[..., 1:2, :, :, :], 0.01)
        else:
            # Sustained channels adapt to the image mean; otherwise the
            # baseband would divide by itself.
            L_bkg = torch.mean(clip(g[..., 0:2, :, :, :], 0.01), dim=(-1, -2), keepdim=True)
        return _weber(g, L_bkg)


def _weber(layer, L_bkg):
    """clip(layer / L_bkg, 1000) and log10 of the reference's L_bkg; a
    two-channel L_bkg adapts test (even) and reference (odd) channels apart."""
    if L_bkg.shape[-4] == 2:
        t = clip(layer[..., 0::2, :, :, :] / L_bkg[..., 0:1, :, :, :], hi=1000.0)
        r = clip(layer[..., 1::2, :, :, :] / L_bkg[..., 1:2, :, :, :], hi=1000.0)
        contrast = torch.stack([t, r], dim=-4).reshape(layer.shape)
        L_bkg = L_bkg[..., 1:2, :, :, :]
    else:
        contrast = clip(layer / L_bkg, hi=1000.0)
    return contrast, torch.log10(L_bkg)


def interior_contrast(g, E, coding: str):
    """(contrast band, adaptation field) of an interior level ``g`` (axis -4
    interleaved test/reference) and ``E``, the expand of the next level, in
    ``coding``: Weber contrast (g - E) / L_bkg clipped at 1000 with log10
    L_bkg, where ``weber_g1_ref`` adapts to the reference Y of E,
    ``weber_g1`` each side to its own Y of E and ``weber_g0_ref`` to the
    reference Y of g itself; or ``log``, g - E with a (E_Y - b), the
    reference's Y of E, as the field (no log10)."""
    if coding == "log":
        return g - E, LOG_A * (E[..., 1:2, :, :, :] - LOG_B)
    if coding == "weber_g1_ref":
        L_bkg = clip(E[..., 1:2, :, :, :], 0.01)
    elif coding == "weber_g1":
        L_bkg = clip(E[..., 0:2, :, :, :], 0.01)
    elif coding == "weber_g0_ref":
        L_bkg = clip(g[..., 1:2, :, :, :], 0.01)
    else:
        raise RuntimeError(f"Contrast {coding} not supported")
    return _weber(g - E, L_bkg)


class LogContrastPyramid(LaplacianPyramid):
    """Log-luminance contrast: bands are G_i - expand(G_{i+1}) of the
    log-LMS DKL frames, with no division and no clip; the "log-luminance"
    the CSF reads is a (E_Y - b), with E_Y the reference's expanded Y (G_i
    itself at the baseband), used as the LUT input without a log10."""

    def __init__(self, W, H, ppd, contrast: str = "log"):
        super().__init__(W, H, ppd)
        self.contrast = contrast
        self.a, self.b = LOG_A, LOG_B

    def decompose(self, image, raw_pairs=False, use_kernel: bool = True, mesh=None):
        """``(bands, L_bkg_bands)``; with ``raw_pairs`` the interior levels
        come back as raw ``(G_i, G_{i+1})`` pairs with ``None`` fields (the
        band kernel forms the log contrast itself); the baseband is the same
        either way. ``mesh`` (raw pairs only): ``decompose_sharded``."""
        if mesh is not None:
            if not raw_pairs:
                raise ValueError("a mesh takes the raw-pair decomposition only")
            return self.decompose_sharded(image, mesh, use_kernel)
        gpyr = self.gaussian_pyramid(image, self.height + 1, use_kernel)
        lpyr, L_bkg_pyr = [], []
        for i in range(len(gpyr)):
            if raw_pairs and i < len(gpyr) - 1:
                lpyr.append((gpyr[i], gpyr[i + 1]))
                L_bkg_pyr.append(None)
                continue
            contrast, L_bkg = self._contrast(gpyr[i], gpyr[i + 1] if i < len(gpyr) - 1 else None)
            lpyr.append(contrast)
            L_bkg_pyr.append(L_bkg)
        return lpyr, L_bkg_pyr

    def _contrast(self, g, g_next):
        """The band of level ``g`` and its adaptation field; ``g_next``, the
        next level, is None at the baseband (the level itself, a (Y - b))."""
        if g_next is not None:
            return interior_contrast(g, gausspyr_expand(g_next, g.shape[-2:]), "log")
        return g, self.a * (g[..., 1:2, :, :, :] - self.b)
