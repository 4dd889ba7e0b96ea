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
  JAX package (``ops/pyramid.py:473-579``).
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

    def decompose(self, image, raw_pairs=False, use_kernel: bool = True):
        """``(contrast_bands, log10_L_bkg_bands)``; the log-luminance bands
        carry one channel, the reference's adaptation field. With
        ``raw_pairs`` the interior levels come back as raw ``(G_i, G_{i+1})``
        pairs with ``None`` log-luminance (the Weber contrast is then formed
        inside the band kernel); the baseband is the same either way.

        Adaptation, as in the JAX package: ``weber_g1_ref`` to the reference
        Y of the expanded next level, ``weber_g1`` each side to its own
        expanded Y, ``weber_g0_ref`` to the reference Y of G_i itself."""
        gpyr = self.gaussian_pyramid(image, self.height + 1, use_kernel)
        lpyr, L_bkg_pyr = [], []
        for i in range(len(gpyr)):
            if raw_pairs and i < len(gpyr) - 1:
                lpyr.append((gpyr[i], gpyr[i + 1]))
                L_bkg_pyr.append(None)
                continue
            if i == len(gpyr) - 1:
                layer = gpyr[i]
                if self.contrast.endswith("ref"):
                    L_bkg = clip(layer[..., 1:2, :, :, :], 0.01)
                else:
                    # Sustained channels adapt to the image mean; otherwise the
                    # baseband would divide by itself.
                    L_bkg = torch.mean(clip(layer[..., 0:2, :, :, :], 0.01), dim=(-1, -2),
                                       keepdim=True)
            else:
                glayer_ex = gausspyr_expand(gpyr[i + 1], gpyr[i].shape[-2:])
                layer = gpyr[i] - glayer_ex
                if self.contrast == "weber_g1_ref":
                    L_bkg = clip(glayer_ex[..., 1:2, :, :, :], 0.01)
                elif self.contrast == "weber_g1":
                    L_bkg = clip(glayer_ex[..., 0:2, :, :, :], 0.01)
                else:
                    L_bkg = clip(gpyr[i][..., 1:2, :, :, :], 0.01)
            if L_bkg.shape[-4] == 2:
                t = clip(layer[..., 0::2, :, :, :] / L_bkg[..., 0:1, :, :, :], hi=1000.0)
                r = clip(layer[..., 1::2, :, :, :] / L_bkg[..., 1:2, :, :, :], hi=1000.0)
                contrast = torch.stack([t, r], dim=-4).reshape(layer.shape)
                L_bkg = L_bkg[..., 1:2, :, :, :]
            else:
                contrast = clip(layer / L_bkg, hi=1000.0)
            lpyr.append(contrast)
            L_bkg_pyr.append(torch.log10(L_bkg))
        return lpyr, L_bkg_pyr


class LogContrastPyramid(LaplacianPyramid):
    """Log-luminance contrast: bands are G_i - expand(G_{i+1}) of the
    log-LMS DKL frames, with no division and no clip; the "log-luminance"
    the CSF reads is a (E_Y - b), with E_Y the reference's expanded Y (G_i
    itself at the baseband), used as the LUT input without a log10."""

    def __init__(self, W, H, ppd, contrast: str = "log"):
        super().__init__(W, H, ppd)
        self.contrast = contrast
        lms_d65 = [0.7347, 0.3163, 0.0208]
        self.a = 0.5
        self.b = (math.log10(lms_d65[0]) - math.log10(lms_d65[1])
                  + math.log10(lms_d65[0] + lms_d65[1]))

    def decompose(self, image, raw_pairs=False, use_kernel: bool = True):
        if raw_pairs:
            raise ValueError("the log contrast has no raw-pair decomposition")
        gpyr = self.gaussian_pyramid(image, self.height + 1, use_kernel)
        lpyr, L_bkg_pyr = [], []
        for i in range(len(gpyr)):
            if i == len(gpyr) - 1:
                contrast = gpyr[i]
                Y = gpyr[i][..., 1:2, :, :, :]
            else:
                glayer_ex = gausspyr_expand(gpyr[i + 1], gpyr[i].shape[-2:])
                contrast = gpyr[i] - glayer_ex
                Y = glayer_ex[..., 1:2, :, :, :]
            lpyr.append(contrast)
            L_bkg_pyr.append(self.a * (Y - self.b))
        return lpyr, L_bkg_pyr
