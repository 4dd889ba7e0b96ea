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
"""

from __future__ import annotations

import numpy as np
import torch

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
    if use_kernel:
        from .kernels.pyramid_reduce import pyramid_reduce

        return pyramid_reduce(x)
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

    def gaussian_pyramid(self, image, levels: int, use_kernel: bool = True):
        res = [image]
        for _ in range(1, levels):
            res.append(gausspyr_reduce(res[-1], use_kernel))
        return res


class WeberContrastPyramid(LaplacianPyramid):
    """Pyramid + Weber contrast for interleaved test/reference channels at
    axis -4 (test even, reference odd)."""

    def __init__(self, W, H, ppd, contrast: str = "weber_g1"):
        super().__init__(W, H, ppd)
        if contrast != "weber_g1":
            raise NotImplementedError(f"contrast '{contrast}' is not ported yet")
        self.contrast = contrast

    def decompose(self, image, raw_pairs=True, use_kernel: bool = True):
        """Interior levels come back as raw ``(G_i, G_{i+1})`` pairs (the
        Weber contrast is formed inside the band kernel); the baseband as
        its contrast tensor with the reference log-luminance (B, 1, F, 1, 1)."""
        if not raw_pairs:
            raise NotImplementedError("only the raw-pair decomposition is ported")
        gpyr = self.gaussian_pyramid(image, self.height + 1, use_kernel)
        lpyr = [(gpyr[i], gpyr[i + 1]) for i in range(len(gpyr) - 1)]
        L_bkg_pyr = [None] * (len(gpyr) - 1)
        layer = gpyr[-1]
        # weber_g1 baseband: sustained channels adapt to the image mean.
        L_bkg = torch.mean(torch.clamp(layer[..., 0:2, :, :, :], min=0.01),
                           dim=(-1, -2), keepdim=True)
        t = torch.clamp(layer[..., 0::2, :, :, :] / L_bkg[..., 0:1, :, :, :], max=1000.0)
        r = torch.clamp(layer[..., 1::2, :, :, :] / L_bkg[..., 1:2, :, :, :], max=1000.0)
        lpyr.append(torch.stack([t, r], dim=-4).reshape(layer.shape))
        L_bkg_pyr.append(torch.log10(L_bkg[..., 1:2, :, :, :]))
        return lpyr, L_bkg_pyr
