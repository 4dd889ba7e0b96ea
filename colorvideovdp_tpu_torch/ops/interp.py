"""LUT interpolation (counterpart of ``colorvideovdp_tpu/ops/interp.py``):
the host's row-wise lookup, and the non-uniform lookups on tensors."""

from __future__ import annotations

import numpy as np
import torch


def np_batch_interp1d(x, xp, fp):
    """Row-wise linear interpolation with linear extrapolation, numpy/fp32.

    ``fp`` is (rows, len(xp)); ``x`` is (rows,). The segment index is clamped
    to [0, len(xp)-2] and the ends extrapolate linearly.
    """
    x = np.asarray(x, np.float32)
    xp = np.asarray(xp, np.float32)
    fp = np.asarray(fp, np.float32)
    idx = np.clip(np.searchsorted(xp, x) - 1, 0, len(xp) - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    y0 = fp[np.arange(fp.shape[0]), idx]
    y1 = fp[np.arange(fp.shape[0]), idx + 1]
    slope = (y1 - y0) / (x1 - x0)
    return y0 + slope * (x - x0)


def linspace32(stop: float, num: int) -> np.ndarray:
    """float32 ``num`` points from 0 to ``stop`` as ``jnp.linspace(0, stop,
    num)`` forms them: stop * (i / (num - 1)), the quotient and the product
    in float32, the last point ``stop`` itself (XLA's rounding may put a
    point two ulps apart)."""
    stop = np.float32(stop)
    if num == 1:
        return np.zeros(1, np.float32)
    step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    return np.concatenate([stop * step, [stop]]).astype(np.float32)


def _interpolants_nonuniform(x_q: torch.Tensor, x: torch.Tensor):
    """Bucketed interpolants (imin, imax, fraction) of queries ``x_q`` on the
    sorted grid ``x``: out-of-range queries clamp, and the denominator carries
    the reference's 1e-6."""
    imax = torch.clamp(torch.searchsorted(x, x_q, right=True), max=x.shape[0] - 1)
    imin = torch.clamp(imax - 1, 0, x.shape[0] - 1)
    ifrc = (x_q - x[imin]) / (x[imax] - x[imin] + 1e-6)
    ifrc = torch.where(imax == imin, 0.0, ifrc)
    ifrc = torch.where(ifrc < 0.0, 0.0, ifrc)
    return imin, imax, ifrc


def interp1(x: torch.Tensor, v: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """Non-uniform 1-D LUT lookup of ``v`` sampled at ``x``."""
    imin, imax, ifrc = _interpolants_nonuniform(x_q, x)
    return v[imin] * (1.0 - ifrc) + v[imax] * ifrc


def interp1dim2(x: torch.Tensor, v: torch.Tensor, x_q: torch.Tensor) -> torch.Tensor:
    """Resample axis 1 of ``v`` (sampled at the 1-D ``x``) at the 1-D ``x_q``."""
    imin, imax, ifrc = _interpolants_nonuniform(x_q, x)
    sh = [1] * v.ndim
    sh[1] = ifrc.shape[0]
    ifrc = ifrc.reshape(sh)
    return v.index_select(1, imin) * (1.0 - ifrc) + v.index_select(1, imax) * ifrc
