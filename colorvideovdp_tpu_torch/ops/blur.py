"""Separable Gaussian blur with reflect (edge-excluded) padding.

Counterpart of ``colorvideovdp_tpu/ops/blur.py:19-61``: the 1-D kernel
exp(-0.5 (x/sigma)^2) normalised to 1, applied along H then W, each pass a
sequential sum of shifted slices. ``blur_plain`` is the plain version of the
blur kernel (``kernels/blur.py``) and ``blur_adjoint_plain`` that of its
adjoint mode; autograd of ``blur_plain`` is ``Blur``'s backward on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) * 0.5
    x = np.linspace(-half, half, kernel_size, dtype=np.float32)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return pdf / pdf.sum()


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    idx = np.pad(np.arange(n), (r, r), mode="reflect")
    return torch.as_tensor(idx, device=device)


def _blur_1d(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    r = (len(k) - 1) // 2
    n = x.shape[dim]
    xp = x.index_select(dim, _reflect_index(n, r, x.device))
    y = None
    for i in range(len(k)):
        term = float(k[i]) * xp.narrow(dim, i, n)
        y = term if y is None else y + term
    return y


def blur_plain(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable blur of the last two axes with the odd 1-D taps ``k``."""
    return _blur_1d(_blur_1d(x, k, x.ndim - 2), k, x.ndim - 1)


def _adjoint_1d(g: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """The adjoint of ``_blur_1d``: correlate g with the reversed taps over
    the axis extended by r zeros on each side (u_m for m in [-r, n - 1 + r]),
    then fold the extended samples onto their reflections, the left fold
    (u_{-j} onto j) first, then the right (u_{n-1+j} onto n - 1 - j)."""
    r = (len(k) - 1) // 2
    n = g.shape[dim]
    if r == 0:
        return float(k[0]) * g
    zeros = g.new_zeros(g.shape[:dim] + (2 * r,) + g.shape[dim + 1:])
    gp = torch.cat([zeros, g, zeros], dim)  # gp[a] = g[a - 2r]
    u = None
    for i in range(len(k)):
        term = float(k[len(k) - 1 - i]) * gp.narrow(dim, i, n + 2 * r)  # u[a] = u_{a - r}
        u = term if u is None else u + term
    z = u.narrow(dim, r, n).clone()
    z.narrow(dim, 1, r).add_(u.narrow(dim, 0, r).flip(dim))
    z.narrow(dim, n - 1 - r, r).add_(u.narrow(dim, n + r, r).flip(dim))
    return z


def blur_adjoint_plain(g: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """The adjoint of ``blur_plain`` (its vector-Jacobian product with g), as
    the blur kernel's adjoint mode computes it: the vertical pass's adjoint,
    then the horizontal's (the two act on different axes, so the order
    changes only the rounding)."""
    return _adjoint_1d(_adjoint_1d(g, k, g.ndim - 2), k, g.ndim - 1)


def gaussian_blur(x: torch.Tensor, kernel_size: int, sigma: float,
                  use_kernel: bool = False) -> torch.Tensor:
    """Blur the last two axes of ``x``: through the differentiable blur
    kernel (``kernels.blur.Blur``) with ``use_kernel``, else the plain version
    under native autograd."""
    k = gaussian_kernel1d(kernel_size, sigma)
    if use_kernel:
        from .kernels.blur import Blur

        return Blur.apply(x, k)
    return blur_plain(x, k)
