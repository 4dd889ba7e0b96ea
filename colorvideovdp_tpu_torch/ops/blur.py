"""Separable Gaussian blur with reflect (edge-excluded) padding.

Counterpart of ``colorvideovdp_tpu/ops/blur.py:19-61``: the 1-D kernel
exp(-0.5 (x/sigma)^2) normalised to 1, applied along H then W, each pass a
sequential sum of shifted slices. ``blur_plain`` is the plain version of the
blur kernel (``kernels/blur.py``), and its autograd is the kernel's backward.
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
