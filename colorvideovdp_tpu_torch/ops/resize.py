"""Image resize with ``jax.image.resize``'s rules, for the file sources'
chroma upsampling and full-screen resize.

``torch.nn.functional.interpolate`` is another function: its bicubic uses
a = -0.75 where JAX's Keys cubic uses a = -0.5, and it does not antialias
when it shrinks, where JAX widens the kernel by the scale. So each axis gets
the weight matrix ``jax.image.resize`` builds (half-pixel centres, the
kernel widened when shrinking, columns normalised to sum to one, samples
outside the input zeroed), made in float32 numpy, and the image is
multiplied by it with ``torch.matmul`` in float32 (TF32 off). Nearest
picks floor((i + 0.5) * in / out) in float32, as JAX does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..metrics.base import no_tf32

_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=32)
def weight_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float32: output sample j = sum_i x[i] w[i, j]."""
    scale = n_out / n_in
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))  # antialias when shrinking
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
         / np.float32(kernel_scale)).astype(np.float32)
    w = _KERNELS[method](x).astype(np.float32)
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * _EPS32,
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    offsets = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in) \
        / np.float32(n_out)
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """Resize the last two axes of float32 ``x`` to ``size`` = (H, W) by
    "linear", "cubic" or "nearest"; an axis whose length does not change is
    left as it is, as in JAX."""
    H, W = size
    if method == "nearest":
        for dim, n in ((-2, H), (-1, W)):
            if x.shape[dim] != n:
                idx = torch.as_tensor(_nearest_index(x.shape[dim], n), device=x.device)
                x = x.index_select(x.ndim + dim, idx)
        return x
    if method not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    with no_tf32():
        if x.shape[-2] != H:
            w = torch.as_tensor(weight_matrix(x.shape[-2], H, method), device=x.device)
            x = torch.matmul(w.T, x)
        if x.shape[-1] != W:
            w = torch.as_tensor(weight_matrix(x.shape[-1], W, method), device=x.device)
            x = torch.matmul(x, w)
    return x
