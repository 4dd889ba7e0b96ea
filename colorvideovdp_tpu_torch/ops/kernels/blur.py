"""Separable reflect blur: CUDA kernel wrapper and its autograd Function.

Replaces ``colorvideovdp_tpu/ops/kernels/blur_halo.py:209`` (``blur_tpu``,
``_blur_kernel`` :136 and ``apply_blur_tile`` :35), the standalone blur that
``phase_uncertainty`` runs when the masking model is differentiated. Kernel:
``csrc/blur.cu``: one block per 32x32 output tile of one image plane loads
the tile plus its r-halo into shared memory through the edge-excluded
reflect, runs the vertical taps into a second shared buffer, then the
horizontal taps, and writes each output once. It shares that tile code with
stage B of ``csrc/band_masking.cu`` (``csrc/common.cuh``). Bound on the H100:
memory, 4 bytes read (plus the halo, from L2) and 4 written per element; the
2 x 13 multiply-adds per element are far below the card's rate.

The plain version is ``ops/blur.py:blur_plain``. ``Blur``'s backward is the
adjoint of that plain chain (the blur is linear), as the JAX package takes
XLA's transpose of its own plain blur (``ops/blur.py:91-95``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..blur import blur_plain
from . import _build

MAX_TAPS = 17


def blur(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Blur the last two axes of ``x`` with the odd taps. CPU tensors take
    ``blur_plain``; CUDA tensors launch the kernel, which reflects once and
    so needs H, W > radius."""
    if x.device.type == "cpu":
        return blur_plain(x, taps)
    _build.require_cuda("blur", x)
    taps = np.ascontiguousarray(taps, np.float32)
    n = len(taps)
    r = (n - 1) // 2
    H, W = x.shape[-2:]
    if n % 2 != 1 or n > MAX_TAPS or H <= r or W <= r:
        raise ValueError(f"blur: {n} taps on a {H}x{W} plane is not supported")
    P = x.numel() // (H * W)
    y = torch.empty_like(x)
    lib = _build.library()
    rc = lib.cvvdp_blur(x.data_ptr(), y.data_ptr(), P, H, W, taps.ctypes.data, n,
                        _build.stream_handle(x.device))
    _build.check_cuda(rc, "cvvdp_blur")
    blur.launches += 1
    return y


blur.launches = 0


class Blur(torch.autograd.Function):
    """``blur`` forward; the adjoint of ``blur_plain`` backward."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.taps = taps
        ctx.shape = x.shape
        return blur(x.contiguous(), taps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with torch.enable_grad():
            x0 = g.new_zeros(ctx.shape, requires_grad=True)
            (dx,) = torch.autograd.grad(blur_plain(x0, ctx.taps), x0, g)
        return dx, None
