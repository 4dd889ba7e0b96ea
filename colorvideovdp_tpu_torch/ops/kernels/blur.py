"""Separable reflect blur and its adjoint: CUDA kernel wrappers and the
autograd Function.

Replaces ``colorvideovdp_tpu/ops/kernels/blur_halo.py:209`` (``blur_tpu``,
``_blur_kernel`` :136 and ``apply_blur_tile`` :35), the standalone blur that
``phase_uncertainty`` runs when the masking model is differentiated or the
band takes the generic masking chain, and the 33-tap texture blur of the
``*-transducer-texture`` models (the TPU kernel stops at 17 taps), and the
VJP of ``blur_tpu`` (the JAX package takes XLA's transpose of its plain blur,
``colorvideovdp_tpu/ops/blur.py:85-95``). Kernel: ``csrc/blur.cu``, one
streaming kernel with the radius as a template argument and an adjoint mode:
a block walks down a strip of one plane, rows stream through a cp.async ring
in shared memory, the vertical taps are summed in registers and the
horizontal taps from a one-chunk buffer, and each output is stored once.
Bound on the H100: bytes at 13 taps (4 read and 4 written an element), the
float32 pipe at 33 (130 instructions an element, no FMA).

The plain versions are ``ops/blur.py:blur_plain`` and ``blur_adjoint_plain``
(the same steps and order as the adjoint mode). ``Blur``'s backward launches
the adjoint mode on the card and is autograd of ``blur_plain`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..blur import blur_adjoint_plain, blur_plain
from . import _build

MAX_TAPS = 33


def _launch(name: str, x: torch.Tensor, taps: np.ndarray, adjoint: int) -> torch.Tensor:
    x = x.contiguous()
    _build.require_cuda(name, x)
    taps = np.ascontiguousarray(taps, np.float32)
    n = len(taps)
    r = (n - 1) // 2
    H, W = x.shape[-2:]
    if n % 2 != 1 or n > MAX_TAPS or H <= r or W <= r:
        raise ValueError(f"{name}: {n} taps on a {H}x{W} plane is not supported")
    y = torch.empty_like(x)
    rc = _build.library().cvvdp_blur(x.data_ptr(), y.data_ptr(), x.numel() // (H * W), H, W,
                                     taps.ctypes.data, n, adjoint, _build.stream_handle(x.device))
    _build.check_cuda(rc, "cvvdp_blur")
    return y


def blur(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Blur the last two axes of ``x`` with the odd taps. CPU tensors take
    ``blur_plain``; CUDA tensors launch the kernel, which reflects once and
    so needs H, W > radius."""
    if x.device.type == "cpu":
        return blur_plain(x, taps)
    y = _launch("blur", x, taps, 0)
    blur.launches += 1
    return y


blur.launches = 0


def blur_adjoint(g: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """The adjoint of ``blur`` applied to ``g`` (the gradient of the blur's
    output): CPU tensors take ``blur_adjoint_plain``; CUDA tensors launch the
    kernel's adjoint mode (H, W > radius, as the forward)."""
    if g.device.type == "cpu":
        return blur_adjoint_plain(g, taps)
    y = _launch("blur_adjoint", g, taps, 1)
    blur_adjoint.launches += 1
    return y


blur_adjoint.launches = 0


class Blur(torch.autograd.Function):
    """``blur`` forward; backward ``blur_adjoint`` on the card, autograd of
    ``blur_plain`` on the CPU."""

    @staticmethod
    def forward(ctx, x, taps):
        ctx.taps = taps
        ctx.shape = x.shape
        return blur(x, taps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if g.device.type == "cuda":
            return blur_adjoint(g, ctx.taps), None
        with torch.enable_grad():
            x0 = g.new_zeros(ctx.shape, requires_grad=True)
            (dx,) = torch.autograd.grad(blur_plain(x0, ctx.taps), x0, g)
        return dx, None

