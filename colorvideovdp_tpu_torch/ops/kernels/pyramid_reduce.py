"""Gaussian-pyramid reduce: CUDA kernel wrapper beside its plain version.

Replaces ``colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:195``
(``reduce_tpu``). Kernel: ``csrc/pyramid_reduce.cu``, which streams each
plane down strips of 256 output columns through a cp.async ring of input
rows and runs both passes in the plain version's order and rounding (both
keyed on H's parity, trap 1), so it gives the plain version's bits. It
launches for every level, any number of planes and any size with H, W >= 3:
the TPU kernel's shape gate has no counterpart here.
The plain version is ``ops/pyramid.py:reduce_plain``. ``Reduce`` is the
kernel with the adjoint of ``reduce_plain`` as its backward (the reduce is
linear), as ``colorvideovdp_tpu/ops/pyramid.py:140-161`` takes XLA's
transpose.

``pyramid_reduce_slab`` is the kernel's slab mode, the counterpart of
``colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:238`` (``reduce_slab_tpu``):
one rank's halo'd row slab of a level sharded over image rows
(``parallel/sharding.py`` ``sharded_reduce``), with the plain version
``ops/pyramid.py:reduce_slab_plain`` and the same bits. Forward only.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..pyramid import K5, reduce_plain, reduce_slab_plain
from . import _build

_K5 = np.ascontiguousarray(K5, np.float32)


def pyramid_reduce(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., ceil(H/2), ceil(W/2)). CPU tensors take
    ``reduce_plain``; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return reduce_plain(x)
    _build.require_cuda("pyramid_reduce", x)
    lead = tuple(x.shape[:-2])
    H, W = x.shape[-2:]
    P = int(np.prod(lead)) if lead else 1
    if H < 3 or W < 3:
        raise ValueError(f"pyramid_reduce: unsupported shape {tuple(x.shape)}")
    y = torch.empty(lead + ((H + 1) // 2, (W + 1) // 2), dtype=torch.float32,
                    device=x.device)
    lib = _build.library()
    rc = lib.cvvdp_pyramid_reduce(x.data_ptr(), y.data_ptr(), P, H, W, _K5.ctypes.data,
                                  _build.stream_handle(x.device))
    _build.check_cuda(rc, "cvvdp_pyramid_reduce")
    pyramid_reduce.launches += 1
    return y


pyramid_reduce.launches = 0


def pyramid_reduce_slab(x: torch.Tensor, rows_odd: bool) -> torch.Tensor:
    """(..., H_loc + 16, W) halo'd slab -> (..., H_loc / 2, ceil(W / 2)), no
    vertical edge corrections, the last-column branch keyed on the global
    row parity ``rows_odd``. CPU tensors take ``reduce_slab_plain``; CUDA
    tensors launch the kernel's slab mode."""
    lead = tuple(x.shape[:-2])
    H_loc, W = x.shape[-2] - 16, x.shape[-1]
    P = int(np.prod(lead)) if lead else 1
    if H_loc < 2 or H_loc % 2 or W < 3:
        raise ValueError(f"pyramid_reduce_slab: unsupported shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return reduce_slab_plain(x, rows_odd)
    _build.require_cuda("pyramid_reduce_slab", x)
    y = torch.empty(lead + (H_loc // 2, (W + 1) // 2), dtype=torch.float32, device=x.device)
    rc = _build.library().cvvdp_pyramid_reduce_slab(
        x.data_ptr(), y.data_ptr(), P, H_loc, W, int(bool(rows_odd)), _K5.ctypes.data,
        _build.stream_handle(x.device))
    _build.check_cuda(rc, "cvvdp_pyramid_reduce_slab")
    pyramid_reduce_slab.launches += 1
    return y


pyramid_reduce_slab.launches = 0


class Reduce(torch.autograd.Function):
    """``pyramid_reduce`` forward; the adjoint of ``reduce_plain`` backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return pyramid_reduce(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with torch.enable_grad():
            x0 = g.new_zeros(ctx.shape, requires_grad=True)
            (dx,) = torch.autograd.grad(reduce_plain(x0), x0, g)
        return dx
