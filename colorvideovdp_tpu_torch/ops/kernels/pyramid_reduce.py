"""Gaussian-pyramid reduce: CUDA kernel wrapper beside its plain version.

Replaces ``colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:195``
(``reduce_tpu``). Kernel: ``csrc/pyramid_reduce.cu``, one thread per output
with the edge corrections folded into per-index effective weights (both
passes keyed on H's parity, trap 1). It launches for every level and any
size with H, W >= 3: the TPU kernel's shape gate has no counterpart here.
The plain version is ``ops/pyramid.py:reduce_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pyramid import K5, reduce_plain
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
    if H < 3 or W < 3 or P > 65535:
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
