"""castleCSF LUT lookup: plain PyTorch version and the CUDA kernel wrapper.

Replaces ``colorvideovdp_tpu/ops/kernels/csf_lut.py:134`` (the padded 2-D
route of ``_make_lookup.forward``), forward only. Kernel:
``csrc/csf_lut.cu``; it is bound by memory (4 bytes read, 4*C written per
element) and evaluates the table as a segment lerp with a direct knot read.
"""

from __future__ import annotations

import torch

from . import _build


def csf_lut_plain(logL: torch.Tensor, luts: torch.Tensor, x0: float, x1: float):
    """``10 ** lerp(luts[c], logL)`` on a uniform grid over [x0, x1].

    logL: any shape; luts: (C, nk) float32 on logL's device.
    Returns (C, *logL.shape). The last knot is returned exactly."""
    nk = luts.shape[1]
    scale = (nk - 1) / (x1 - x0)
    ind = torch.clamp((logL - x0) * scale, 0.0, float(nk - 1))
    f0 = torch.floor(ind)
    i0 = torch.clamp(f0, max=nk - 2).long()
    v0 = luts[:, i0]
    v1 = luts[:, i0 + 1]
    v = v0 + (ind - f0) * (v1 - v0)
    v = torch.where(f0 >= nk - 1, luts[:, nk - 1].reshape((-1,) + (1,) * logL.ndim), v)
    return torch.pow(10.0, v)


def csf_lut(logL: torch.Tensor, luts: torch.Tensor, x0: float, x1: float):
    """CPU tensors take ``csf_lut_plain``; CUDA tensors launch the kernel."""
    if logL.device.type == "cpu":
        return csf_lut_plain(logL, luts, x0, x1)
    C, nk = luts.shape
    _build.require_cuda("csf_lut", logL, luts)
    if not 1 <= C <= 4 or nk < 2:
        raise ValueError(f"csf_lut: unsupported table shape {tuple(luts.shape)}")
    out = torch.empty((C,) + tuple(logL.shape), dtype=torch.float32, device=logL.device)
    lib = _build.library()
    rc = lib.cvvdp_csf_lut(logL.data_ptr(), out.data_ptr(), logL.numel(), C, nk,
                           luts.data_ptr(), float(x0), float((nk - 1) / (x1 - x0)),
                           _build.stream_handle(logL.device))
    _build.check_cuda(rc, "cvvdp_csf_lut")
    csf_lut.launches += 1
    return out


csf_lut.launches = 0
