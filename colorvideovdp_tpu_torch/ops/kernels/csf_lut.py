"""castleCSF LUT lookup and its derivative: plain versions, CUDA kernel
wrappers and the autograd Function.

Replaces ``colorvideovdp_tpu/ops/kernels/csf_lut.py``: the forward kernel
``_make_lookup.forward`` in both its routes, over the natural (..., H, W)
tiling (:114, a band's full log-luminance field) and over the padded 2-D
slab (:134, any shape), and the backward kernel ``_make_lookup.backward``
(:156, ``_bwd_kernel`` :63), the analytic d(10^interp)/dlogL. Kernels:
``csrc/csf_lut.cu``. Both are bound by memory: the forward reads 4 bytes and
writes 4*C per element, the backward reads 4*(1 + C) and writes 4; each
evaluates the table as a segment lerp with a direct knot read from the table
a block stages in shared memory, where the TPU ran a select chain because it
has no per-lane gather. A thread takes 4 consecutive elements with 16-byte
accesses where the planes are aligned, a scalar loop takes the rest.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from . import _build

LN10 = math.log(10.0)
MAX_TABLE = 12288  # C * nk floats: the kernels' 48 KiB of shared memory


def _index(logL, nk: int, x0: float, x1: float):
    """(unclamped index, clamped index, segment start) on the uniform grid."""
    raw = (logL - x0) * ((nk - 1) / (x1 - x0))
    ind = torch.clamp(raw, 0.0, float(nk - 1))
    return raw, ind, torch.floor(ind)


def csf_lut_plain(logL: torch.Tensor, luts: torch.Tensor, x0: float, x1: float):
    """``10 ** lerp(luts[c], logL)`` on a uniform grid over [x0, x1].

    logL: any shape; luts: (C, nk) float32 on logL's device.
    Returns (C, *logL.shape). The last knot is returned exactly."""
    nk = luts.shape[1]
    _, ind, f0 = _index(logL, nk, x0, x1)
    i0 = torch.clamp(f0, max=nk - 2).long()
    v0 = luts[:, i0]
    v1 = luts[:, i0 + 1]
    v = v0 + (ind - f0) * (v1 - v0)
    v = torch.where(f0 >= nk - 1, luts[:, nk - 1].reshape((-1,) + (1,) * logL.ndim), v)
    return torch.pow(10.0, v)


def csf_lut_bwd_plain(logL: torch.Tensor, g: torch.Tensor, luts: torch.Tensor,
                      x0: float, x1: float):
    """dL/dlogL from g = dL/dS, (C, *logL.shape), as the TPU backward kernel
    computes it: sum_c g_c 10^v_c ln10 slope_c dind, where slope_c is the
    segment's rise (0 at the last knot) and dind is the grid scale strictly
    inside (x0, x1) and 0 elsewhere, so the clip edges pass no gradient.
    (Autograd of ``csf_lut_plain`` would: ``torch.clamp`` passes it there.)"""
    nk = luts.shape[1]
    scale = (nk - 1) / (x1 - x0)
    raw, _, f0 = _index(logL, nk, x0, x1)
    i0 = torch.clamp(f0, max=nk - 2).long()
    slope = torch.where(f0 >= nk - 1, 0.0, luts[:, i0 + 1] - luts[:, i0])
    dind = torch.where((raw > 0.0) & (raw < float(nk - 1)), scale, 0.0)
    S = csf_lut_plain(logL, luts, x0, x1)
    acc = None
    for c in range(luts.shape[0]):
        term = g[c] * S[c] * LN10 * slope[c] * dind
        acc = term if acc is None else acc + term
    return acc


def _check_table(name: str, luts: torch.Tensor):
    C, nk = luts.shape
    if not 1 <= C <= 4 or nk < 2 or C * nk > MAX_TABLE:
        raise ValueError(f"{name}: unsupported table shape {tuple(luts.shape)}")
    return C, nk


def csf_lut(logL: torch.Tensor, luts: torch.Tensor, x0: float, x1: float):
    """CPU tensors take ``csf_lut_plain``; CUDA tensors launch the kernel."""
    if logL.device.type == "cpu":
        return csf_lut_plain(logL, luts, x0, x1)
    _build.require_cuda("csf_lut", logL, luts)
    C, nk = _check_table("csf_lut", luts)
    out = torch.empty((C,) + tuple(logL.shape), dtype=torch.float32, device=logL.device)
    lib = _build.library()
    rc = lib.cvvdp_csf_lut(logL.data_ptr(), out.data_ptr(), logL.numel(), C, nk,
                           luts.data_ptr(), float(x0), float((nk - 1) / (x1 - x0)),
                           _build.stream_handle(logL.device))
    _build.check_cuda(rc, "cvvdp_csf_lut")
    csf_lut.launches += 1
    return out


csf_lut.launches = 0


def csf_lut_bwd(logL: torch.Tensor, g: torch.Tensor, luts: torch.Tensor,
                x0: float, x1: float):
    """CPU tensors take ``csf_lut_bwd_plain``; CUDA tensors launch the kernel."""
    if logL.device.type == "cpu":
        return csf_lut_bwd_plain(logL, g, luts, x0, x1)
    _build.require_cuda("csf_lut_bwd", logL, g, luts)
    C, nk = _check_table("csf_lut_bwd", luts)
    if tuple(g.shape) != (C,) + tuple(logL.shape):
        raise ValueError(f"csf_lut_bwd: gradient {tuple(g.shape)} for logL {tuple(logL.shape)}")
    out = torch.empty_like(logL)
    lib = _build.library()
    rc = lib.cvvdp_csf_lut_bwd(logL.data_ptr(), g.data_ptr(), out.data_ptr(), logL.numel(),
                               C, nk, luts.data_ptr(), float(x0),
                               float((nk - 1) / (x1 - x0)), _build.stream_handle(logL.device))
    _build.check_cuda(rc, "cvvdp_csf_lut_bwd")
    csf_lut_bwd.launches += 1
    return out


csf_lut_bwd.launches = 0


class CsfLut(torch.autograd.Function):
    """The lookup with the TPU kernel's analytic derivative: ``csf_lut`` and
    ``csf_lut_bwd`` with ``use_kernel``, else their plain versions."""

    @staticmethod
    def forward(ctx, logL, luts, x0, x1, use_kernel):
        logL = logL.contiguous()
        ctx.save_for_backward(logL, luts)
        ctx.args = (x0, x1, use_kernel)
        return (csf_lut if use_kernel else csf_lut_plain)(logL, luts, x0, x1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        logL, luts = ctx.saved_tensors
        x0, x1, use_kernel = ctx.args
        fn = csf_lut_bwd if use_kernel else csf_lut_bwd_plain
        return fn(logL, g.contiguous(), luts, x0, x1), None, None, None, None
