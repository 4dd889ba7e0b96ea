"""Colour-space primitives: EOTF curves and opponent-colour matrices.

PyTorch counterpart of ``colorvideovdp_tpu/ops/colorspace.py:18-127``.
Frames are BCFHW with the colour axis at ``-4``; all math is float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .clip import clip

XYZ_to_LMS2006 = np.array(
    [
        [0.187596268556126, 0.585168649077728, -0.026384263306304],
        [-0.133397430663221, 0.405505777260049, 0.034502127690364],
        [0.000244379021663, -0.000542995890619, 0.019406849066323],
    ],
    dtype=np.float32,
)

LMS2006_to_DKLd65 = np.array(
    [
        [1.0, 1.0, 0.0],
        [1.0, -2.311130179947035, 0.0],
        [-1.0, -1.0, 50.977571328718781],
    ],
    dtype=np.float32,
)

# SMPTE ST-2084 (PQ) constants.
PQ_LMAX = 10000.0
PQ_N = 0.15930175781250000
PQ_M = 78.843750000000000
PQ_C1 = 0.83593750000000000
PQ_C2 = 18.851562500000000
PQ_C3 = 18.687500000000000

HLG_A = 0.17883277
HLG_B = 1.0 - 4.0 * HLG_A
HLG_C = 0.5 - HLG_A * math.log(4.0 * HLG_A)
HLG_W = (0.2627, 0.6780, 0.0593)


def srgb2lin(p: torch.Tensor) -> torch.Tensor:
    """sRGB display-encoded values (0..1) to relative linear RGB."""
    return torch.where(p > 0.04045, ((p + 0.055) / 1.055) ** 2.4, p / 12.92)


def _pow_rn(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 x ** float32(y), correctly rounded in all but rare cases: the
    power is taken in float64 and rounded once."""
    return torch.pow(x.to(torch.float64), float(np.float32(y))).to(torch.float32)


def pq2lin(V: torch.Tensor) -> torch.Tensor:
    """PQ-encoded 0..1 to absolute linear cd/m^2, in float32 as the JAX
    package computes it. Near the display peak ``PQ_C2 - PQ_C3 * im_t``
    cancels, so the curve amplifies a last-ulp difference in ``im_t`` about
    500x: the two powers are rounded correctly (``_pow_rn``) rather than left
    to each platform's float32 pow, and the ingest kernel rounds every step
    the same way."""
    im_t = _pow_rn(V, 1.0 / PQ_M)
    return PQ_LMAX * _pow_rn(
        clip(im_t - PQ_C1, 0.0) / (PQ_C2 - PQ_C3 * im_t), 1.0 / PQ_N)


def hlg2lin(rgb: torch.Tensor, gamma: float) -> torch.Tensor:
    """Rec.2100 HLG inverse-OETF + OOTF; colour axis at -4."""
    rgb_s = torch.where(
        rgb <= 0.5, torch.square(rgb) / 3.0,
        (torch.exp((rgb - HLG_C) / HLG_A) + HLG_B) / 12.0,
    )
    w = torch.tensor(HLG_W, dtype=rgb.dtype, device=rgb.device).reshape(3, 1, 1, 1)
    Y_s = torch.sum(rgb_s * w, dim=-4, keepdim=True)
    return (Y_s ** (gamma - 1.0)) * rgb_s


def apply_color_matrix(img: torch.Tensor, M: np.ndarray) -> torch.Tensor:
    """3x3 colour matrix along axis -4, as three weighted channel sums
    (the same summation order as the JAX package)."""
    rows = []
    for cc in range(3):
        w = torch.as_tensor(M[cc], dtype=img.dtype, device=img.device)
        rows.append(torch.sum(img * w.reshape(3, 1, 1, 1), dim=-4, keepdim=True))
    return torch.cat(rows, dim=-4)
