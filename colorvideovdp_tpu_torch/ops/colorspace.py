"""Colour-space primitives: EOTF curves, opponent-colour matrices and PU21.

PyTorch counterpart of ``colorvideovdp_tpu/ops/colorspace.py``.
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

XYZ_to_RGB2020 = np.array(
    [
        [1.716502508360628, -0.355584689096764, -0.253375213570850],
        [-0.666625609145029, 1.616446566522207, 0.015775479726511],
        [0.017655211703087, -0.042810696059636, 0.942089263920533],
    ],
    dtype=np.float32,
)

XYZ_to_RGB709 = np.array(
    [
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
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


def lin2srgb(L: torch.Tensor) -> torch.Tensor:
    """Relative linear RGB (clipped to 0..1) to sRGB display-encoded values."""
    L = clip(L.to(torch.float32), 0.0, 1.0)
    return torch.where(L > 0.0031308, 1.055 * L ** (1.0 / 2.4) - 0.055, 12.92 * L)


def lin2pq(L: torch.Tensor) -> torch.Tensor:
    """Absolute linear (0.005..10000 cd/m^2) to PQ-encoded 0..1."""
    im_t = (clip(L.to(torch.float32), 0.0, PQ_LMAX) / PQ_LMAX) ** PQ_N
    return ((PQ_C2 * im_t + PQ_C1) / (1.0 + PQ_C3 * im_t)) ** PQ_M


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


def hlg_s(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.2100 HLG inverse OETF, per channel (the ingest kernel's table
    entry for HLG)."""
    return torch.where(
        rgb <= 0.5, torch.square(rgb) / 3.0,
        (torch.exp((rgb - HLG_C) / HLG_A) + HLG_B) / 12.0,
    )


def hlg_ootf(rgb_s: torch.Tensor, gamma: float) -> torch.Tensor:
    """The HLG OOTF of the inverse-OETF values; colour axis at -4."""
    w = torch.tensor(HLG_W, dtype=rgb_s.dtype, device=rgb_s.device).reshape(3, 1, 1, 1)
    Y_s = torch.sum(rgb_s * w, dim=-4, keepdim=True)
    return (Y_s ** (gamma - 1.0)) * rgb_s


def hlg2lin(rgb: torch.Tensor, gamma: float) -> torch.Tensor:
    """Rec.2100 HLG inverse-OETF + OOTF; colour axis at -4."""
    return hlg_ootf(hlg_s(rgb), gamma)


def apply_color_matrix(img: torch.Tensor, M: np.ndarray) -> torch.Tensor:
    """3x3 colour matrix along axis -4, as three weighted channel sums
    (the same summation order as the JAX package)."""
    rows = []
    for cc in range(3):
        w = torch.as_tensor(M[cc], dtype=img.dtype, device=img.device)
        rows.append(torch.sum(img * w.reshape(3, 1, 1, 1), dim=-4, keepdim=True))
    return torch.cat(rows, dim=-4)


def lms2006_to_dkld65(img: torch.Tensor) -> torch.Tensor:
    return apply_color_matrix(img, LMS2006_to_DKLd65)


def log10_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 log10, taken in float64 and rounded once: correctly rounded in
    all but rare cases, so the CPU, the card and the ingest kernel's log-LMS
    mode give the same bits."""
    return torch.log10(x.to(torch.float64)).to(torch.float32)


class PU:
    """PU21 perceptually-uniform encoding for HDR metric adaptation (the JAX
    package's ``ops/colorspace.py`` ``PU``). ``encode`` and ``decode`` take a
    tensor or a Python number and return a float32 tensor (on the CPU for a
    number)."""

    PARAMS = {
        "banding": [1.070275272, 0.4088273932, 0.153224308, 0.2520326168,
                    1.063512885, 1.14115047, 521.4527484],
        "banding_glare": [0.353487901, 0.3734658629, 8.277049286e-05, 0.9062562627,
                          0.09150303166, 0.9099517204, 596.3148142],
        "peaks": [1.043882782, 0.6459495343, 0.3194584211, 0.374025247,
                  1.114783422, 1.095360363, 384.9217577],
        "peaks_glare": [816.885024, 1479.463946, 0.001253215609, 0.9329636822,
                        0.06746643971, 1.573435413, 419.6006374],
    }

    def __init__(self, L_min=0.005, L_max=10000, type="banding_glare"):
        if type not in self.PARAMS:
            raise ValueError(f"Unknown type: {type}")
        self.L_min = L_min
        self.L_max = L_max
        self.p = self.PARAMS[type]
        p = self.p
        self.peak = p[6] * (
            ((p[0] + p[1] * L_max ** p[3]) / (1 + p[2] * L_max ** p[3])) ** p[4] - p[5])

    def encode(self, Y) -> torch.Tensor:
        p = self.p
        Y = clip(torch.as_tensor(Y, dtype=torch.float32), self.L_min, self.L_max)
        Y_p = Y ** p[3]
        return p[6] * (((p[0] + p[1] * Y_p) / (1 + p[2] * Y_p)) ** p[4] - p[5])

    def decode(self, V) -> torch.Tensor:
        p = self.p
        V = torch.as_tensor(V, dtype=torch.float32)
        V_p = clip(V / p[6] + p[5], 0.0) ** (1.0 / p[4])
        return (clip(V_p - p[0], 0.0) / (p[1] - p[2] * V_p)) ** (1.0 / p[3])
