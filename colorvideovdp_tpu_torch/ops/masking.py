"""Contrast masking, pooling norms and the JOD mapping.

Counterpart of ``colorvideovdp_tpu/ops/masking.py``. Only the calibrated
default ``mult-mutual`` model with the soft clamp is ported; other models
raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .blur import gaussian_blur

_EPS = 1e-5


def safe_pow(x, p):
    """Power with an epsilon shift (p may be a tensor)."""
    return (x + _EPS) ** p - _EPS ** p


def _pow_static(x, p: float):
    """x**p for a constant exponent: small integer exponents become multiply
    chains (a transcendental pow biases large pooled sums)."""
    if p == 1.0:
        return x
    if p == 2.0:
        return x * x
    if p == 3.0:
        return x * x * x
    if p == 4.0:
        x2 = x * x
        return x2 * x2
    if p == 0.5:
        return torch.sqrt(x)
    if p == 0.25:
        return torch.sqrt(torch.sqrt(x))
    return x ** p


def _safe_pow_static(x, p: float):
    return _pow_static(x + _EPS, p) - _EPS ** p


def lp_norm(x: torch.Tensor, p, dim, normalize=True, keepdim=True) -> torch.Tensor:
    """Pooling norm along ``dim``. The reference's pooling exponents are
    tensors, so it always takes the epsilon-shifted branch
    safe_pow(sum(safe_pow(x, p)) / N, 1/p) (trap 2); replicated exactly."""
    if isinstance(dim, tuple):
        N = 1.0
        for dd in dim:
            N *= x.shape[dd]
    else:
        N = x.shape[dim]
    if not normalize:
        N = 1.0
    p = float(p)
    s = torch.sum(_safe_pow_static(x, p), dim=dim, keepdim=keepdim) / float(N)
    return _safe_pow_static(s, 1.0 / p)


@dataclass(frozen=True)
class MaskingParams:
    """Calibration constants consumed by the masking model."""

    masking_model: str
    mask_p: float
    mask_q: tuple  # per-channel exponents (4,)
    mask_c: float
    pu_dilate: float
    xcm_weights: tuple  # 16 cross-channel log-weights
    do_xchannel_masking: bool
    dclamp_type: str
    d_max: float

    @property
    def pu_kernel_size(self) -> int:
        return int(self.pu_dilate * 4) + 1

    @property
    def pu_padsize(self) -> int:
        return int(self.pu_dilate * 2)

    def xcm(self, num_ch: int) -> np.ndarray:
        """Cross-channel mixing weights 2^w as a (num_ch, num_ch) [c, d] array."""
        return np.power(2.0, np.asarray(self.xcm_weights, np.float32)).reshape(4, 4)[
            :num_ch, :num_ch].astype(np.float32)

    def blurs(self, h: int, w: int) -> bool:
        """phase_uncertainty's shape-based decision: blur only bands larger
        than the pad size."""
        return self.pu_dilate != 0 and h > self.pu_padsize and w > self.pu_padsize

    def check_supported(self):
        if self.masking_model != "mult-mutual":
            raise NotImplementedError(f"masking model '{self.masking_model}' is not ported yet")
        if not self.do_xchannel_masking:
            raise NotImplementedError("xchannel_masking 'off' is not ported yet")
        if self.dclamp_type != "soft" or np.asarray(self.d_max).size != 1:
            raise NotImplementedError(f"dclamp_type '{self.dclamp_type}' is not ported yet")


def mask_pool(C: torch.Tensor, params: MaskingParams) -> torch.Tensor:
    """Cross-channel masking mix along axis -4: M[d] = sum_c C[c] * 2^w[c, d]."""
    num_ch = C.shape[-4]
    w = params.xcm(num_ch)
    out = []
    for d in range(num_ch):
        acc = None
        for c in range(num_ch):
            term = float(w[c, d]) * C[..., c:c + 1, :, :, :]
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.cat(out, dim=-4)


def phase_uncertainty(M: torch.Tensor, params: MaskingParams) -> torch.Tensor:
    """Gaussian dilation of the masking signal x 10^mask_c; the blur is
    skipped for bands not larger than the pad size (a shape-based decision)."""
    scale = 10.0 ** params.mask_c
    if params.blurs(M.shape[-2], M.shape[-1]):
        return gaussian_blur(M, params.pu_kernel_size, params.pu_dilate) * scale
    return M * scale


def clamp_diffs(D: torch.Tensor, params: MaskingParams) -> torch.Tensor:
    """Soft clamp max_v * D / (max_v + D). The reference compares against a
    misspelled string, so the clamp applies on the default path (trap 3)."""
    if params.dclamp_type != "soft":
        raise NotImplementedError(f"dclamp_type '{params.dclamp_type}' is not ported yet")
    max_v = 10.0 ** params.d_max
    return max_v * D / (max_v + D)


def apply_masking_model(T: torch.Tensor, R: torch.Tensor, S: torch.Tensor,
                        params: MaskingParams) -> torch.Tensor:
    """Per-band distortion map for ``mult-mutual`` from (B, C, F, H, W)
    contrasts and sensitivity."""
    params.check_supported()
    num_ch = T.shape[-4]
    ch_gain = torch.as_tensor(np.array([1.0, 1.45, 1.0, 1.0], np.float32)[:num_ch],
                              device=T.device).reshape(1, num_ch, 1, 1, 1)
    T_p = T * S * ch_gain
    R_p = R * S * ch_gain
    M_mm = phase_uncertainty(torch.minimum(torch.abs(T_p), torch.abs(R_p)), params)
    q = torch.as_tensor(np.asarray(params.mask_q, np.float32)[:num_ch],
                        device=T.device).reshape(num_ch, 1, 1, 1)
    M = mask_pool(safe_pow(torch.abs(M_mm), q), params)
    D_u = safe_pow(torch.abs(T_p - R_p), params.mask_p) / (1.0 + M)
    return clamp_diffs(D_u, params)


def met2jod(Q, jod_a: float, jod_exp: float):
    """Distortion -> JOD, linearised below Q=0.1."""
    Q_t = 0.1
    jod_a_p = jod_a * Q_t ** (jod_exp - 1.0)
    return torch.where(Q <= Q_t, 10.0 - jod_a_p * Q,
                       10.0 - jod_a * torch.clamp(Q, min=Q_t) ** jod_exp)
