"""Contrast masking models, pooling norms and the JOD mapping.

Counterpart of ``colorvideovdp_tpu/ops/masking.py``: every masking model of
``apply_masking_model`` (the 13 of the JAX package), the four difference
clamps and the cross-channel mix on or off, with the JAX package's quirks
kept (``per_channel`` clamping and ``_cm_transd`` size their per-channel
constants by the batch axis; ``mult-mutual-old`` reshapes ``q`` to 5-D).
Every ``jnp.maximum``/``jnp.clip`` becomes ``torch.maximum``/``clip`` against
a tensor, never ``torch.clamp``, so that a tie splits the gradient as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .blur import gaussian_blur
from .clip import clip

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
    d_max: float  # scalar, or per channel for the "per_channel" clamp
    ce_g: float | None = None
    k_c: float | None = None

    TEX_BLUR_SIGMA = 8.0

    @property
    def pu_kernel_size(self) -> int:
        return int(self.pu_dilate * 4) + 1

    @property
    def pu_padsize(self) -> int:
        return int(self.pu_dilate * 2)

    @property
    def tex_kernel_size(self) -> int:
        return int(self.TEX_BLUR_SIGMA * 4) + 1

    @property
    def tex_pad_size(self) -> int:
        return int(self.TEX_BLUR_SIGMA * 2)

    def xcm(self, num_ch: int) -> np.ndarray:
        """Cross-channel mixing weights 2^w as a (num_ch, num_ch) [c, d] array."""
        return np.power(2.0, np.asarray(self.xcm_weights, np.float32)).reshape(4, 4)[
            :num_ch, :num_ch].astype(np.float32)

    def blurs(self, h: int, w: int) -> bool:
        """phase_uncertainty's shape-based decision: blur only bands larger
        than the pad size."""
        return self.pu_dilate != 0 and h > self.pu_padsize and w > self.pu_padsize

    def fusable(self) -> bool:
        """The JAX package's gate for its fused band kernels
        (``metrics/cvvdp.py:1224-1232``), and so for the band kernel's routes:
        mult-mutual with the cross-channel mix and a soft scalar clamp."""
        return (self.masking_model == "mult-mutual" and self.do_xchannel_masking
                and self.dclamp_type == "soft" and np.asarray(self.d_max).size == 1)

    def check_supported(self):
        """Raise unless the band kernel takes this configuration."""
        if not self.fusable():
            raise ValueError(
                f"band kernel: masking model '{self.masking_model}', cross-channel mix "
                f"{self.do_xchannel_masking}, clamp '{self.dclamp_type}' is not its "
                "configuration")


def _channel_const(values, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(values, np.float32).reshape(shape), device=like.device)


def mask_pool(C: torch.Tensor, params: MaskingParams) -> torch.Tensor:
    """Cross-channel masking mix along axis -4: M[d] = sum_c C[c] * 2^w[c, d];
    without the mix each channel is scaled by its own weight 2^w[c, c]."""
    num_ch = C.shape[-4]
    w = params.xcm(num_ch)
    if not params.do_xchannel_masking:
        return C * _channel_const(np.diagonal(w), (1, num_ch, 1, 1, 1), C)
    out = []
    for d in range(num_ch):
        acc = None
        for c in range(num_ch):
            term = float(w[c, d]) * C[..., c:c + 1, :, :, :]
            acc = term if acc is None else acc + term
        out.append(acc)
    return torch.cat(out, dim=-4)


def phase_uncertainty(M: torch.Tensor, params: MaskingParams,
                      use_kernel: bool = False) -> torch.Tensor:
    """Gaussian dilation of the masking signal x 10^mask_c; the blur is
    skipped for bands not larger than the pad size (a shape-based decision).
    ``use_kernel`` takes the blur kernel (see ``ops/blur.py``)."""
    scale = 10.0 ** params.mask_c
    if params.blurs(M.shape[-2], M.shape[-1]):
        return gaussian_blur(M, params.pu_kernel_size, params.pu_dilate, use_kernel) * scale
    return M * scale


def clamp_diffs(D: torch.Tensor, params: MaskingParams) -> torch.Tensor:
    """Visual-difference clamping. The reference compares against a
    misspelled string, so the soft clamp applies on the default path (trap 3)."""
    if params.dclamp_type == "hard":
        return clip(D, hi=10.0 ** float(params.d_max))
    if params.dclamp_type == "soft":
        max_v = 10.0 ** params.d_max
        return max_v * D / (max_v + D)
    if params.dclamp_type == "none":
        return D
    if params.dclamp_type == "per_channel":
        # Sized by D.shape[0], the batch axis, as in the JAX package.
        num_ch = D.shape[0]
        max_v = _channel_const(np.power(10.0, np.asarray(params.d_max)[:num_ch]),
                               (-1, 1, 1, 1), D)
        return max_v * D / (max_v + D)
    raise RuntimeError(f"Unknown difference clamping type {params.dclamp_type}")


def pow_neg(x: torch.Tensor, p) -> torch.Tensor:
    """Sign-preserving power."""
    eps = x.new_full((), _EPS)
    return torch.maximum(x, eps) ** p + torch.maximum(-x, eps) ** p - _EPS ** p


def _cm_transd(C_p: torch.Tensor, params: MaskingParams, use_kernel: bool) -> torch.Tensor:
    # num_ch is the batch axis's length, as in the JAX package.
    num_ch = C_p.shape[0]
    q = _channel_const(np.asarray(params.mask_q, np.float32)[:num_ch], (num_ch, 1, 1, 1), C_p)
    M = phase_uncertainty(mask_pool(safe_pow(torch.abs(C_p), q), params), params, use_kernel)
    D_max = 10.0 ** params.d_max
    return D_max * pow_neg(C_p, params.mask_p) / (0.2 + M)


def apply_masking_model(T: torch.Tensor, R: torch.Tensor, S: torch.Tensor,
                        params: MaskingParams, use_kernel: bool = False) -> torch.Tensor:
    """Per-band distortion map D from (B, C, F, H, W) test/reference
    contrast and sensitivity. ``use_kernel`` takes the blur kernel for the
    phase-uncertainty and texture blurs."""
    model = params.masking_model
    num_ch = T.shape[-4]

    if model in ("mult-none", "add-transducer", "mult-transducer", "add-mutual",
                 "mult-mutual", "mult-mutual-old", "add-similarity", "mult-similarity",
                 "mult-transducer-texture", "add-transducer-texture"):
        if model.startswith("add"):
            ch_gain = _channel_const(np.array([1.0, 1.7, 0.237, 1.0], np.float32)[:num_ch],
                                     (1, num_ch, 1, 1, 1), T) * params.ce_g
            C_t = 1.0 / S
            zero = T.new_zeros(())
            T_p = torch.sign(T) * torch.maximum((torch.abs(T) - C_t) * ch_gain + 1.0, zero)
            R_p = torch.sign(R) * torch.maximum((torch.abs(R) - C_t) * ch_gain + 1.0, zero)
        elif model.endswith("mutual-old"):
            T_p = T * S
            R_p = R * S
        else:
            ch_gain = _channel_const(np.array([1.0, 1.45, 1.0, 1.0], np.float32)[:num_ch],
                                     (1, num_ch, 1, 1, 1), T)
            T_p = T * S * ch_gain
            R_p = R * S * ch_gain

        if model.endswith("none"):
            return clamp_diffs(torch.abs(T_p - R_p), params)

        if model.endswith("transducer"):
            return torch.abs(_cm_transd(T_p, params, use_kernel)
                             - _cm_transd(R_p, params, use_kernel))

        if model.endswith("mutual"):
            M_mm = phase_uncertainty(torch.minimum(torch.abs(T_p), torch.abs(R_p)), params,
                                     use_kernel)
            q = _channel_const(np.asarray(params.mask_q, np.float32)[:num_ch],
                               (num_ch, 1, 1, 1), T)
            M = mask_pool(safe_pow(torch.abs(M_mm), q), params)
            D_u = safe_pow(torch.abs(T_p - R_p), params.mask_p) / (1.0 + M)
            return clamp_diffs(D_u, params)

        if model.endswith("mutual-old"):
            M_mm = phase_uncertainty(torch.minimum(torch.abs(T_p), torch.abs(R_p)), params,
                                     use_kernel)
            q = _channel_const(np.asarray(params.mask_q, np.float32)[:num_ch],
                               (1, num_ch, 1, 1, 1), T)
            M = mask_pool(torch.abs(M_mm), params)
            D_m = safe_pow(torch.abs(T_p - R_p), params.mask_p) / (1.0 + safe_pow(M, q))
            return params.k_c * D_m / (params.k_c + D_m)

        if model.endswith("transducer-texture"):
            # Local texture statistics of the transduced responses.
            T_t = _cm_transd(T_p, params, use_kernel)
            R_t = _cm_transd(R_p, params, use_kernel)
            if T_p.shape[-2] <= params.tex_pad_size or T_p.shape[-1] <= params.tex_pad_size:
                return torch.abs(T_t - R_t)
            ks, sg = params.tex_kernel_size, params.TEX_BLUR_SIGMA
            mu_T = gaussian_blur(T_t, ks, sg, use_kernel)
            mu_R = gaussian_blur(R_t, ks, sg, use_kernel)
            sigma_T_sq = clip(gaussian_blur(T_t * T_t, ks, sg, use_kernel) - mu_T * mu_T, 0.0)
            sigma_R_sq = clip(gaussian_blur(R_t * R_t, ks, sg, use_kernel) - mu_R * mu_R, 0.0)
            return torch.abs(mu_T - mu_R) + torch.abs(torch.sqrt(sigma_T_sq)
                                                      - torch.sqrt(sigma_R_sq))

        # similarity
        T_p_m = phase_uncertainty(mask_pool(torch.abs(T_p), params), params, use_kernel)
        R_p_m = phase_uncertainty(mask_pool(torch.abs(R_p), params), params, use_kernel)
        D_max = 10.0 ** params.d_max
        eps = D_max - 1.0
        return D_max - D_max * (2.0 * torch.abs(T_p) * torch.abs(R_p) + eps) / (
            T_p_m * T_p_m + R_p_m * R_p_m + eps)

    if model in ("smooth_clamp_cont", "min_mutual_masking_perc_norm2", "fvvdp_ch_gain"):
        # The fvvdp family; it mixes channels only with the cross-channel mix on.
        if model == "fvvdp_ch_gain":
            ch_gain = _channel_const(np.array([1.0, 1.45, 1.0, 1.0], np.float32)[:num_ch],
                                     (num_ch, 1, 1, 1), T)
            T = T * S * ch_gain
            R = R * S * ch_gain
        else:
            T = T * S
            R = R * S
        M_pu = phase_uncertainty(torch.minimum(torch.abs(T), torch.abs(R)), params, use_kernel)
        M = mask_pool(M_pu, params) if params.do_xchannel_masking else M_pu
        q = _channel_const(np.asarray(params.mask_q, np.float32)[:num_ch], (num_ch, 1, 1, 1), T)
        p = params.mask_p
        G = torch.abs(T - R)
        if model == "smooth_clamp_cont":
            max_v = 10.0 ** params.d_max
            Gp = G ** p
            D_u = ((max_v * Gp + 1.0) / (max_v + Gp)) / (1.0 + safe_pow(M, q))
            # The reference compares against the misspelled "soft_clamp_cont",
            # so the clamp applies here too.
            return clamp_diffs(D_u, params)
        D_u = safe_pow(G, p) / (1.0 + safe_pow(M, q))
        return clamp_diffs(D_u, params)

    raise RuntimeError(f"Unknown masking model {model}")


def met2jod(Q, jod_a: float, jod_exp: float):
    """Distortion -> JOD, linearised below Q=0.1."""
    Q_t = 0.1
    jod_a_p = jod_a * Q_t ** (jod_exp - 1.0)
    return torch.where(Q <= Q_t, 10.0 - jod_a_p * Q,
                       10.0 - jod_a * clip(Q, Q_t) ** jod_exp)
