"""Temporal channel filters (sustained low-pass x3 + transient band-pass).

Counterpart of ``colorvideovdp_tpu/ops/temporal.py``: taps are built on the
host in frequency space and inverted with a real IFFT.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_temporal_filters(fps: float, sigma_tf, beta_tf, temp_filter: str = "default"):
    """Return (F, omega_bands): four FIR filters of odd length
    ceil(0.25s * fps) and the temporal band frequencies [0, 5] Hz."""
    sigma_tf = np.asarray(sigma_tf, np.float32)
    beta_tf = np.asarray(beta_tf, np.float32)
    N = int(math.ceil(0.250 * fps / 2) * 2) + 1
    N_omega = N // 2 + 1
    omega = np.linspace(0.0, fps / 2.0, N_omega, dtype=np.float32)[None, :]

    R = np.empty((4, N_omega), np.float32)
    R[0:3, :] = np.exp(-(omega ** beta_tf[0:3, None]) / sigma_tf[0:3, None])
    omega_bands = np.array([0.0, 5.0], np.float32)
    if temp_filter == "hp_trans":
        R[3:4, :] = 1.0 - R[0:1, :]
    else:
        R[3:4, :] = np.exp(
            -((omega ** beta_tf[3] - omega_bands[1] ** beta_tf[3]) ** 2) / sigma_tf[3])

    F = []
    for kk in range(4):
        if temp_filter == "grad_trans" and kk == 3:
            r = np.zeros((N,), np.float32)
            r[0] = 1.0
            r[2] = -1.0
        else:
            r = np.fft.fftshift(np.real(np.fft.irfft(R[kk, :], n=N))).astype(np.float32)
        F.append(r)
    return F, omega_bands


def apply_temporal_filters(sw_buf: torch.Tensor, filters_flipped: np.ndarray) -> torch.Tensor:
    """(B, 3, fl + nf - 1, H, W) DKL frames -> (B, 4, nf, H, W) channels
    Y-sust, rg, yv, Y-trans. ``filters_flipped`` is (4, fl), time-reversed
    so that the tap sum is the sliding correlation."""
    fl = filters_flipped.shape[1]
    nf = sw_buf.shape[2] - fl + 1
    buf4 = torch.cat([sw_buf, sw_buf[:, 0:1]], dim=1)
    w = torch.as_tensor(np.asarray(filters_flipped, np.float32), device=sw_buf.device)
    out = None
    for t in range(fl):
        term = buf4[:, :, t:t + nf] * w[:, t].reshape(1, 4, 1, 1, 1)
        out = term if out is None else out + term
    return out
