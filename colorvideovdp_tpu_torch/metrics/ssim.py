"""Luma SSIM on display-encoded or PU21 values (counterpart of the JAX
package's ``metrics/ssim.py``): an 11x11 Gaussian window with sigma 1.5,
valid separable filtering, K = (0.01, 0.03), data range 1."""

from __future__ import annotations

import numpy as np
import torch

from .base import metric_device, register_metric, vq_metric


def _gauss_win(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords**2) / (2 * sigma**2))
    return g / g.sum()


def _filt2_valid(x: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable valid filtering over the last two axes, tap by tap in the
    JAX package's order (rows, then columns; taps summed first to last)."""
    k = len(win)
    for dim in (-2, -1):
        n = x.shape[dim] - k + 1
        acc = None
        for i in range(k):
            term = float(win[i]) * x.narrow(dim, i, n)
            acc = term if acc is None else acc + term
        x = acc
    return x


def ssim_index(X: torch.Tensor, Y: torch.Tensor, data_range: float = 1.0, win_size: int = 11,
               win_sigma: float = 1.5, K=(0.01, 0.03)) -> torch.Tensor:
    """Mean SSIM between two images or batches over the last two axes."""
    win = _gauss_win(win_size, win_sigma)
    K1, K2 = K
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    mu1 = _filt2_valid(X, win)
    mu2 = _filt2_valid(Y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filt2_valid(X * X, win) - mu1_sq
    sigma2_sq = _filt2_valid(Y * Y, win) - mu2_sq
    sigma12 = _filt2_valid(X * Y, win) - mu1_mu2
    cs_map = (2 * sigma12 + C2) / (sigma1_sq + sigma2_sq + C2)
    ssim_map = ((2 * mu1_mu2 + C1) / (mu1_sq + mu2_sq + C1)) * cs_map
    return torch.mean(ssim_map)


def get_luma(img: torch.Tensor) -> torch.Tensor:
    return (0.212656 * img[..., 0, :, :, :] + 0.715158 * img[..., 1, :, :, :]
            + 0.072186 * img[..., 2, :, :, :])


class ssim_metric(vq_metric):
    """Mean per-frame luma SSIM."""

    def __init__(self, display_name="standard_4k", display_photometry=None,
                 color_space="sRGB", device="cuda", config_paths=None):
        self.set_display_model(display_name=display_name,
                               display_photometry=display_photometry,
                               config_paths=config_paths)
        self.device = metric_device(device)
        self.color_space = color_space

    def predict_video_source(self, vid_source):
        """(mean SSIM, a 0-d tensor on the metric's device, None)."""
        _, _, N_frames = vid_source.get_video_size()
        acc = torch.zeros((), device=self.device)
        for ff in range(N_frames):
            T = get_luma(vid_source.get_test_frame(ff, device=self.device,
                                                   colorspace="display_encoded_100nit"))
            R = get_luma(vid_source.get_reference_frame(ff, device=self.device,
                                                        colorspace="display_encoded_100nit"))
            acc = acc + ssim_index(T, R)
        return acc / N_frames, None

    def short_name(self):
        return "SSIM"

    def quality_unit(self):
        return ""


# Registered, as in the JAX package, so that the CLI finds it as "ssim-metric".
register_metric(ssim_metric)
