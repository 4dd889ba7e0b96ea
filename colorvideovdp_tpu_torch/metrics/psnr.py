"""PSNR metrics (counterpart of the JAX package's ``metrics/psnr.py``).

Frames come through the per-frame API on the metric's device; the squared
errors are summed there and only the final score leaves it."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.colorspace import PU
from .base import metric_device, register_metric, vq_metric


class psnr_rgb(vq_metric):
    """PSNR on display-encoded RGB; HDR and linear content PU21-encoded."""

    def __init__(self, display_name="standard_4k", display_photometry=None, device="cuda",
                 config_paths=None):
        self.set_display_model(display_name=display_name,
                               display_photometry=display_photometry,
                               config_paths=config_paths)
        self.device = metric_device(device)

    def predict_video_source(self, vid_source):
        """(PSNR (B,) in dB on the metric's device, None)."""
        _, _, N_frames = vid_source.get_video_size()
        mse = torch.zeros((vid_source.get_batch_size(),), device=self.device)
        for ff in range(N_frames):
            T = vid_source.get_test_frame(ff, device=self.device,
                                          colorspace="display_encoded_100nit")
            R = vid_source.get_reference_frame(ff, device=self.device,
                                               colorspace="display_encoded_100nit")
            mse = mse + torch.mean((T - R) ** 2, dim=(1, 2, 3, 4))
        max_I = 1.0
        return 20.0 * torch.log10(max_I / torch.sqrt(mse / N_frames)), None

    def short_name(self):
        return "PSNR-RGB"

    def quality_unit(self):
        return "dB"


class pu_psnr_y(vq_metric):
    """PU21-PSNR on luminance. As in the reference metric, the squared error
    is taken on the unencoded luminance: the PU encoding sets only the peak
    value."""

    def __init__(self, display_name="standard_4k", display_photometry=None,
                 color_space="sRGB", device="cuda", config_paths=None):
        self.set_display_model(display_name=display_name,
                               display_photometry=display_photometry,
                               config_paths=config_paths)
        self.device = metric_device(device)
        self.color_space = color_space
        self.pu = PU()
        self.max_I = float(np.asarray(self.pu.encode(100.0)))
        self.metric_colorspace = "Y"

    def predict_video_source(self, vid_source):
        """(PSNR (B,) in dB on the metric's device, None)."""
        _, _, N_frames = vid_source.get_video_size()
        mse = torch.zeros((vid_source.get_batch_size(),), device=self.device)
        for ff in range(N_frames):
            T = vid_source.get_test_frame(ff, device=self.device,
                                          colorspace=self.metric_colorspace)
            R = vid_source.get_reference_frame(ff, device=self.device,
                                               colorspace=self.metric_colorspace)
            mse = mse + torch.mean((T - R) ** 2, dim=(1, 2, 3, 4))
        return 20.0 * torch.log10(self.max_I / torch.sqrt(mse / N_frames)), None

    def psnr_fn(self, img1, img2):
        mse = torch.mean((img1 - img2) ** 2)
        return 20.0 * torch.log10(self.pu.peak / torch.sqrt(mse))

    def short_name(self):
        return "PU21-PSNR-Y"

    def quality_unit(self):
        return "dB"


class pu_psnr_rgb2020(pu_psnr_y):
    """PU21-PSNR on linear BT.2020 RGB (the same unencoded error as
    ``pu_psnr_y``)."""

    def __init__(self, display_name="standard_4k", display_photometry=None,
                 color_space="sRGB", device="cuda", config_paths=None):
        super().__init__(display_name=display_name, display_photometry=display_photometry,
                         color_space=color_space, device=device, config_paths=config_paths)
        self.metric_colorspace = "RGB2020"

    def short_name(self):
        return "PU21-PSNR-RGB2020"


register_metric(psnr_rgb)
register_metric(pu_psnr_y)
register_metric(pu_psnr_rgb2020)
