"""Metric base class (counterpart of ``colorvideovdp_tpu/metrics/base.py``)."""

from __future__ import annotations

import contextlib

import torch

from ..display import vvdp_display_geometry, vvdp_display_photometry
from ..io.video_source import video_source_array
from ..utils import spans


class vq_exception(Exception):
    """User-facing metric error (reference: vq_metric.py:7-9)."""


@contextlib.contextmanager
def no_tf32():
    """Full float32 for cuDNN convolutions and matrix products inside the
    block: both TF32 flags are set False and restored on exit, exceptions
    included, so that the metric's own calls keep float32 parity without
    changing the caller's settings. Used as a decorator on the metric's entry
    points; it applies on every device."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def metric_device(device) -> torch.device:
    """A metric's device: "cuda" (the default of every entry point, never
    replaced by the CPU) or "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class vq_metric:
    """Abstract video-quality metric."""

    def predict(self, test_cont, reference_cont, dim_order="BCFHW", frames_per_second=0):
        with spans.request("cvvdp.predict"):
            test_vs = video_source_array(
                test_cont, reference_cont, frames_per_second, dim_order=dim_order,
                display_photometry=self.display_photometry)
            return self.predict_video_source(test_vs)

    def predict_video_source(self, vid_source):
        raise NotImplementedError

    def set_display_model(self, display_name="standard_4k", display_photometry=None,
                          display_geometry=None, config_paths=None):
        config_paths = config_paths or []
        if display_photometry is None:
            self.display_photometry = vvdp_display_photometry.load(display_name, config_paths)
            self.display_name = display_name
        else:
            self.display_photometry = display_photometry
            self.display_name = getattr(display_photometry, "short_name", "unspecified")
        if display_geometry is None:
            self.display_geometry = vvdp_display_geometry.load(display_name, config_paths)
        else:
            self.display_geometry = display_geometry
        self.pix_per_deg = self.display_geometry.get_ppd()

    def set_base_fname(self, fname):
        """Base filename for any debug/auxiliary outputs."""
        self.base_fname = fname

    def full_name(self):
        return type(self).__name__

    def short_name(self):
        # Class name but '-' instead of '_' (reference: vq_metric.py:76-78)
        return type(self).__name__.replace("_", "-")

    def quality_unit(self):
        return ""

    def get_info_string(self):
        return None

    def train(self, do_training=True):
        pass

    def export_distogram(self, stats, fname, jod_max=None, base_size=6):
        raise vq_exception(f"Metric {self.short_name()} cannot generate distograms")


# Metric classes by name (the JAX package's registry; the CLI looks metrics up
# by ``short_name`` with "-" for "_").
vq_metric_dict = {}


def register_metric(metric_class):
    vq_metric_dict[metric_class.__name__] = metric_class
