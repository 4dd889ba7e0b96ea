"""Metric base class (counterpart of ``colorvideovdp_tpu/metrics/base.py``)."""

from __future__ import annotations

from ..display import vvdp_display_geometry, vvdp_display_photometry
from ..io.video_source import video_source_array


class vq_exception(Exception):
    """User-facing metric error (reference: vq_metric.py:7-9)."""


class vq_metric:
    """Abstract video-quality metric."""

    def predict(self, test_cont, reference_cont, dim_order="BCFHW", frames_per_second=0):
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


# Metric classes by name (the JAX package's registry; the CLI looks metrics up
# by ``short_name`` with "-" for "_").
vq_metric_dict = {}


def register_metric(metric_class):
    vq_metric_dict[metric_class.__name__] = metric_class
