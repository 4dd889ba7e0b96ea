"""ColorVideoVDP on PyTorch with hand-written CUDA kernels for Hopper.

A port of ``colorvideovdp_tpu`` (the JAX package, kept as the reference):
``cvvdp(display_name=..., device="cuda").predict(test, ref, ...)`` scores an
image or video pair with the calibrated default configuration, or with any
contrast coding, masking model or clamp of the JAX package given through
``config_paths`` (``utils.config.write_parameters`` writes one).
``cvvdp_ml_saliency`` and ``cvvdp_ml_transformer`` score with the
ColorVideoVDP-ML heads (weights from a ``cvvdp_ml.npz`` on the configuration
search path, or ``random_init=True``). This package
never imports jax; it reads the calibration files of the JAX package by path.
"""

from .display import vvdp_display_geometry, vvdp_display_photo_eotf, vvdp_display_photometry
from .io.video_source import video_source_array
from .metrics.base import register_metric, vq_exception, vq_metric, vq_metric_dict
from .metrics.cvvdp import cvvdp
from .metrics.ml import cvvdp_ml_saliency, cvvdp_ml_transformer

__all__ = [
    "cvvdp",
    "cvvdp_ml_saliency",
    "cvvdp_ml_transformer",
    "register_metric",
    "video_source_array",
    "vq_exception",
    "vq_metric",
    "vq_metric_dict",
    "vvdp_display_geometry",
    "vvdp_display_photo_eotf",
    "vvdp_display_photometry",
]
