"""ColorVideoVDP on PyTorch with hand-written CUDA kernels for Hopper.

A port of ``colorvideovdp_tpu`` (the JAX package, kept as the reference):
``cvvdp(display_name=..., device="cuda").predict(test, ref, ...)`` scores an
image or video pair with the calibrated default configuration, or with any
contrast coding, masking model or clamp of the JAX package given through
``config_paths`` (``utils.config.write_parameters`` writes one). This package
never imports jax; it reads the calibration files of the JAX package by path.
"""

from .display import vvdp_display_geometry, vvdp_display_photo_eotf, vvdp_display_photometry
from .io.video_source import video_source_array
from .metrics.base import vq_metric
from .metrics.cvvdp import cvvdp

__all__ = [
    "cvvdp",
    "video_source_array",
    "vq_metric",
    "vvdp_display_geometry",
    "vvdp_display_photo_eotf",
    "vvdp_display_photometry",
]
