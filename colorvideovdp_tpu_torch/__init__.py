"""ColorVideoVDP on PyTorch with hand-written CUDA kernels for Hopper.

A port of ``colorvideovdp_tpu`` (the JAX package, kept as the reference):
``cvvdp(display_name=..., device="cuda").predict(test, ref, ...)`` scores an
image or video pair with the calibrated default configuration, or with any
contrast coding, masking model or clamp of the JAX package given through
``config_paths`` (``utils.config.write_parameters`` writes one).
``cvvdp_ml_saliency`` and ``cvvdp_ml_transformer`` score with the
ColorVideoVDP-ML heads (weights from a ``cvvdp_ml.npz`` on the configuration
search path, or ``random_init=True``). Files are scored through
``video_source_file(test, ref, display_photometry=...)`` (``.yuv``, images
and frame sequences, ``.mat``, decoded video) and
``metric.predict_video_source``; ``psnr_rgb``, ``pu_psnr_y``,
``pu_psnr_rgb2020`` and ``ssim_metric`` are the aux metrics. The command
line is ``python -m colorvideovdp_tpu_torch.cli`` (the JAX package's flags;
``cli.py``) and a clip list is scored by ``tools/run_cluster.py``. This
package never imports jax; it reads the calibration files of the JAX package
by path.
"""

from .display import vvdp_display_geometry, vvdp_display_photo_eotf, vvdp_display_photometry
from .io.video_source import video_source, video_source_array, video_source_dm
from .io.video_source_file import video_source_file
from .metrics.base import register_metric, vq_exception, vq_metric, vq_metric_dict
from .metrics.cvvdp import cvvdp
from .metrics.ml import cvvdp_ml_saliency, cvvdp_ml_transformer
from .metrics.psnr import psnr_rgb, pu_psnr_rgb2020, pu_psnr_y
from .metrics.ssim import ssim_metric
from .ops.colorspace import PU

__all__ = [
    "PU",
    "cvvdp",
    "cvvdp_ml_saliency",
    "cvvdp_ml_transformer",
    "psnr_rgb",
    "pu_psnr_rgb2020",
    "pu_psnr_y",
    "register_metric",
    "ssim_metric",
    "video_source",
    "video_source_array",
    "video_source_dm",
    "video_source_file",
    "vq_exception",
    "vq_metric",
    "vq_metric_dict",
    "vvdp_display_geometry",
    "vvdp_display_photo_eotf",
    "vvdp_display_photometry",
]
