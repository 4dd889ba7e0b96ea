"""Carry calibrated parameters from a JAX ``cvvdp`` instance to the port.

``params_from_jax(metric)`` reads the metric's attributes with ``getattr``
and ``np.asarray`` only (no jax import) and returns plain floats, numpy
arrays, the configuration strings and flags; ``colorvideovdp_tpu_torch.cvvdp.
load_parameters`` applies them, so that the port reproduces a JAX metric
built from any contrast coding, masking model or clamp.
``ml_weights_from_jax(metric)`` carries the nets of a JAX ML metric the same
way, for the port's ``load_weights``.
"""

from __future__ import annotations

import numpy as np

# Numeric attributes set by the JAX package's cvvdp.load_config.
_SCALARS = ("mask_p", "mask_c", "pu_dilate", "beta", "beta_t", "beta_tch", "beta_sch",
            "csf_sigma", "sensitivity_correction", "jod_a", "jod_exp", "image_int",
            "ch_chrom_w", "ch_trans_w", "mask_q_sust", "mask_q_trans", "d_max")
_ARRAYS = ("mask_q", "xcm_weights", "ch_weights", "sigma_tf", "beta_tf", "baseband_weight")
# Set only when the configuration has them (None otherwise).
_OPTIONAL = ("ce_g", "k_c")
_CONFIG = ("contrast", "masking_model", "dclamp_type")
_DISPLAY = ("Y_peak", "contrast", "E_ambient", "k_refl", "exposure")


def params_from_jax(metric) -> dict:
    """Calibrated constants plus display photometry and geometry of a JAX
    ``colorvideovdp_tpu.cvvdp`` instance."""
    out = {}
    for name in _SCALARS:
        if hasattr(metric, name):
            v = np.asarray(getattr(metric, name))
            out[name] = float(v) if v.ndim == 0 else v.astype(np.float32)
    for name in _ARRAYS:
        if hasattr(metric, name):
            out[name] = np.asarray(getattr(metric, name), np.float32)
    for name in _OPTIONAL:
        if getattr(metric, name, None) is not None:
            out[name] = float(getattr(metric, name))
    for name in _CONFIG:
        out[name] = str(getattr(metric, name))
    out["do_xchannel_masking"] = bool(metric.do_xchannel_masking)
    dm = metric.display_photometry
    for name in _DISPLAY:
        out["display_" + name] = float(np.asarray(getattr(dm, name)))
    out["display_rgb2xyz"] = np.asarray(dm.rgb2xyz, np.float32)
    out["pix_per_deg"] = float(metric.pix_per_deg)
    return out


def _lin(out, key, p):
    for part in ("weight", "bias"):
        out[f"{key}.{part}"] = np.asarray(p[part], np.float32)


def ml_weights_from_jax(metric) -> dict:
    """The nets of a JAX ColorVideoVDP-ML instance (``cvvdp_ml_saliency``,
    ``cvvdp_ml_transformer``) as flat checkpoint-layout arrays
    ("<net>.<key>", the layout of ``cvvdp_ml.npz``), read from its parameter
    pytrees with ``np.asarray`` only; ``load_weights`` of the port's metric
    of the same family takes them. MLP layers get torchvision's indices 0,
    3, 6, ..."""
    out = {}
    for net in metric.get_nets_to_load():
        params = getattr(metric, net)
        if isinstance(params, list):
            for i, p in enumerate(params):
                _lin(out, f"{net}.{3 * i}", p)
            continue
        _lin(out, f"{net}.patch_embed.1", params["patch_embed"])
        out[f"{net}.cls_token"] = np.asarray(params["cls_token"], np.float32)
        _lin(out, f"{net}.reg_head.0", params["reg_norm"])
        _lin(out, f"{net}.reg_head.1", params["reg_linear"])
        for i, lp in enumerate(params["layers"]):
            pre = f"{net}.transformer.layers.{i}."
            att = lp["self_attn"]
            out[pre + "self_attn.in_proj_weight"] = np.asarray(att["in_proj_weight"], np.float32)
            out[pre + "self_attn.in_proj_bias"] = np.asarray(att["in_proj_bias"], np.float32)
            _lin(out, pre + "self_attn.out_proj", att["out_proj"])
            for name in ("linear1", "linear2", "norm1", "norm2"):
                _lin(out, pre + name, lp[name])
    return out
