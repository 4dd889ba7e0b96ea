"""Visualisation: heatmap colour mapping and distograms.

Counterpart of ``colorvideovdp_tpu/viz.py`` (reference:
pycvvdp/visualize_diff_map.py, pycvvdp/cvvdp_metric.py:1158-1221). The colour
mapping runs in torch on the tensors' device: a 4K block of 12 frames holds
about 100 M context values, which numpy would histogram on the host for every
block. It repeats the JAX package's numpy arithmetic step by step, so that a
pixel lands in the same histogram bin and takes the same colour:

* float32 where numpy computes in float32 (a Python scalar is cast to the
  array's type), float64 where numpy promotes (the histogram's bin index,
  and the 1024-bin equalisation curve, which runs in numpy on the host);
* every division by a scalar divides by a tensor on the same device: the
  card multiplies by the reciprocal of a Python divisor, which rounds
  differently;
* the log-luminance is rounded from float64, so the CPU and the card agree.

The tone map is block-scoped: its histogram spans the context block it is
given. Quirk 11 of memory/cvvdp-parity-traps.md is kept: a context of 3
frames takes the "NC***" luminance branch, and the colour mapping then fails
as the JAX package's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, true division by ``s`` cast to x's type (numpy's rule for a
    Python scalar)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def _np_interp1(x, v, x_q: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear LUT with clamped ends (reference: interp.py:81-89);
    ``x`` and ``v`` are small host arrays, ``x_q`` a tensor."""
    dev = x_q.device
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    v = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    q = x_q.to(torch.float32).contiguous()
    n = x.shape[0]
    imax = torch.clamp(torch.searchsorted(x, q, right=True), max=n - 1)
    imin = torch.clamp(imax - 1, 0, n - 1)
    x_lo = x[imin]
    frc = (q - x_lo) / (x[imax] - x_lo + 1e-6)
    frc = torch.where(imax == imin, 0.0, frc)
    frc = torch.where(frc < 0.0, 0.0, frc)
    return v[imin] * (1.0 - frc) + v[imax] * frc


def _luminance_NCHW(x: torch.Tensor) -> torch.Tensor:
    if x.shape[1] == 3:  # NC*** (quirk: also fires for 3-frame context blocks)
        return x[:, 0:1] * 0.212656 + x[:, 1:2] * 0.715158 + x[:, 2:3] * 0.072186
    return x


def _log_luminance(x: torch.Tensor) -> torch.Tensor:
    y = _luminance_NCHW(x)
    pos_min = float(torch.where(y > 0.0, y, math.inf).min())
    clampval = pos_min if math.isfinite(pos_min) else 1e-6
    return torch.log(torch.clamp(y, min=clampval).double()).float()


def _histogram(a: torch.Tensor, bins: int, first_edge: float, last_edge: float) -> np.ndarray:
    """``np.histogram(a, bins, range=(first_edge, last_edge))[0]`` for float32
    ``a`` within the range, computed on a's device with numpy's uniform-bin
    algorithm: the index in float64 from the float32 offset, then the same
    one-bin corrections against the float32 edges."""
    a = a.reshape(-1)
    edges = torch.as_tensor(np.linspace(first_edge, last_edge, bins + 1, endpoint=True,
                                        dtype=np.float32), device=a.device)
    norm_denom = float(np.subtract(last_edge, first_edge, dtype=np.float64))
    idx = (_div((a - first_edge).double(), norm_denom) * bins).long()
    idx = torch.where(idx == bins, idx - 1, idx)
    idx = idx - (a < edges[idx]).long()
    idx = idx + ((a >= edges[idx + 1]) & (idx != bins - 1)).long()
    return torch.bincount(idx, minlength=bins).cpu().numpy()


def vis_tonemap(b: torch.Tensor, dr: float) -> torch.Tensor:
    """Histogram-equalisation tone mapping of log-luminance (reference:
    visualize_diff_map.py:23-45)."""
    t = 3.0
    b_min, b_max = float(b.min()), float(b.max())
    if b_max - b_min < dr:
        return _div(b - b_min, b_max - b_min + 1e-3) * dr + (1 - dr) / 2

    b_scale = np.linspace(b_min, b_max, 1024, dtype=np.float32)
    b_p = _histogram(b, 1024, b_min, b_max)
    b_p = b_p.astype(np.float32) / b_p.sum()
    dy = b_p ** (1.0 / t) / np.sum(b_p ** (1.0 / t))
    v = np.cumsum(dy) * dr + (1.0 - dr) / 2.0
    return _np_interp1(b_scale, v, b)


def visualize_diff_map(diff_map: torch.Tensor, context_image: torch.Tensor | None = None,
                       colormap_type="supra-threshold") -> torch.Tensor:
    """Colour-mapped distortion visualisation -> sRGB frames (3, F, H, W)
    float32 on the input's device (reference: visualize_diff_map.py:48-106)."""
    diff_map = torch.clamp(diff_map.to(torch.float32), 0.0, 1.0)

    if context_image is None:
        tmo_img = torch.ones_like(diff_map) * 0.5
    else:
        tmo_img = vis_tonemap(_log_luminance(context_image.to(torch.float32)), 0.6)

    if colormap_type == "threshold":
        color_map = np.array(
            [[0.2, 0.2, 1.0], [0.2, 1.0, 1.0], [0.2, 1.0, 0.2],
             [1.0, 1.0, 0.2], [1.0, 0.2, 0.2]], np.float32)
        color_map_in = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32) * 0.1
    elif colormap_type == "supra-threshold":
        color_map = np.array(
            [[0.2, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 0.2]], np.float32)
        color_map_in = np.array([0.0, 0.5, 1.0], np.float32) * 0.3
    elif colormap_type == "monochromatic":
        color_map = np.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]], np.float32)
        color_map_in = np.array([0.0, 1.0], np.float32)
    else:
        raise RuntimeError(f"Unknown colormap: {colormap_type}")

    color_map_l = (
        color_map[:, 0:1] * 0.212656
        + color_map[:, 1:2] * 0.715158
        + color_map[:, 2:3] * 0.072186
    )
    color_map_ch = color_map / (np.concatenate([color_map_l] * 3, 1) + 1e-4)

    F, h, w = diff_map.shape[-3], diff_map.shape[-2], diff_map.shape[-1]
    dm = diff_map.reshape(-1, F, h, w)[0] if diff_map.dim() > 3 else diff_map
    # The colour map is rounded to float16 before the tone map multiplies it.
    cmap = torch.stack([_np_interp1(color_map_in, color_map_ch[:, cc], dm).to(torch.float16)
                        for cc in range(3)])
    if tmo_img.numel() % (F * h * w):
        # Quirk 11: a 3-frame context was mixed into one luminance plane.
        raise ValueError(f"cannot reshape array of size {tmo_img.numel()} into shape "
                         f"({F},{h},{w})")
    tmo = tmo_img.to(torch.float32).reshape(-1, F, h, w)[0]
    return torch.clamp(cmap * tmo, 0.0, 1.0)


def export_distogram(metric, stats, fname, jod_max=None, base_size=6):
    """Per-channel x per-band x per-frame distortion plot on the host
    (reference: cvvdp_metric.py:1158-1221)."""
    try:
        import matplotlib.pyplot as plt
        from matplotlib import ticker
        from matplotlib.colors import Normalize
    except ImportError as e:
        raise RuntimeError(
            "matplotlib is missing. Please install it before exporting "
            "distograms."
        ) from e

    Q_per_ch = np.asarray(stats["Q_per_ch"], np.float32).copy()
    if Q_per_ch.shape[0] != 1:
        raise RuntimeError("Exporting distograms in batch mode is not supported")
    ch_no = Q_per_ch.shape[1]
    is_image = Q_per_ch.shape[2] == 1

    Q_per_ch[:, :, :, -1] *= metric.baseband_weight[:ch_no].reshape(-1, 1)
    Q_per_ch *= metric.get_ch_weights(ch_no).reshape(1, -1, 1, 1) * ch_no
    dmap = 10.0 - metric.met2jod(torch.from_numpy(Q_per_ch)).numpy()

    if jod_max is None:
        jod_max = math.ceil(dmap.max())
    dmap /= jod_max

    fps = stats["frames_per_second"]
    frame_no = Q_per_ch.shape[2]
    rho_band = stats["rho_band"]
    band_labels = [f"{val:.2f}" for val in np.flip(rho_band)[::2]]
    band_labels[0] = "BB"

    fig, axs = plt.subplots(nrows=ch_no,
                            figsize=(base_size * frame_no / 60 + 1, base_size))
    ch_labels = ["A-sust", "RG", "YV", "A-trans"]
    cmap = plt.colormaps["plasma"]

    for kk in range(ch_no):
        dmap_ch = np.flip(np.transpose(dmap[0, kk].clip(0.0, 1.0)), axis=0)
        axs[kk].imshow(dmap_ch, cmap=cmap, aspect="auto")
        axs[kk].set_ylabel(ch_labels[kk])
        axs[kk].yaxis.set_major_locator(
            ticker.FixedLocator(range(0, len(band_labels) * 2, 2))
        )
        axs[kk].yaxis.set_minor_locator(ticker.MultipleLocator(1.0))
        axs[kk].set_yticklabels(band_labels)
        if kk == ch_no - 1 and not is_image:
            axs[kk].xaxis.set_major_formatter(
                lambda x, pos: str(int(x / fps * 1000))
            )
            axs[kk].set_xlabel("Time [ms]")
            axs[kk].xaxis.set_minor_locator(ticker.MultipleLocator(1.0))
        else:
            axs[kk].set_xticks([])

    if is_image:
        plt.subplots_adjust(bottom=0.1, right=0.5, top=0.9)
        cax = plt.axes([0.725, 0.1, 0.125, 0.8])
    else:
        plt.subplots_adjust(bottom=0.1, right=0.9, top=0.9)
        cax = plt.axes([0.925, 0.1, 0.025, 0.8])
    plt.colorbar(
        plt.cm.ScalarMappable(norm=Normalize(0, jod_max), cmap=cmap),
        cax=cax, cmap=cmap,
    )
    plt.savefig(fname, bbox_inches="tight")
    plt.close(fig)
