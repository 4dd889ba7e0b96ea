"""Plain PyTorch ColorVideoVDP supra-threshold heatmap: the benchmark's
reference for ``heatmap="supra-threshold"``.

Upstream: gfxdisp/ColorVideoVDP ``pycvvdp/cvvdp_metric.py`` (the heatmap
branch of ``process_block_of_frames`` and ``predict_video_source``) and
``pycvvdp/visualize_diff_map.py``. Per block of frames: each interior
band's D (``cvvdp_ref.CVVDPReference.band_D``) and the baseband's |T - R| S
are pooled over the channels, ``lp_norm(D * w_ch, beta_tch)`` with the
channel weights (an image's times ``image_int``, the baseband's times
``baseband_weight``), an interior band's map divided by its gain; the maps
are collapsed by the Laplacian reconstruct (expand from the baseband up,
adding each band), and the map is 1 - JOD / 10 of the result. The colour
map: the supra-threshold map (cyan, white, yellow over 0 to 0.3, each
colour divided by its luminance) times the tone-mapped context, clipped
to [0, 1] and stored as float16. The context is channel 0 of the block's
temporal channels, the test's sustained luminance; its tone map is the
histogram equalisation of its log over 1024 bins (exponent 1/3, dynamic
range 0.6), taken over one block's frames. The JOD and ``Q_per_ch`` are
``cvvdp_ref``'s.

Departures from upstream: the histogram is ``torch.histc``'s, whose bin
of a value on an edge may differ from numpy's by one (a count among
millions); the colour map is rounded to float16 before the tone map
multiplies it, as the JAX package's numpy arithmetic does; the blocks the
D maps are computed in (``block_pixels``) are independent of those the
tone map spans (``tone_frames``, the frames the program scores at once).

It imports nothing of the measured program. Arithmetic is element by
element in ``dtype`` (no matrix product); ``dtype=torch.bfloat16`` is the
benchmark's control of a lower precision (the histogram is counted from
the bfloat16 values in float32, which ``histc`` needs).
"""

from __future__ import annotations

import numpy as np
import torch

from .cvvdp_ml_ref import channel_blocks
from .cvvdp_ref import RHO_BASEBAND, CVVDPReference, band_freqs, clip, expand, lp_norm, reduce

# Supra-threshold colour map: colours at 0, 0.15 and 0.3 of 1 - JOD / 10.
CMAP = np.array([[0.2, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 0.2]], np.float32)
CMAP_IN = np.array([0.0, 0.5, 1.0], np.float32) * 0.3
LUMA = np.array([0.212656, 0.715158, 0.072186], np.float32)
TONE_DR, TONE_T, TONE_BINS = 0.6, 3.0, 1024


def interp1(x, v, q):
    """Piecewise-linear lookup of ``q`` in (x, v), clamped at the ends, with
    upstream's ``interp1`` arithmetic (a 1e-6 guard in the divisor)."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=q.device)
    v = torch.as_tensor(np.asarray(v, np.float32), device=q.device)
    q = q.float()
    n = x.shape[0]
    hi = torch.clamp(torch.searchsorted(x, q.contiguous(), right=True), max=n - 1)
    lo = torch.clamp(hi - 1, min=0)
    frc = torch.clamp((q - x[lo]) / (x[hi] - x[lo] + 1e-6), min=0.0)
    frc = torch.where(hi == lo, 0.0, frc)
    return v[lo] * (1.0 - frc) + v[hi] * frc


def tone_map(context):
    """Histogram equalisation of the log of ``context`` (positive values;
    zeros and below take the smallest positive one), in [0.2, 0.8]."""
    pos = torch.where(context > 0, context, torch.full_like(context, float("inf"))).min()
    b = torch.log(torch.maximum(context, pos)).float()
    b_min, b_max = float(b.min()), float(b.max())
    if b_max - b_min < TONE_DR:
        return (b - b_min) / (b_max - b_min + 1e-3) * TONE_DR + (1 - TONE_DR) / 2
    hist = torch.histc(b, bins=TONE_BINS, min=b_min, max=b_max).double().cpu().numpy()
    p = hist / hist.sum()
    dy = p ** (1.0 / TONE_T) / np.sum(p ** (1.0 / TONE_T))
    v = np.cumsum(dy) * TONE_DR + (1.0 - TONE_DR) / 2.0
    return interp1(np.linspace(b_min, b_max, TONE_BINS, dtype=np.float32), v, b)


def colour_map(hm, context):
    """float16 sRGB (3, F, H, W) of the map (F, H, W) over its context."""
    tmo = tone_map(context)
    ch = CMAP / ((CMAP @ LUMA)[:, None] + 1e-4)
    dm = torch.clamp(hm.float(), 0.0, 1.0)
    cmap = torch.stack([interp1(CMAP_IN, ch[:, c], dm).to(torch.float16) for c in range(3)])
    return torch.clamp(cmap.float() * tmo, 0.0, 1.0).to(torch.float16)


class HeatmapReference:
    """The supra-threshold heatmap of ColorVideoVDP's default configuration
    on one display, on ``device``, in ``dtype``."""

    def __init__(self, display_name, device="cpu", dtype=torch.float32, block_pixels=1 << 28):
        self.ref = CVVDPReference(display_name, device=device, dtype=dtype,
                                  block_pixels=block_pixels)

    def met2jod(self, Q):
        p = self.ref.p
        a, e = p["jod_a"], p["jod_exp"]
        return torch.where(Q <= 0.1, 10.0 - a * 0.1 ** (e - 1.0) * Q,
                           10.0 - a * clip(Q, 0.1) ** e)

    def block(self, R, freqs, is_image):
        """(Q (B, C, F, bands), map (F, H, W)) of one interleaved block."""
        r = self.ref
        p = r.p
        C = R.shape[1] // 2
        w = r._t(r.ch_w[:C] * (p["image_int"] if is_image else 1.0)).reshape(1, C, 1, 1, 1)
        levels = [R]
        for _ in range(len(freqs) - 1):
            levels.append(reduce(levels[-1]))
        Q, maps = [], []
        for b in range(len(freqs) - 1):
            mul = 1.0 if b == 0 else 2.0
            D = r.band_D(levels[b], levels[b + 1], freqs[b], mul)
            Q.append(lp_norm(D, p["beta"], (-2, -1), True))
            maps.append(lp_norm(D * w, p["beta_tch"], 1, False, keepdim=True) / mul)
            del D
        g = levels[-1]
        L_bkg = torch.mean(clip(g[:, 0:2], 0.01), dim=(-1, -2), keepdim=True)
        T = clip(g[:, 0::2] / L_bkg[:, 0:1], hi=1000.0)
        Rb = clip(g[:, 1::2] / L_bkg[:, 1:2], hi=1000.0)
        S = r.csf(torch.log10(L_bkg[:, 1]), r.csf_rows(RHO_BASEBAND, C)).movedim(0, 1)
        D = torch.abs(T - Rb) * (S * r.sens_corr)
        Q.append(lp_norm(D, p["beta"], (-2, -1), True))
        wb = r._t(np.asarray(p["baseband_weight"], np.float32)[:C]).reshape(1, C, 1, 1, 1)
        img = lp_norm(D * w * wb, p["beta_tch"], 1, False, keepdim=True)
        for m in reversed(maps):
            img = expand(img, m.shape[-2:]) + m
        return torch.stack(Q, dim=-1), (1.0 - self.met2jod(img) / 10.0)[0, 0]

    @torch.no_grad()
    def score(self, test, ref, dim_order, fps=0.0, tone_frames=None):
        """(JOD, Q_per_ch (1, C, F, bands) float32, heatmap (1, 3, F, H, W)
        float16) of a test/reference pair of host arrays laid out as
        ``dim_order`` (as ``CVVDPReference.score``); the tone map spans
        ``tone_frames`` frames at a time (all of them by default)."""
        r = self.ref
        order = dim_order.upper()
        N = test.shape[order.index("F")] if "F" in order else 1
        H, W = test.shape[order.index("H")], test.shape[order.index("W")]
        freqs = band_freqs(W, H, r.display.ppd)
        if N == 1:
            T, R = (r.to_dkl(r._frames(a, dim_order, 0, 1)) for a in (test, ref))
            blocks = [(1, torch.stack([T, R], dim=2).reshape(1, 6, 1, H, W))]
        else:
            blocks = channel_blocks(r, test, ref, dim_order, fps,
                                    max(1, r.block_pixels // (H * W * 8)))
        Qs, maps, ctx = [], [], []
        for _, R in blocks:
            Q, hm = self.block(R, freqs, N == 1)
            Qs.append(Q)
            maps.append(hm)
            ctx.append(R[0, 0])
            del R
        Q = torch.cat(Qs, dim=2)
        hm, ctx = torch.cat(maps), torch.cat(ctx)
        step = tone_frames or N
        out = torch.cat([colour_map(hm[f:f + step], ctx[f:f + step]) for f in range(0, N, step)],
                        dim=1)
        return (float(r.jod(Q)[0]), Q.float().cpu().numpy(), out[None].cpu().numpy())
