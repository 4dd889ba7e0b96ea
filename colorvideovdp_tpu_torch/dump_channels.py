"""Dump intermediate channel data for debugging and visualisation
(counterpart of ``colorvideovdp_tpu/dump_channels.py``): the temporal
channels, the contrast pyramid and the per-band visual differences of each
block, drawn on the host in numpy. ``cvvdp(dump_channels=DumpChannels(...))``
opens the writers at the start of ``predict_video_source``, feeds them the
host copies it makes of each block's tensors, and closes them at the end."""

from __future__ import annotations

import logging
import math
import os

import numpy as np

from .io.writers import ImageWriter, VideoWriter
from .ops.pyramid import LaplacianPyramid

DKLd65_to_RGB = np.array(
    [
        [0.926502308187832, 0.960842501786725, 0.940315924461593],
        [6.448879567147620, -2.074854167137361, 0.100486265553559],
        [0.181670434983238, -0.190064026530768, 1.080345193424545],
    ],
    np.float32,
)

WHITE_DKL = np.array([1.0, 0.003775328226986, 0.010327227989383], np.float32)


def dkld65_to_rgb(img):
    """(B, 3, F, H, W) DKL -> RGB."""
    M = DKLd65_to_RGB.T
    out = np.empty_like(img)
    for cc in range(3):
        out[:, cc] = np.sum(img * M[cc].reshape(1, 3, 1, 1, 1), axis=1)
    return out


def ceil8(x):
    return int(math.ceil(x / 8)) * 8


class DumpChannels:
    def __init__(self, dump_temp_ch=True, dump_lpyr=True, dump_diff=True,
                 output_dir=None):
        self.vw_channels = None
        self.do_dump_temp_ch = dump_temp_ch
        self.do_dump_lpyr = dump_lpyr
        self.do_dump_diff = dump_diff
        self.output_dir = output_dir if output_dir else "."
        self.is_image = None
        self._diff_bands = None

    def open(self, fps):
        self.is_image = fps == 0
        self.max_V = None

        def _writer(stem):
            if self.is_image:
                fname = os.path.join(self.output_dir, stem + ".png")
                w = ImageWriter(fname)
            else:
                # The name the writer chose (an .mp4, or a .y4m beside it).
                w = VideoWriter(os.path.join(self.output_dir, stem + ".mp4"), fps=fps)
                fname = w.fname
            return fname, w

        if self.do_dump_temp_ch:
            fname, self.vw_channels = _writer("temp_channels")
            logging.info(f"Writing temporal channels to '{fname}'")
        else:
            self.vw_channels = None
        if self.do_dump_lpyr:
            fname, self.vw_lpyr = _writer("lpyr")
            logging.info(f"Writing Laplacian pyramids to '{fname}'")
        else:
            self.vw_lpyr = None
        if self.do_dump_diff:
            fname, self.vw_diff = _writer("diff")
            logging.info(f"Writing visual differences to '{fname}'")
        else:
            self.vw_diff = None

    def dump_temp_ch(self, R):
        """R: (B, 6|8, F, H, W) interleaved test/ref channels (numpy)."""
        if not self.do_dump_temp_ch:
            return
        R = np.asarray(R, np.float32)
        w = WHITE_DKL
        ach_sust = R[0:1, 0:1]
        full = lambda v, like: np.full_like(like, v)  # noqa: E731
        ach_sust_rgb = dkld65_to_rgb(
            np.concatenate(
                [ach_sust, full(w[1], ach_sust), full(w[2], ach_sust)], axis=1
            )
        )
        if not self.max_V:
            self.max_V = float(ach_sust_rgb.max())
        gray = w.reshape(1, 3, 1, 1, 1) * (self.max_V / 4)
        if self.is_image:
            ach_trans_rgb = np.full(
                (1, 3, 1, ach_sust.shape[-2], ach_sust.shape[-1]), 0.2176,
                np.float32,
            )
        else:
            ach_trans = R[0:1, 6:7]
            ach_trans_rgb = dkld65_to_rgb(
                np.concatenate(
                    [ach_trans, full(w[1], ach_trans), full(w[2], ach_trans)],
                    axis=1,
                )
                + gray
            )
        rg = R[0:1, 2:3]
        rg_rgb = dkld65_to_rgb(
            np.concatenate([full(w[0], rg), rg, full(w[2], rg)], axis=1) + gray
        )
        yv = R[0:1, 4:5]
        yv_rgb = dkld65_to_rgb(
            np.concatenate([full(w[0], yv), full(w[1], yv), yv], axis=1) + gray
        )
        frame = np.concatenate(
            [
                np.concatenate([ach_sust_rgb, ach_trans_rgb], axis=-1),
                np.concatenate([rg_rgb, yv_rgb], axis=-1),
            ],
            axis=-2,
        )
        for ff in range(frame.shape[2]):
            # Negative (out-of-gamut) values would give NaN under the display
            # gamma: clamp first.
            v = np.clip(frame[0, :, ff] / self.max_V, 0, None)
            de = np.clip(v ** (1 / 2.2) * 255, 0, 255)
            self.vw_channels.write_frame_rgb(
                de.transpose(1, 2, 0).astype(np.uint8)
            )

    def dump_lpyr(self, lpyr, bands):
        """bands: list of (B, C, F, h, w) contrast bands (numpy)."""
        if not self.do_dump_lpyr:
            return
        bands = [np.asarray(b, np.float32) for b in bands]
        get = LaplacianPyramid.get_band
        b0 = get(bands, 0)
        width = ceil8((b0.shape[-1] + get(bands, 1).shape[-1] + 1) * 2)
        height = ceil8((b0.shape[-2] + 1) * 2)
        frames = b0.shape[2]
        lpv = np.zeros((3, frames, height, width), np.float32)
        w = WHITE_DKL
        B = len(bands)
        CHs = [0, 2, 4] if self.is_image else [0, 6, 2, 4]
        for col, ch in enumerate(CHs):
            pos = [col // 2 * (height // 2), (col % 2) * (width // 2)]
            for bb in range(B):
                band = get(bands, bb)[0:1, ch : ch + 1]
                filled = lambda v: np.full_like(band, v)  # noqa: E731
                if ch in (0, 1, 6, 7):
                    band_col = dkld65_to_rgb(np.concatenate(
                        [band + w[0] / 2, filled(w[1]), filled(w[2])], axis=1
                    ))
                elif ch in (2, 3):
                    band_col = dkld65_to_rgb(np.concatenate(
                        [filled(w[0] / 2), band + w[1], filled(w[2])], axis=1
                    ))
                else:
                    band_col = dkld65_to_rgb(np.concatenate(
                        [filled(w[0] / 2), filled(w[1]), band + w[2]], axis=1
                    ))
                lpv[:, :, pos[0] : pos[0] + band.shape[-2],
                    pos[1] : pos[1] + band.shape[-1]] = band_col[0]
                if bb % 2 == 0:
                    pos[1] += band.shape[-1] + 1
                else:
                    pos[0] += band.shape[-2] + 1
        for ff in range(frames):
            de = np.clip(np.clip(lpv[:, ff], 0, None) ** (1 / 2.2) * 255,
                         0, 255)
            self.vw_lpyr.write_frame_rgb(
                de.transpose(1, 2, 0).astype(np.uint8)
            )

    def set_diff_bands(self, bands):
        """bands: list of channel-weighted difference bands (B, C, F, h, w),
        already at stored (half) gain for interior levels."""
        if not self.do_dump_diff:
            return
        self._diff_bands = [np.asarray(b, np.float32) for b in bands]

    def dump_diff(self):
        if not self.do_dump_diff or self._diff_bands is None:
            return
        bands = self._diff_bands
        get = LaplacianPyramid.get_band  # re-applies x2 interior gain
        b0 = get(bands, 0)
        width = ceil8((b0.shape[-1] + get(bands, 1).shape[-1] + 1) * 2)
        height = ceil8((b0.shape[-2] + 1) * 2)
        frames = b0.shape[2]
        lpv = np.full((3, frames, height, width), 0.2716, np.float32)
        B = len(bands)
        CHs = [0, 1, 2] if self.is_image else [0, 3, 1, 2]
        for col, ch in enumerate(CHs):
            pos = [col // 2 * (height // 2), (col % 2) * (width // 2)]
            for bb in range(B):
                band = get(bands, bb)[0:1, ch : ch + 1]
                band_col = np.repeat(band / 10, 3, axis=1)
                lpv[:, :, pos[0] : pos[0] + band.shape[-2],
                    pos[1] : pos[1] + band.shape[-1]] = band_col[0]
                if bb % 2 == 0:
                    pos[1] += band.shape[-1] + 1
                else:
                    pos[0] += band.shape[-2] + 1
        for ff in range(frames):
            de = np.clip(np.clip(lpv[:, ff], 0, None) ** (1 / 2.2) * 255,
                         0, 255)
            self.vw_diff.write_frame_rgb(
                de.transpose(1, 2, 0).astype(np.uint8)
            )

    def close(self):
        if self.vw_channels:
            self.vw_channels.close()
        if self.vw_lpyr:
            self.vw_lpyr.close()
        if self.vw_diff:
            self.vw_diff.close()
