"""In-memory frame source: the ``predict()`` path.

Counterpart of ``colorvideovdp_tpu/io/video_source.py``. Frames stay on the
host as numpy arrays in their source dtype; the metric uploads raw frame
blocks and converts them on its device (the dtype ladder is
``ops/kernels/ingest.py:raw_to_float``).
"""

from __future__ import annotations

import numpy as np

from ..display import vvdp_display_photometry


def reshuffle_dims(a: np.ndarray, in_dims: str, out_dims: str = "BCFHW") -> np.ndarray:
    """Reorder dimensions by name, adding singleton axes for missing ones."""
    in_dims = in_dims.upper()
    out_dims = out_dims.upper()
    if len(in_dims) != a.ndim:
        raise RuntimeError(
            "The in_dims string must have as many characters as there are "
            "dimensions in the array")
    inter_dims = "".join(d for d in out_dims if d in in_dims)
    keep = []
    new_in = ""
    for kk, d in enumerate(in_dims):
        if d in inter_dims:
            keep.append(kk)
            new_in += d
        elif a.shape[kk] != 1:
            raise RuntimeError("Only the dimensions of size 1 can be skipped in the output")
    a = a.reshape([a.shape[k] for k in keep])
    a = a.transpose([new_in.index(d) for d in inter_dims])
    out_sh = [1] * len(out_dims)
    for kk, d in enumerate(out_dims):
        if d in inter_dims:
            out_sh[kk] = a.shape[inter_dims.index(d)]
    return a.reshape(out_sh)


class video_source_array:
    """Test/reference arrays with a display model; supports a batch axis."""

    def __init__(self, test_video, reference_video, fps, dim_order="BCFHW",
                 display_photometry="sdr_4k_30", config_paths=None):
        if isinstance(display_photometry, str):
            self.dm_photometry = vvdp_display_photometry.load(display_photometry,
                                                              config_paths or [])
        elif isinstance(display_photometry, vvdp_display_photometry):
            self.dm_photometry = display_photometry
        else:
            raise RuntimeError(
                "display_model must be a string or vvdp_display_photometry subclass")

        test_video = np.asarray(test_video)
        reference_video = np.asarray(reference_video)
        if test_video.shape != reference_video.shape:
            ind = dim_order.find("B")
            if not (ind >= 0 and (test_video.shape[ind] == 1
                                  or reference_video.shape[ind] == 1)):
                raise RuntimeError(
                    "Test and reference image/video tensors must be exactly the same shape")
        if len(dim_order) != test_video.ndim:
            raise RuntimeError(
                "Input tensor must have exactly as many dimensions as there are "
                'characters in the "dims" parameter')

        test_video = reshuffle_dims(test_video, dim_order, "BCFHW")
        reference_video = reshuffle_dims(reference_video, dim_order, "BCFHW")
        B, C, F, H, W = test_video.shape
        if fps == 0 and F > 1:
            raise RuntimeError(
                "When passing video sequences, you must set 'frames_per_second' parameter")
        if C not in (1, 3):
            raise RuntimeError("The content must have either 1 or 3 color channels.")
        self.fps = fps
        self.test_video = test_video
        self.reference_video = reference_video
        self._raw_fmajor = {}

    def get_frames_per_second(self):
        return self.fps

    def get_video_size(self):
        sh = self.test_video.shape
        return (sh[3], sh[4], sh[2])

    def get_batch_size(self):
        return max(self.test_video.shape[0], self.reference_video.shape[0])

    def _bfchw(self, which: str) -> np.ndarray:
        if which not in self._raw_fmajor:
            src = self.test_video if which == "test" else self.reference_video
            self._raw_fmajor[which] = np.ascontiguousarray(np.transpose(src, (0, 2, 1, 3, 4)))
        return self._raw_fmajor[which]

    def get_raw_block(self, which: str, start: int, count: int) -> np.ndarray:
        """Raw source-dtype frames (B, count, C, H, W); short tails are padded
        by repeating the last frame (the metric trims the padded outputs)."""
        src = self._bfchw(which)
        end = min(start + count, src.shape[1])
        block = src[:, start:end]
        if end - start < count:
            pad = np.repeat(block[:, -1:], count - (end - start), axis=1)
            block = np.concatenate([block, pad], axis=1)
        return block

    def get_raw_frame_list(self, which: str, indices) -> np.ndarray:
        """Arbitrary raw frames (B, len(indices), C, H, W): the symmetric head."""
        return np.ascontiguousarray(self._bfchw(which)[:, list(indices)])
