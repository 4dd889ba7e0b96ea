"""Frame sources: the pull-based interface the metrics consume, and the
in-memory source of the ``predict()`` path.

Counterpart of ``colorvideovdp_tpu/io/video_source.py``. Frames stay on the
host as numpy arrays in their source dtype. The metric uploads raw frame
blocks and converts them on its device (the dtype ladder is
``ops/kernels/ingest.py:raw_to_float``); the per-frame API
(``get_test_frame``) uploads one raw frame and converts it and applies the
display model on the device it is given.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..display import vvdp_display_photometry
from ..ops.kernels.ingest import raw_to_float
from ..utils import spans


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


def _memory_order(a: np.ndarray) -> tuple:
    """The axes of ``a`` from the outermost in memory to the innermost."""
    return tuple(int(k) for k in np.argsort([-s for s in a.strides], kind="stable"))


def _is_dense(a: np.ndarray) -> bool:
    """Whether ``a``'s elements fill its memory without gaps or overlaps, in
    some order of its axes."""
    return a.transpose(_memory_order(a)).flags.c_contiguous


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` as it is, uint16 as its int16 bits (the
    dtype ladder and the unpacks read them back). A dense array goes over in
    its memory order, one copy, and keeps its strides on the device (a
    channel-last block stays channel-last; the span counts ``channel_last``
    = 1 for any order but C order); any other array is made dense first,
    keeping its axes' memory order."""
    with spans.span("cvvdp.upload", bytes=a.nbytes) as sp:
        if not _is_dense(a):
            a = np.array(a, order="K")
        sp.set(channel_last=int(not a.flags.c_contiguous))
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        return torch.from_numpy(a).to(device)


def frame_to_float32(frame: np.ndarray, device) -> torch.Tensor:
    """Source dtype ladder -> float32 on ``device``: uint8 / uint16 to [0, 1],
    float16 / float32 in their own range. The raw frame is uploaded and
    converted there."""
    if frame.dtype not in (np.uint8, np.uint16, np.int16, np.float16, np.float32):
        raise RuntimeError(
            f"Only uint8, uint16 and float32 is currently supported. "
            f"{frame.dtype} encountered.")
    return raw_to_float(upload(frame, device))


def frame_device(device) -> torch.device:
    """The device of the per-frame API: ``device``, or the card when None."""
    return torch.device("cuda" if device is None else device)


class video_source:
    """Abstract frame source."""

    def get_video_size(self):
        """(height, width, frames)."""
        raise NotImplementedError

    def get_frames_per_second(self) -> float:
        raise NotImplementedError

    def get_test_frame(self, frame, device=None, colorspace="DKLd65"):
        raise NotImplementedError

    def get_reference_frame(self, frame, device=None, colorspace="DKLd65"):
        raise NotImplementedError

    def get_frame_count(self):
        return self.get_video_size()[2]

    def get_batch_size(self):
        return 1

    def check_if_valid(self, frame: torch.Tensor, target_colorspace):
        """Log a warning about the first frame once: NaN or Inf values, or a
        mean below 1 where absolute units are expected. One small reduction
        on the frame's device, read back together."""
        if getattr(self, "_warning_shown", False):
            return
        if getattr(self, "_first_frame_checked", False):
            return
        self._first_frame_checked = True
        f = frame[:, 0]
        has_nan, has_inf, f_mean, f_max, f_min = torch.stack([
            torch.isnan(f).any().float(), torch.isinf(f).any().float(), f.mean(), f.max(),
            f.min()]).tolist()
        if has_nan:
            self._warning_shown = True
            logging.warning("Image contains one or more NaN values")
            return
        if has_inf:
            self._warning_shown = True
            logging.warning("Image contains one or more Inf values")
            return
        if not target_colorspace.startswith("display_encoded") and (
                target_colorspace != "RGB2020pq"):
            logging.debug(f"Content mean={f_mean}, max={f_max}, min={f_min}")
            if f_mean <= 1:
                self._warning_shown = True
                logging.warning(
                    "The mean color value is less than 1 - the image may not "
                    "be scaled in absolute photometric units!")


class video_source_dm(video_source):
    """A source with a photometric display model, applied on the device to
    each frame of the per-frame API."""

    def __init__(self, display_photometry="sdr_4k_30", config_paths=None):
        if isinstance(display_photometry, str):
            self.dm_photometry = vvdp_display_photometry.load(display_photometry,
                                                              config_paths or [])
        elif isinstance(display_photometry, vvdp_display_photometry):
            self.dm_photometry = display_photometry
        else:
            raise RuntimeError(
                "display_model must be a string or vvdp_display_photometry subclass")

    def apply_dm_and_color_transform(self, frame: torch.Tensor, target_colorspace):
        I = self.dm_photometry.source_2_target_colorspace(frame, target_colorspace)
        self.check_if_valid(I, target_colorspace)
        return I


class video_source_array(video_source_dm):
    """Test/reference arrays with a display model; supports a batch axis."""

    def __init__(self, test_video, reference_video, fps, dim_order="BCFHW",
                 display_photometry="sdr_4k_30", config_paths=None):
        super().__init__(display_photometry=display_photometry, config_paths=config_paths)

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

    def get_test_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._get_frame(self.test_video, frame, device, colorspace)

    def get_reference_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._get_frame(self.reference_video, frame, device, colorspace)

    def _get_frame(self, from_array, frame, device, colorspace):
        """Frame ``frame`` as (B, C, 1, H, W) in ``colorspace`` on ``device``."""
        raw = frame_to_float32(from_array[:, :, frame:frame + 1], frame_device(device))
        return self.apply_dm_and_color_transform(raw, colorspace)

    def _bfchw(self, which: str) -> np.ndarray:
        """One side as (B, F, C, H, W): a view where each batch item lies in
        memory frame after frame with each frame's C, H and W dense (FCHW,
        FHWC, HWC, BHWC, ...), else a planar copy (``cvvdp.relayout``)."""
        if which not in self._raw_fmajor:
            src = self.test_video if which == "test" else self.reference_video
            fmajor = np.transpose(src, (0, 2, 1, 3, 4))
            item = fmajor[0]
            if not (_is_dense(item) and (item.shape[0] == 1 or _memory_order(item)[0] == 0)):
                with spans.span("cvvdp.relayout", bytes=src.nbytes):
                    fmajor = np.ascontiguousarray(fmajor)
            self._raw_fmajor[which] = fmajor
        return self._raw_fmajor[which]

    def get_raw_block(self, which: str, start: int, count: int, batch=slice(None),
                      rows=slice(None)) -> np.ndarray:
        """Raw source-dtype frames (B, count, C, H, W) in the source's memory
        order; short tails are padded by repeating the last frame (the metric
        trims the padded outputs). ``batch`` and ``rows`` select one rank's
        pairs and rows under a mesh."""
        src = self._bfchw(which)
        end = min(start + count, src.shape[1])
        with spans.span("cvvdp.read", frames=count, padded=count - (end - start)):
            block = src[batch, start:end, :, rows]
            if end - start < count:
                # Padded in memory order, so a channel-last block stays one.
                order = _memory_order(block)
                mem = block.transpose(order)
                f = order.index(1)
                last = mem[(slice(None),) * f + (slice(-1, None),)]
                pad = np.repeat(last, count - (end - start), axis=f)
                block = np.concatenate([mem, pad], axis=f).transpose(np.argsort(order))
            return block

    def get_raw_frame_list(self, which: str, indices) -> np.ndarray:
        """Arbitrary raw frames (B, len(indices), C, H, W) in the source's
        memory order: the symmetric head."""
        src = self._bfchw(which)
        order = _memory_order(src)
        frames = np.take(src.transpose(order), list(indices), axis=order.index(1))
        return frames.transpose(np.argsort(order))
