"""Raw .yuv video source: numpy memmap on the host, unpack on the device.

Counterpart of the JAX package's ``io/yuv.py``. Metadata is parsed from the
file name (e.g. ``seq_1280x720p25_420_8bit_sdr.yuv``). The host slices
packed planar frames out of the memmap; the fixed-point to float
conversion, chroma upsampling and YCbCr->RGB matrix run on the metric's
device in ``unpack_raw_block`` (``unpack_planar``, shared with the decoded
video files of ``io/video_source_file.py``).
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np
import torch

from ..ops.resize import resize
from .video_source import frame_device, upload, video_source_dm


def decode_video_props(fname: str) -> dict:
    """Resolution, fps, bit depth, chroma subsampling and colour space from
    the file name."""
    vprops = {
        "width": 1920, "height": 1080, "fps": 24, "bit_depth": 8,
        "color_space": "709", "chroma_ss": "420",
    }
    bname = os.path.splitext(os.path.basename(fname))[0]
    res_match = re.compile(r"(\d+)x(\d+)p?(\d+)?")
    for field in bname.split("_"):
        if res_match.match(field):
            nums = re.findall(r"\d+", field)
            if len(nums) < 2 or len(nums) > 3:
                raise ValueError("Cannot decode the resolution")
            vprops["width"] = int(nums[0])
            vprops["height"] = int(nums[1])
            if len(nums) == 3:
                vprops["fps"] = int(nums[2])
        elif field.endswith("fps"):
            vprops["fps"] = float(field[:-3])
        elif field in ("444", "420", "422"):
            vprops["chroma_ss"] = field
        elif field in ("10", "10b", "10bit"):
            vprops["bit_depth"] = 10
        elif field in ("8", "8b", "8bit"):
            vprops["bit_depth"] = 8
        elif field in ("2020", "709"):
            vprops["color_space"] = field
        elif field in ("bt709", "sdr"):
            vprops["color_space"] = "709"
        elif field in ("ct2020", "pq2020", "hdr"):
            vprops["color_space"] = "2020"
    return vprops


def create_yuv_fname(basename: str, vprops: dict) -> str:
    fps = vprops["fps"]
    fps = round(fps, 3) if round(fps) != fps else int(fps)
    return (
        f"{basename}_{vprops['width']}x{vprops['height']}_"
        f"{vprops['bit_depth']}b_{vprops['chroma_ss']}_"
        f"{vprops['color_space']}_{fps}fps.yuv"
    )


class YUVReader:
    """Memmap-backed planar YUV reader."""

    def __init__(self, file_name):
        if not os.path.isfile(file_name):
            raise FileNotFoundError(f"File {file_name} not found")
        self.file_name = file_name
        p = decode_video_props(file_name)
        self.width, self.height = p["width"], p["height"]
        self.avg_fps = p["fps"]
        self.color_space = p["color_space"]
        self.chroma_ss = p["chroma_ss"]
        self.bit_depth = p["bit_depth"]

        self.y_pixels = self.width * self.height
        self.y_shape = (self.height, self.width)
        if self.chroma_ss == "444":
            self.uv_pixels = self.y_pixels
            self.uv_shape = self.y_shape
        elif self.chroma_ss == "420":
            self.uv_pixels = self.y_pixels // 4
            self.uv_shape = (self.height // 2, self.width // 2)
        elif self.chroma_ss == "422":
            self.uv_pixels = self.y_pixels // 2
            self.uv_shape = (self.height, self.width // 2)
        else:
            raise RuntimeError(f"Unsupported chroma subsampling {self.chroma_ss}")
        self.frame_pixels = self.y_pixels + 2 * self.uv_pixels
        self.dtype = np.uint16 if self.bit_depth > 8 else np.uint8
        self.frame_bytes = self.frame_pixels * (2 if self.bit_depth > 8 else 1)
        self.frames = int(os.stat(file_name).st_size // self.frame_bytes)
        self.mm = None

    def _map(self):
        if self.mm is None:
            self.mm = np.memmap(self.file_name, self.dtype, mode="r")
        return self.mm

    def get_frame_count(self):
        return self.frames

    def get_frame_yuv(self, frame_index):
        if frame_index < 0 or frame_index >= self.frames:
            raise RuntimeError("The frame index is outside the range of available frames")
        mm = self._map()
        o = frame_index * self.frame_pixels
        Y = mm[o:o + self.y_pixels]
        u = mm[o + self.y_pixels:o + self.y_pixels + self.uv_pixels]
        v = mm[o + self.y_pixels + self.uv_pixels:o + self.frame_pixels]
        return Y.reshape(self.y_shape), u.reshape(self.uv_shape), v.reshape(self.uv_shape)

    def get_packed_frames(self, start, count):
        """Contiguous packed planar frames (count, frame_pixels); frames past
        the end repeat the last frame."""
        from ..utils import native

        mm = self._map()
        if native.available():
            # One memcpy gather straight out of the memmap, without the GIL.
            src = np.asarray(mm[:self.frames * self.frame_pixels]).reshape(
                self.frames, self.frame_pixels)
            out = native.pack_frame_block(src, start, count)
            if out is not None:
                return out
        end = min(start + count, self.frames)
        o = start * self.frame_pixels
        # A copy: the file is read here, on the caller's thread (the metric's
        # prefetch worker), not later where the block is uploaded.
        data = np.array(mm[o:end * self.frame_pixels]).reshape(end - start, self.frame_pixels)
        if end - start < count:
            pad = np.repeat(data[-1:], count - (end - start), axis=0)
            data = np.concatenate([data, pad], axis=0)
        return data


# YCbCr -> RGB matrices of the .yuv files. The "709" entry holds the BT.601
# coefficients 1.402 / 1.772, as the reference metric's .yuv reader does.
_YCBCR2RGB = {
    "709": np.array(
        [[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]], np.float32),
    "2020": np.array(
        [[1.0, 0.0, 1.47460], [1.0, -0.16455, -0.57135], [1.0, 1.88140, 0.0]], np.float32),
}

_RESIZE_METHODS = {"bilinear": "linear", "bicubic": "cubic", "nearest": "nearest"}


def unpack_planar(x: torch.Tensor, rd, M: np.ndarray, full_range=False,
                  full_screen_resize=None, resize_resolution=None) -> torch.Tensor:
    """Packed planar frames (B, F, frame_pixels) of reader ``rd`` (uint8, or
    uint16 carried as int16 bits) -> display-encoded RGB (B, 3, F, H, W)
    float32, a view of frame-major memory: fixed point to float (limited or
    full range), half-pixel bilinear chroma upsample (``ops/resize.py``, as
    ``jax.image.resize``), the YCbCr -> RGB matrix ``M`` summed channel by
    channel in float32, clipped to 0..1, then the optional full-screen
    resize ("bilinear", "bicubic" or "nearest" to ``resize_resolution`` =
    (W, H))."""
    B, F = x.shape[0], x.shape[1]
    H, W = rd.y_shape
    uh, uw = rd.uv_shape
    if x.dtype in (torch.int16, torch.uint16):
        xf = (x.to(torch.int32) & 0xFFFF).to(torch.float32)
    else:
        xf = x.to(torch.float32)
    Y = xf[..., :rd.y_pixels].reshape(B, F, H, W)
    u = xf[..., rd.y_pixels:rd.y_pixels + rd.uv_pixels].reshape(B, F, uh, uw)
    v = xf[..., rd.y_pixels + rd.uv_pixels:].reshape(B, F, uh, uw)
    if full_range:
        m = float(2 ** rd.bit_depth - 1)
        c = float(2 ** (rd.bit_depth - 1))
        Y = torch.clamp(Y / m, 0.0, 1.0)
        u = torch.clamp((u - c) / m, -0.5, 0.5)
        v = torch.clamp((v - c) / m, -0.5, 0.5)
    else:
        d = 2.0 ** (rd.bit_depth - 8)
        Y = torch.clamp(Y / (d * 219.0) - 16.0 / 219.0, 0.0, 1.0)
        u = torch.clamp(u / (d * 224.0) - 128.0 / 224.0, -0.5, 0.5)
        v = torch.clamp(v / (d * 224.0) - 128.0 / 224.0, -0.5, 0.5)
    if rd.chroma_ss != "444":
        u = resize(u, (H, W), "linear")
        v = resize(v, (H, W), "linear")
    M = np.asarray(M, np.float32)
    rgb = torch.stack([
        torch.clamp(float(M[d, 0]) * Y + float(M[d, 1]) * u + float(M[d, 2]) * v, 0.0, 1.0)
        for d in range(3)], dim=2)  # (B, F, 3, H, W)
    if full_screen_resize is not None:
        method = _RESIZE_METHODS.get(full_screen_resize)
        if method is None:
            raise RuntimeError(
                f"Resize method '{full_screen_resize}' not supported for planar YUV sources")
        rw, rh = resize_resolution
        rgb = torch.clamp(resize(rgb, (rh, rw), method), 0.0, 1.0)
    return rgb.transpose(1, 2)


class video_source_yuv_file(video_source_dm):
    """Pair of raw .yuv files, unpacked on the metric's device."""

    def __init__(self, test_fname, reference_fname, display_photometry="standard_4k",
                 config_paths=None, frames=-1, full_screen_resize=None,
                 resize_resolution=None, verbose=False, **kwargs):
        super().__init__(display_photometry=display_photometry, config_paths=config_paths)
        self.test_vidr = YUVReader(test_fname)
        self.reference_vidr = YUVReader(reference_fname)
        self.total_frames = self.test_vidr.frames
        self.frames = self.total_frames if frames == -1 else min(self.total_frames, frames)
        self.offset = 0
        self.full_screen_resize = full_screen_resize
        self.resize_resolution = resize_resolution
        for vr, name in ((self.test_vidr, test_fname), (self.reference_vidr, reference_fname)):
            logging.debug(
                f"Video '{name}': [{vr.width}x{vr.height}], colorspace: "
                f"{vr.color_space}, EOTF: {self.dm_photometry.EOTF}, "
                f"fps: {vr.avg_fps}, frames: {self.frames}")

    def get_video_size(self):
        if self.full_screen_resize is not None:
            return (self.resize_resolution[1], self.resize_resolution[0], self.frames)
        return (self.test_vidr.height, self.test_vidr.width, self.frames)

    def get_frames_per_second(self):
        return self.test_vidr.avg_fps

    def set_offset(self, offset: int):
        self.offset = offset

    def set_num_frames(self, num_frames: int):
        if self.offset + num_frames > self.total_frames:
            logging.error(
                f"Cannot set num_frames={num_frames} because "
                f"offset={self.offset} and total_frames={self.total_frames}.")
            num_frames = self.total_frames - self.offset
        self.frames = num_frames

    # Raw-block protocol ---------------------------------------------------

    def get_raw_block(self, which, start, count):
        rd = self.test_vidr if which == "test" else self.reference_vidr
        return rd.get_packed_frames(self.offset + start, count)[None]

    def get_raw_frame_list(self, which, indices):
        rd = self.test_vidr if which == "test" else self.reference_vidr
        return np.stack([rd.get_packed_frames(self.offset + i, 1)[0] for i in indices])[None]

    def raw_block_key(self):
        rd = self.test_vidr
        return ("yuv", rd.width, rd.height, rd.bit_depth, rd.chroma_ss, rd.color_space,
                self.full_screen_resize, tuple(self.resize_resolution or ()))

    def unpack_raw_block(self, x: torch.Tensor) -> torch.Tensor:
        """Packed planar (B, F, frame_pixels) on the device -> display-encoded
        RGB (B, 3, F, H, W)."""
        rd = self.test_vidr
        return unpack_planar(x, rd, _YCBCR2RGB[rd.color_space],
                             full_screen_resize=self.full_screen_resize,
                             resize_resolution=self.resize_resolution)

    # Per-frame API ----------------------------------------------------------

    def get_test_frame(self, frame, device=None, colorspace="Y"):
        return self._frame(self.test_vidr, frame, device, colorspace)

    def get_reference_frame(self, frame, device=None, colorspace="Y"):
        return self._frame(self.reference_vidr, frame, device, colorspace)

    def _frame(self, rd, frame, device, colorspace):
        x = upload(rd.get_packed_frames(self.offset + frame, 1)[None], frame_device(device))
        return self.apply_dm_and_color_transform(self.unpack_raw_block(x), colorspace)
