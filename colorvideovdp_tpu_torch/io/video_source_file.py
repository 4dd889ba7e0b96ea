"""File-backed video and image sources.

Counterpart of the JAX package's ``io/video_source_file.py``. Video decode
prefers the native codec library (``io/ffcodec.py``: in-process libavcodec,
8/10/12-bit planar YUV, converted on the metric's device by
``io/yuv.py`` ``unpack_planar``) and falls back to OpenCV's bundled FFmpeg
(``cv2.VideoCapture``, 8-bit RGB) where the library is not built or cannot
open the file. Images use imageio, ``.hdr`` cv2, and ``.exr`` the package's
own EXR codec (``utils/exr.py``). ``.mat`` files use scipy.

Decoded frames stream into the metric through the raw-block protocol
(``get_raw_block``): the host decodes a block of frames into one contiguous
uint8/uint16 buffer and every conversion (dtype, EOTF, colour) happens on
the device. The per-frame API (``get_test_frame``) returns tensors on the
device it is given, the card when none is given.
"""

from __future__ import annotations

import logging
import math
import os
import re

import numpy as np
import torch

from ..metrics.base import vq_exception
from .video_source import frame_device, frame_to_float32, upload, video_source_dm

logger = logging.getLogger(__name__)

IMG_EXTENSIONS = [
    ".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif", ".tiff", ".exr", ".hdr",
    ".dds", ".webp",
]


def load_image_as_array(imgfile: str) -> np.ndarray:
    """Image file -> numpy array (H, W, C); 16-bit PNG kept, EXR/HDR as
    float32 linear."""
    if not os.path.isfile(imgfile):
        msg = f"File '{imgfile}' not found"
        logger.error(msg)
        raise FileNotFoundError(msg)

    ext = os.path.splitext(imgfile)[1].lower()
    if ext == ".exr":
        from ..utils import exr

        img = exr.read(imgfile)
    elif ext == ".hdr":
        import cv2

        img = cv2.imread(imgfile, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise vq_exception(f"Cannot read image '{imgfile}'")
        if img.ndim == 3 and img.shape[2] >= 3:
            img = img[:, :, [2, 1, 0]]  # BGR -> RGB
        img = np.ascontiguousarray(img.astype(np.float32))
    else:
        import imageio.v2 as iio

        img = np.asarray(iio.imread(imgfile))

    if img.ndim == 3 and img.shape[2] > 3:
        logging.warning(
            f"Input image {imgfile} has more than 3 channels (alpha?). "
            "Ignoring the extra channels.")
        img = img[:, :, :3]
    if img.ndim == 2:
        img = img[:, :, np.newaxis]
    return img


class video_reader:
    """Sequential mp4/mov/... decoder via OpenCV (bundled FFmpeg): metadata,
    optional resize, frame-count limit, sequential ``get_frame()``."""

    def __init__(self, vidfile, frames=-1, resize_fn=None, resize_height=-1,
                 resize_width=-1, verbose=False):
        import cv2

        self.cap = cv2.VideoCapture(vidfile)
        if not self.cap.isOpened():
            raise vq_exception(f"Cannot open video file '{vidfile}'")
        self.fname = vidfile
        self.fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.src_width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.src_height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        meta_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if meta_frames <= 0 or frames == -2:
            # No frame count in the container, or an accurate count asked
            # for: count by decoding.
            meta_frames = self._count_frames(vidfile)
        self.frames = meta_frames if frames in (-1, -2) else min(frames, meta_frames)
        self.resize_fn = resize_fn
        if resize_fn is not None and resize_width > 0 and resize_height > 0:
            self.width, self.height = resize_width, resize_height
        else:
            self.resize_fn = None
            self.width, self.height = self.src_width, self.src_height
        self.curr_frame = -1

    @staticmethod
    def _count_frames(vidfile):
        import cv2

        cap = cv2.VideoCapture(vidfile)
        n = 0
        while cap.grab():
            n += 1
        cap.release()
        return n

    def get_frame(self):
        """Next frame as RGB uint8 (H, W, 3), or None at the end."""
        import cv2

        ok, frame = self.cap.read()
        if not ok:
            return None
        self.curr_frame += 1
        if self.resize_fn is not None:
            interp = {
                "bilinear": cv2.INTER_LINEAR,
                "bicubic": cv2.INTER_CUBIC,
                "nearest": cv2.INTER_NEAREST,
                "area": cv2.INTER_AREA,
            }[self.resize_fn]
            frame = cv2.resize(frame, (self.width, self.height), interpolation=interp)
        return np.ascontiguousarray(frame[:, :, ::-1])  # BGR -> RGB

    def seek_to_start(self):
        import cv2

        self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        self.curr_frame = -1

    def unload(self):
        self.cap.release()


class video_source_video_file(video_source_dm):
    """A pair of video files decoded by OpenCV: readers opened on first use,
    the shorter file's frame count, an error on differing frame rates."""

    def __init__(self, test_fname, reference_fname, display_photometry="sdr_4k_30",
                 config_paths=None, frames=-1, full_screen_resize=None,
                 resize_resolution=None, ffmpeg_cc=False, verbose=False):
        super().__init__(display_photometry=display_photometry, config_paths=config_paths)
        self.test_fname = test_fname
        self.reference_fname = reference_fname
        self.frames = frames
        self.full_screen_resize = full_screen_resize
        self.resize_resolution = resize_resolution
        self.verbose = verbose
        self.reader = {}
        self._initialized = False
        self._block_cache = {}

    def _init_readers(self):
        if self._initialized:
            return
        rr = (None, None) if self.full_screen_resize is None else self.resize_resolution
        for which, fname in (("test", self.test_fname), ("reference", self.reference_fname)):
            self.reader[which] = video_reader(
                fname, self.frames, resize_fn=self.full_screen_resize,
                resize_width=rr[0] if rr[0] else -1, resize_height=rr[1] if rr[1] else -1,
                verbose=self.verbose)
        t, r = self.reader["test"], self.reader["reference"]
        if t.fps != r.fps:
            raise vq_exception(
                "Test and reference videos have different frame rates. "
                "Use --temp-resample to resample to a common frame rate.")
        if (t.width, t.height) != (r.width, r.height):
            raise vq_exception("Test and reference videos have different resolutions")
        if t.frames != r.frames:
            logging.warning(
                f"Test and reference videos have different number of frames "
                f"({t.frames} vs {r.frames}). Comparing "
                f"{min(t.frames, r.frames)} frames.")
        self.N_frames = min(t.frames, r.frames)
        if getattr(self.dm_photometry, "EOTF", None) == "PQ":
            # OpenCV decodes to 8 bits a channel: HDR content is quantized.
            logging.warning(
                "PQ display model with mp4 input through the OpenCV "
                "fallback reader: decode is capped at 8 bits/channel; "
                ">8-bit HDR content will be quantized. Build the native "
                "codec core (make -C native) for full-precision mp4 "
                "decode, or use raw .yuv / EXR frame sequences.")
        self._initialized = True

    def get_video_size(self):
        self._init_readers()
        t = self.reader["test"]
        return (t.height, t.width, self.N_frames)

    def get_frames_per_second(self):
        self._init_readers()
        return self.reader["test"].fps

    # Raw-block protocol -----------------------------------------------------

    def get_raw_block(self, which, start, count):
        """``count`` frames from ``start`` as one contiguous (1, count, 3, H, W)
        uint8 buffer; sequential reads, a read of an earlier frame rewinds."""
        self._init_readers()
        rd = self.reader[which]
        if start <= rd.curr_frame:
            # curr_frame is the last frame handed out: start == curr_frame
            # is a re-read, not the next frame.
            rd.seek_to_start()
        block = np.empty((1, count, 3, rd.height, rd.width), np.uint8)
        last = None
        for i in range(count):
            idx = start + i
            if idx < self.N_frames:
                while rd.curr_frame < idx - 1:
                    rd.get_frame()  # skip
                frame = rd.get_frame()
                if frame is None:
                    frame = last if last is not None else np.zeros(
                        (rd.height, rd.width, 3), np.uint8)
                last = frame
            else:
                frame = last if last is not None else np.zeros((rd.height, rd.width, 3),
                                                               np.uint8)
            block[0, i] = frame.transpose(2, 0, 1)
        return block

    def get_raw_frame_list(self, which, indices):
        """A few frames (the padding head) as (1, len(indices), 3, H, W),
        decoded once and cached; the indices lie within the first
        filter-length frames."""
        return np.stack([self._get_cached_frame(which, i) for i in indices], axis=0)[None]

    def _get_cached_frame(self, which, idx):
        key = (which, idx)
        if key not in self._block_cache:
            need = idx + 1
            blk = self.get_raw_block(which, 0, need)
            self.reader[which].seek_to_start()
            for i in range(need):
                self._block_cache[(which, i)] = blk[0, i]
        return self._block_cache[key]

    # Per-frame API ------------------------------------------------------------

    def get_test_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("test", frame, device, colorspace)

    def get_reference_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("reference", frame, device, colorspace)

    def _frame(self, which, frame, device, colorspace):
        raw = self.get_raw_block(which, frame, 1)[0, 0]  # (3, H, W)
        raw = frame_to_float32(raw[None, :, None], frame_device(device))
        return self.apply_dm_and_color_transform(raw, colorspace)


class video_source_image_frames(video_source_dm):
    """A single image pair, or a pair of %0Nd-numbered frame sequences."""

    def __init__(self, test_fname, reference_fname, display_photometry="sdr_4k_30",
                 config_paths=None, frames=-1, fps=0, frame_range=None, **kwargs):
        super().__init__(display_photometry=display_photometry, config_paths=config_paths)
        self.test_pattern = test_fname
        self.ref_pattern = reference_fname
        self.fps = fps or 0

        if re.search(r"%\d*d", test_fname):
            if not fps:
                raise vq_exception("When passing frame sequences you must specify --fps")
            self.is_sequence = True
            frame_ids = self._find_frames(test_fname, frame_range)
            if frames > 0:
                frame_ids = frame_ids[:frames]
            self.frame_ids = frame_ids
            self.N_frames = len(frame_ids)
            first = load_image_as_array(test_fname % frame_ids[0])
        else:
            self.is_sequence = False
            self.N_frames = 1
            self.frame_ids = [0]
            first = load_image_as_array(test_fname)
        self.H, self.W = first.shape[0], first.shape[1]
        self.C = first.shape[2]
        self._first = first
        self._cache = {}

    @staticmethod
    def _find_frames(pattern, frame_range):
        if frame_range is not None:
            ids = []
            for i in frame_range:
                if os.path.isfile(pattern % i):
                    ids.append(i)
                else:
                    break
            if not ids:
                raise vq_exception(
                    f"No frames found for pattern '{pattern}' in the given range")
            return ids
        # Probe from 0 or 1 upward.
        start = 0 if os.path.isfile(pattern % 0) else 1
        if not os.path.isfile(pattern % start):
            raise vq_exception(f"No frames found for pattern '{pattern}'")
        ids = []
        i = start
        while os.path.isfile(pattern % i):
            ids.append(i)
            i += 1
        return ids

    def get_video_size(self):
        return (self.H, self.W, self.N_frames)

    def get_frames_per_second(self):
        return self.fps

    def _load(self, which, idx):
        key = (which, idx)
        if key not in self._cache:
            pattern = self.test_pattern if which == "test" else self.ref_pattern
            if self.is_sequence:
                img = load_image_as_array(pattern % self.frame_ids[idx])
            else:
                img = load_image_as_array(pattern)
            self._cache[key] = np.ascontiguousarray(img.transpose(2, 0, 1))
            if len(self._cache) > 8:  # bound the cache for long sequences
                oldest = next(iter(self._cache))
                if oldest != key:
                    del self._cache[oldest]
        return self._cache[key]

    def get_raw_block(self, which, start, count):
        frames = [self._load(which, min(start + i, self.N_frames - 1)) for i in range(count)]
        return np.stack(frames, axis=0)[None]  # (1, count, C, H, W)

    def get_raw_frame_list(self, which, indices):
        return np.stack([self._load(which, i) for i in indices], axis=0)[None]

    def get_test_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("test", frame, device, colorspace)

    def get_reference_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("reference", frame, device, colorspace)

    def _frame(self, which, frame, device, colorspace):
        raw = frame_to_float32(self._load(which, frame)[None, :, None], frame_device(device))
        return self.apply_dm_and_color_transform(raw, colorspace)


class video_source_matlab(video_source_dm):
    """Test/reference content from .mat files: the first variable with 2-4
    dimensions and more than 10 elements, found at the top level or inside
    MATLAB structs; its dimension order inferred (HW, HWC, HWF or HWCF)."""

    def __init__(self, test_fname, reference_fname, display_photometry="sdr_4k_30",
                 config_paths=None, fps=0, **kwargs):
        super().__init__(display_photometry=display_photometry, config_paths=config_paths)
        self.test, mat_fps = self._load_mat(test_fname)
        self.ref, _ = self._load_mat(reference_fname)
        if self.test.shape != self.ref.shape:
            raise vq_exception("Test and reference .mat content must have the same shape")
        self.N_frames = self.test.shape[1]
        # The fps argument, then the .mat's own 'fps' variable, then 30.
        self.fps = fps or mat_fps or (30 if self.N_frames > 1 else 0)

    @staticmethod
    def _is_content(a):
        return (isinstance(a, np.ndarray) and a.dtype.names is None
                and 1 < a.ndim <= 4 and a.size > 10)

    @classmethod
    def _walk_struct(cls, obj, found):
        """Content candidates and 'fps' scalars of nested mat_struct objects
        (depth first, in field order)."""
        for name in obj._fieldnames:
            elem = obj.__dict__[name]
            if name == "fps" and np.ndim(elem) == 0:
                found.setdefault("fps", float(elem))
            elif hasattr(elem, "_fieldnames"):
                cls._walk_struct(elem, found)
            elif cls._is_content(elem):
                found.setdefault("content", elem)

    @classmethod
    def _load_mat(cls, fname):
        from scipy.io import loadmat

        v = loadmat(fname)
        keys = [k for k in v.keys() if not k.startswith("__")]
        a = next((v[k] for k in keys if cls._is_content(v[k])), None)
        fps = float(np.asarray(v["fps"]).reshape(-1)[0]) if "fps" in v else 0.0
        if a is None:
            # Nothing at the top level: load the structs as objects and walk
            # them for the content (and an fps field).
            found = {}
            vs = loadmat(fname, struct_as_record=False, squeeze_me=True)
            for k in keys:
                if hasattr(vs[k], "_fieldnames"):
                    cls._walk_struct(vs[k], found)
            if "content" not in found:
                raise vq_exception(f"No image/video variable found in '{fname}'")
            a = np.atleast_2d(found["content"])
            fps = fps or found.get("fps", 0.0)
        if a.ndim == 2:
            a = a[:, :, None, None]  # H W C F
        elif a.ndim == 3:
            if a.shape[2] in (1, 3):
                a = a[:, :, :, None]  # H W C (F=1)
            else:
                a = a[:, :, None, :]  # H W (C=1) F
        a = a.transpose(3, 2, 0, 1)[None]  # (H, W, C, F) -> (B, F, C, H, W)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        return np.ascontiguousarray(a), fps

    def get_video_size(self):
        return (self.test.shape[3], self.test.shape[4], self.N_frames)

    def get_frames_per_second(self):
        return self.fps

    def get_raw_block(self, which, start, count):
        src = self.test if which == "test" else self.ref
        end = min(start + count, self.N_frames)
        block = src[:, start:end]
        if end - start < count:
            pad = np.repeat(block[:, -1:], count - (end - start), axis=1)
            block = np.concatenate([block, pad], axis=1)
        return block

    def get_raw_frame_list(self, which, indices):
        src = self.test if which == "test" else self.ref
        return np.ascontiguousarray(src[:, list(indices)])

    def get_test_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("test", frame, device, colorspace)

    def get_reference_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("reference", frame, device, colorspace)

    def _frame(self, which, frame, device, colorspace):
        raw = self.get_raw_block(which, frame, 1)[:, 0][:, :, None]
        return self.apply_dm_and_color_transform(frame_to_float32(raw, frame_device(device)),
                                                 colorspace)


class format_mismatch_error(Exception):
    """Test and reference decode to different planar layouts, which one
    unpack cannot serve."""


class video_source_codec_file(video_source_dm):
    """Pair of video files decoded natively to planar YUV (``io/ffcodec.py``),
    converted on the device: fixed-point scaling (limited or full range),
    half-pixel bilinear chroma upsample and the BT.601/709/2020 YCbCr->RGB
    matrix of the stream's metadata, in float32."""

    def __init__(self, test_fname, reference_fname, display_photometry="sdr_4k_30",
                 config_paths=None, frames=-1, full_screen_resize=None,
                 resize_resolution=None, ffmpeg_cc=False, verbose=False, preload=False):
        super().__init__(display_photometry=display_photometry, config_paths=config_paths)
        from . import ffcodec

        self.reader = {
            "test": ffcodec.CodecVideoReader(test_fname, frames),
            "reference": ffcodec.CodecVideoReader(reference_fname, frames),
        }
        t, r = self.reader["test"], self.reader["reference"]
        key_t = (t.bit_depth, t.chroma_ss, t.color_space, t.color_range_full)
        key_r = (r.bit_depth, r.chroma_ss, r.color_space, r.color_range_full)
        if key_t != key_r:
            raise format_mismatch_error(f"test {key_t} vs reference {key_r}")
        if t.avg_fps != r.avg_fps:
            raise vq_exception(
                "Test and reference videos have different frame rates. "
                "Use --temp-resample to resample to a common frame rate.")
        if (t.width, t.height) != (r.width, r.height):
            raise vq_exception("Test and reference videos have different resolutions")
        if t.frames != r.frames:
            logging.warning(
                f"Test and reference videos have different number of frames "
                f"({t.frames} vs {r.frames}). Comparing "
                f"{min(t.frames, r.frames)} frames.")
        self.N_frames = min(t.frames, r.frames)
        self.full_screen_resize = full_screen_resize
        self.resize_resolution = resize_resolution
        self._head_cache = {}
        self._preloaded = {} if preload else None

    def get_video_size(self):
        if self.full_screen_resize is not None:
            return (self.resize_resolution[1], self.resize_resolution[0], self.N_frames)
        t = self.reader["test"]
        return (t.height, t.width, self.N_frames)

    def get_frames_per_second(self):
        return self.reader["test"].avg_fps

    # Raw-block protocol -----------------------------------------------------

    def get_raw_block(self, which, start, count):
        if self._preloaded is not None:
            src = self._preload(which)
            end = min(start + count, self.N_frames)
            block = src[start:end]
            if end - start < count:
                block = np.concatenate(
                    [block, np.repeat(block[-1:], count - (end - start), axis=0)], axis=0)
            return block[None]
        return self.reader[which].get_packed_frames(start, count)[None]

    def _preload(self, which):
        if which not in self._preloaded:
            self._preloaded[which] = self.reader[which].get_packed_frames(0, self.N_frames)
        return self._preloaded[which]

    def get_raw_frame_list(self, which, indices):
        """A few frames (the symmetric padding head), within the first
        filter-length frames: decoded once, cached, and the reader rewound
        so that sequential block reads still start at 0."""
        if self._preloaded is not None:
            src = self._preload(which)
            return np.stack([src[i] for i in indices])[None]
        need = max(indices) + 1
        if (which, need) not in self._head_cache:
            rd = self.reader[which]
            frames = rd.get_packed_frames(0, need)
            rd.seek_to_start()
            self._head_cache[(which, need)] = frames
        frames = self._head_cache[(which, need)]
        return np.stack([frames[i] for i in indices])[None]

    def raw_block_key(self):
        rd = self.reader["test"]
        return ("codec", rd.width, rd.height, rd.bit_depth, rd.chroma_ss, rd.color_space,
                rd.color_range_full, self.full_screen_resize,
                tuple(self.resize_resolution or ()))

    def unpack_raw_block(self, x: torch.Tensor) -> torch.Tensor:
        """Packed planar (B, F, frame_pixels) on the device -> display-encoded
        RGB (B, 3, F, H, W), with the stream's range and true colour matrix."""
        from .ffcodec import ycbcr_to_rgb_matrix
        from .yuv import unpack_planar

        rd = self.reader["test"]
        return unpack_planar(x, rd, ycbcr_to_rgb_matrix(rd.color_space),
                             full_range=rd.color_range_full,
                             full_screen_resize=self.full_screen_resize,
                             resize_resolution=self.resize_resolution)

    # Per-frame API ------------------------------------------------------------

    def get_test_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("test", frame, device, colorspace)

    def get_reference_frame(self, frame, device=None, colorspace="DKLd65"):
        return self._frame("reference", frame, device, colorspace)

    def _frame(self, which, frame, device, colorspace):
        x = upload(self.get_raw_block(which, frame, 1), frame_device(device))
        return self.apply_dm_and_color_transform(self.unpack_raw_block(x), colorspace)


class video_source_video_file_preload(video_source_video_file):
    """The OpenCV pair read whole into memory, for random access."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._preloaded = {}

    def _preload(self, which):
        if which not in self._preloaded:
            self._init_readers()
            self._preloaded[which] = super().get_raw_block(which, 0, self.N_frames)
        return self._preloaded[which]

    def get_raw_block(self, which, start, count):
        src = self._preload(which)
        end = min(start + count, self.N_frames)
        block = src[:, start:end]
        if end - start < count:
            pad = np.repeat(block[:, -1:], count - (end - start), axis=1)
            block = np.concatenate([block, pad], axis=1)
        return block

    def get_raw_frame_list(self, which, indices):
        src = self._preload(which)
        return np.ascontiguousarray(src[:, list(indices)])


class video_source_temp_resample_file(video_source_dm):
    """Videos of different frame rates, both resampled (nearest frame) to a
    common rate: the least common multiple of the two, halved while it
    exceeds ``max_fps``."""

    max_fps = 166

    def __init__(self, test_fname, reference_fname, display_photometry="sdr_4k_30",
                 config_paths=None, frames=-1, full_screen_resize=None,
                 resize_resolution=None, ffmpeg_cc=False, verbose=False):
        super().__init__(display_photometry=display_photometry, config_paths=config_paths)
        mk = dict(display_photometry=display_photometry, config_paths=config_paths,
                  frames=frames, full_screen_resize=full_screen_resize,
                  resize_resolution=resize_resolution, verbose=verbose)
        self.vs = {}
        # Each file becomes its own pair (test == reference), preloaded for
        # random access: the native planar decode where it is enabled, the
        # OpenCV reader otherwise.
        from . import ffcodec

        def _mk_pair(fname):
            if ffcodec.enabled():
                try:
                    return video_source_codec_file(fname, fname, preload=True, **mk)
                except vq_exception:
                    raise
                except Exception as e:
                    logging.warning(
                        f"Native decode unavailable for '{fname}' ({e}); "
                        "falling back to the OpenCV reader.")
            return video_source_video_file_preload(fname, fname, **mk)

        self.vs["test"] = _mk_pair(test_fname)
        self.vs["reference"] = _mk_pair(reference_fname)
        # One unpack serves both streams: packed-planar inner sources surface
        # theirs here, and where the two decode to different layouts both
        # drop to the OpenCV reader.
        t, r = self.vs["test"], self.vs["reference"]
        if hasattr(t, "unpack_raw_block") or hasattr(r, "unpack_raw_block"):
            if (hasattr(t, "unpack_raw_block") and hasattr(r, "unpack_raw_block")
                    and t.raw_block_key() == r.raw_block_key()):
                self.unpack_raw_block = t.unpack_raw_block
                self.raw_block_key = t.raw_block_key
            else:
                logging.warning(
                    "Temporal resampling with mixed decode formats; using "
                    "the OpenCV reader (8-bit RGB) for both streams.")
                self.vs["test"] = video_source_video_file_preload(test_fname, test_fname, **mk)
                self.vs["reference"] = video_source_video_file_preload(
                    reference_fname, reference_fname, **mk)
        t_fps = self.vs["test"].get_frames_per_second()
        r_fps = self.vs["reference"].get_frames_per_second()
        resample_fps = math.lcm(round(t_fps), round(r_fps))
        while resample_fps > self.max_fps:
            resample_fps /= 2
        self.resample_fps = resample_fps
        self.src_fps = {"test": t_fps, "reference": r_fps}
        t_len = self.vs["test"].get_video_size()[2] / t_fps
        r_len = self.vs["reference"].get_video_size()[2] / r_fps
        self.N_frames = int(min(t_len, r_len) * resample_fps)

    def get_video_size(self):
        h, w, _ = self.vs["test"].get_video_size()
        return (h, w, self.N_frames)

    def get_frames_per_second(self):
        return self.resample_fps

    def _src_index(self, which, frame):
        # The nearest source frame.
        src_fps = self.src_fps[which]
        n = self.vs[which].get_video_size()[2]
        return min(int(math.floor((frame + 0.5) * src_fps / self.resample_fps)), n - 1)

    def get_raw_block(self, which, start, count):
        idx = [self._src_index(which, min(start + i, self.N_frames - 1)) for i in range(count)]
        return self.vs[which].get_raw_frame_list(which, idx)

    def get_raw_frame_list(self, which, indices):
        idx = [self._src_index(which, i) for i in indices]
        return self.vs[which].get_raw_frame_list(which, idx)

    def get_test_frame(self, frame, device=None, colorspace="DKLd65"):
        return self.vs["test"]._frame("test", self._src_index("test", frame), device,
                                      colorspace)

    def get_reference_frame(self, frame, device=None, colorspace="DKLd65"):
        return self.vs["reference"]._frame("reference", self._src_index("reference", frame),
                                           device, colorspace)


def video_source_file(test_fname, reference_fname, display_photometry="sdr_4k_30",
                      config_paths=None, frames=-1, full_screen_resize=None,
                      resize_resolution=None, frame_range=None, fps=None, preload=False,
                      ffmpeg_cc=False, verbose=False):
    """A source for a file pair by extension: .mat -> ``video_source_matlab``,
    image extensions and %0Nd patterns -> ``video_source_image_frames``, .yuv
    -> ``video_source_yuv_file``, else video files: the native decoder where
    it is enabled (not with ``ffmpeg_cc``, which asks for the host-side
    colour conversion), the OpenCV reader otherwise or where the native
    decoder fails, optionally preloaded."""
    ext = os.path.splitext(test_fname)[1].lower()
    if ext == ".mat":
        return video_source_matlab(test_fname, reference_fname,
                                   display_photometry=display_photometry,
                                   config_paths=config_paths, fps=fps or 0)
    if ext in IMG_EXTENSIONS or re.search(r"%\d*d", test_fname):
        return video_source_image_frames(test_fname, reference_fname,
                                         display_photometry=display_photometry,
                                         config_paths=config_paths, frames=frames,
                                         fps=fps or 0, frame_range=frame_range)
    if ext == ".yuv":
        from .yuv import video_source_yuv_file

        return video_source_yuv_file(test_fname, reference_fname,
                                     display_photometry=display_photometry,
                                     config_paths=config_paths, frames=frames)
    kw = dict(display_photometry=display_photometry, config_paths=config_paths,
              frames=frames, full_screen_resize=full_screen_resize,
              resize_resolution=resize_resolution, ffmpeg_cc=ffmpeg_cc, verbose=verbose)
    from . import ffcodec

    if ffcodec.enabled() and not ffmpeg_cc:
        try:
            return video_source_codec_file(test_fname, reference_fname, preload=preload, **kw)
        except format_mismatch_error as e:
            logging.warning(
                f"Test/reference decode to different planar formats ({e}); "
                "falling back to the OpenCV reader (8-bit RGB).")
        except vq_exception:
            # User errors (fps/resolution mismatch) are not decode failures.
            raise
        except Exception as e:
            logging.warning(
                f"Native decode unavailable for this input ({e}); falling "
                "back to the OpenCV reader.")
    cls = video_source_video_file_preload if preload else video_source_video_file
    return cls(test_fname, reference_fname, **kw)
