"""ColorVideoVDP metric on PyTorch, with hand-written CUDA kernels.

Counterpart of ``colorvideovdp_tpu/metrics/cvvdp.py``: ``predict`` ->
``video_source_array`` -> ``predict_video_source``, which streams frame
blocks through the ingest kernel (carrying the fl-1 frames of the metric
colour space between blocks as tails), builds the pyramid with the reduce
kernel and scores every band with the band-masking kernel or the generic
masking chain, and the baseband with the CSF LUT kernel. The output is the
pooled JOD plus ``stats["Q_per_ch"]``.

Every contrast coding (weber_g1, weber_g1_ref, weber_g0_ref, log) and
masking model of the JAX package runs. The band route follows the JAX
package's configuration gate (``_process_block``): with the default
masking, every interior band takes the one-pass band kernel
(``band_pooled``) from each band's level and the next, in every contrast
coding; the generic chain (CSF LUT kernel, then
``masking.apply_masking_model`` with the blur kernel) takes every other
masking model, clamp or the cross-channel mix off. The bands that the JAX
package can send to its band mega-kernel take the same one-pass kernel
here, with the same result.

``heatmap`` ("raw", "threshold" or "supra-threshold") adds the per-pixel
distortion map ``stats["heatmap"]``: every interior band takes a D-output
mode (the one-pass kernel's, ``band_pooled_d``, whose pooled sums give the
Q columns, so the JOD is the pooled-only JOD), the per-band maps are pooled
over channels and
collapsed by the Laplacian reconstruct, and the colour maps are drawn block by
block on the device (``viz.py``). That path is forward-only.

``dump_channels`` (a ``dump_channels.DumpChannels``) writes each block's
temporal channels, contrast pyramid and per-band visual differences: a block
with dumps takes the heatmap's D route (so the JOD is the pooled-only JOD),
its contrast bands are formed by the plain ``interior_contrast`` from the
raw pairs, and the tensors are copied to the host once a block.

``get_loss_fn`` is the training entry point: a differentiable loss over
display-encoded image pairs. Every kernel on its path is a
``torch.autograd.Function`` whose backward is the TPU package's rule: the
adjoint of the plain reduce and blur, the analytic CSF LUT derivative
(a kernel), and a recompute of the plain band chain for the band masking.

Sources: a source with ``get_raw_block`` streams raw frame blocks (arrays,
images, ``.mat``, OpenCV-decoded video); one that also has
``unpack_raw_block`` (``.yuv`` and natively decoded video files) hands
packed planar blocks, unpacked on the device to display-encoded float32 RGB
that goes through the ingest kernel as float32 frames. ``_raw_blocks`` is
the one block producer for such sources: it reads each block (the next one
on a worker thread while this one is scored), uploads it and ingests it,
the first block through the ingest kernel's first-block modes; ``cvvdp``,
the ML metrics (``ml.py``) and the mesh (``parallel/sharding.py``) all
score its blocks. A source without
``get_raw_block`` is read frame by frame through ``get_test_frame`` in the
metric colour space, and its blocks skip the ingest kernel (the temporal
filter in plain PyTorch). ``temp_resample`` resamples ``Q_per_ch``'s frame
axis to ``nominal_fps`` before pooling.

With ``enable_fused_kernels = False`` every kernel is replaced by its plain
PyTorch version on the same device (the reference the kernels are held to).
"""

from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..io.video_source import upload
from ..ops import masking as mk
from ..ops.csf import CastleCSF
from ..ops.interp import interp1dim2, linspace32
from ..ops.kernels import band_pooled as bp
from ..ops.kernels import ingest as ing
from ..ops.kernels import masking_fused as bm
from ..ops.kernels.csf_lut import CsfLut
from ..ops import pyramid as pyr
from ..ops.pyramid import LaplacianPyramid, LogContrastPyramid, WeberContrastPyramid
from ..ops.temporal import get_temporal_filters
from ..utils import spans
from ..utils.config import config_files, json2dict
from .base import metric_device, no_tf32, register_metric, vq_exception, vq_metric

# Host memory budget (bytes) for the block-size model on the CPU when
# ``gpu_mem`` is unset (the reference metric assumes the same 4 GB).
HOST_MEM_BUDGET = 4e9


class _NoTF32(torch.autograd.Function):
    """fn(test, ref) with its forward and its backward (the recompute of a
    checkpointed block included) under ``no_tf32``: the backward of a loss
    runs after the forward's scope has closed, so the scope is taken again
    around the inner graph's backward."""

    @staticmethod
    def forward(ctx, fn, test, ref):
        ins = [t.detach().requires_grad_(t.requires_grad) for t in (test, ref)]
        with no_tf32(), torch.enable_grad():
            out = fn(*ins)
        ctx.ins, ctx.out = ins, out
        # The backward's spans join the forward's request (autograd may run
        # the backward on a thread of its own).
        ctx.spans = spans.carry()
        return out.detach()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        ins, out = ctx.ins, ctx.out
        ctx.ins = ctx.out = None
        need = [t for t in ins if t.requires_grad]
        with spans.resume(ctx.spans), spans.span("cvvdp.loss.backward"), no_tf32():
            grads = iter(torch.autograd.grad(out, need, g))
        return (None, *(next(grads) if t.requires_grad else None for t in ins))


class _BandMaps:
    """A block's heatmap, band by band: each band's D (B, C, F, h, w)
    pooled over the channels with the channel weights (``band``), then the
    baseband's, collapsed by the plain reconstruct (``heatmap``). The
    single-device and the sharded block share it."""

    def __init__(self, metric, all_ch, is_image, n_bands, dev):
        self.metric = metric
        self.w_ch = torch.as_tensor(metric.get_ch_weights(all_ch), device=dev).reshape(
            -1, 1, 1, 1) * (metric.image_int if is_image else 1.0)
        self.w_bb = self.w_ch * torch.as_tensor(metric.baseband_weight[:all_ch],
                                                device=dev).reshape(-1, 1, 1, 1)
        self.bands = [None] * n_bands

    def band(self, D, mul):
        """An interior band's map; interior bands are stored at gain ``mul``
        (lpyr_dec.py:308-314)."""
        return mk.lp_norm(D * self.w_ch, self.metric.beta_tch, dim=-4, normalize=False) / mul

    def heatmap(self, D_bb):
        """1 - JOD / 10 of the reconstructed map, (B, 1, F, H, W), from the
        interior bands' maps and the baseband's D."""
        m = self.metric
        self.bands[-1] = mk.lp_norm(D_bb * self.w_bb, m.beta_tch, dim=-4, normalize=False)
        return 1.0 - m.met2jod(m.heatmap_pyr.reconstruct(self.bands)) / 10.0


class cvvdp(vq_metric):
    """Full-reference perceptual image/video quality metric (JOD units)."""

    def __init__(self, display_name="standard_4k", display_photometry=None,
                 display_geometry=None, config_paths=None, heatmap=None, quiet=False,
                 device="cuda", temp_padding="replicate", use_checkpoints=False,
                 dump_channels=None, gpu_mem=None, temp_resample=False, nominal_fps=240):
        if heatmap not in ("threshold", "supra-threshold", "raw", "none", None):
            raise AssertionError("Unknown heatmap type")
        self.heatmap = heatmap
        self.do_heatmap = heatmap is not None and heatmap != "none"
        self.dump_channels = dump_channels
        if temp_padding not in ("replicate", "symmetric"):
            raise RuntimeError(f'Unknown padding method "{temp_padding}"')
        self.device = metric_device(device)
        self.quiet = quiet
        # Stored as the JAX package stores it; nothing reads it.
        self.use_checkpoints = use_checkpoints
        self.training_mode = False
        self.temp_padding = temp_padding
        self.gpu_mem = gpu_mem
        # Resampling of Q_per_ch's frame axis to a nominal frame rate.
        self.temp_resample = temp_resample
        self.nominal_fps = nominal_fps
        self.set_display_model(display_name, display_photometry=display_photometry,
                               display_geometry=display_geometry,
                               config_paths=config_paths)
        self.load_config(config_paths)

    # ------------------------------------------------------------------
    # Configuration

    def train(self, do_training=True):
        self.training_mode = do_training

    def set_display_model(self, display_name="standard_4k", display_photometry=None,
                          display_geometry=None, config_paths=None):
        super().set_display_model(display_name, display_photometry=display_photometry,
                                  display_geometry=display_geometry,
                                  config_paths=config_paths)
        self.lpyr = None
        self._cache = {}

    def load_config(self, config_paths=None):
        """Parse cvvdp_parameters.json (the attributes of the JAX package's
        ``load_config``)."""
        self.parameters_file = config_files.find("cvvdp_parameters.json", config_paths or [])
        p = json2dict(self.parameters_file)
        self.mask_p = float(p["mask_p"])
        self.mask_c = float(p["mask_c"])
        self.ce_g = float(p["ce_g"]) if "ce_g" in p else None
        self.k_c = float(p["k_c"]) if "k_c" in p else None
        self.pu_dilate = p["pu_dilate"]
        self.beta = float(p["beta"])
        self.beta_t = float(p["beta_t"])
        self.beta_tch = float(p["beta_tch"])
        self.beta_sch = float(p["beta_sch"])
        self.csf_sigma = float(p["csf_sigma"])
        self.sensitivity_correction = float(p["sensitivity_correction"])
        self.masking_model = p["masking_model"]
        self.csf_version = p["csf"]
        self.local_adapt = p["local_adapt"]
        self.contrast = p["contrast"]
        self.jod_a = float(p["jod_a"])
        self.jod_exp = float(p["jod_exp"])
        self.temp_filter = p.get("temp_filter", "default")
        if "mask_q" in p:
            self.mask_q = np.asarray(p["mask_q"], np.float32)
        else:
            self.mask_q_sust = float(p["mask_q_sust"])
            self.mask_q_trans = float(p["mask_q_trans"])
        self.filter_len = int(p["filter_len"])
        self.do_xchannel_masking = p["xchannel_masking"] == "on"
        self.xcm_weights = np.asarray(p["xcm_weights"], np.float32)
        self.image_int = float(p["image_int"])
        if "ch_chrom_w" in p:
            self.ch_chrom_w = float(p["ch_chrom_w"])
            self.ch_trans_w = float(p["ch_trans_w"])
        else:
            self.ch_weights = np.asarray(p["ch_weights"], np.float32)
        self.sigma_tf = np.asarray(p["sigma_tf"], np.float32)
        self.beta_tf = np.asarray(p["beta_tf"], np.float32)
        self.baseband_weight = np.atleast_1d(np.asarray(p["baseband_weight"], np.float32))
        self.dclamp_type = p["dclamp_type"]
        self.d_max = (float(p["d_max"]) if np.isscalar(p["d_max"])
                      else np.asarray(p["d_max"], np.float32))
        self.version = p["version"]
        self.omega = [0, 5]
        self.csf = CastleCSF(csf_version=self.csf_version, config_paths=config_paths)
        self.block_channels = (np.asarray(p["block_channels"], bool)
                               if "block_channels" in p else None)
        self.debug = False
        # Kernels on the card when True; their plain versions when False.
        self.enable_fused_kernels = True
        self.lpyr = None
        self._cache = {}

    def update_from_checkpoint(self, ckpt):
        """Load calibrated parameters from a Lightning-style torch checkpoint
        (reference: cvvdp_metric.py:231-243)."""
        state = torch.load(ckpt, map_location="cpu")["state_dict"]
        prefix = "params."
        for key, value in state.items():
            if key.startswith(prefix):
                v = value.detach().cpu().numpy()
                setattr(self, key[len(prefix):], v if v.ndim else float(v))
        self.lpyr = None
        self._cache = {}

    def load_parameters(self, d: dict):
        """Apply calibrated values (for example ``convert.params_from_jax``):
        metric attributes by name, ``display_*`` keys on the photometric
        model and ``pix_per_deg`` on the geometry."""
        for key, value in d.items():
            if key == "pix_per_deg":
                self.pix_per_deg = float(value)
            elif key.startswith("display_"):
                setattr(self.display_photometry, key[len("display_"):], value)
            else:
                setattr(self, key, value)
        self.lpyr = None
        self._cache = {}

    def get_ch_weights(self, no_channels):
        if hasattr(self, "ch_chrom_w"):
            w = np.array([1.0, self.ch_chrom_w, self.ch_chrom_w, self.ch_trans_w], np.float32)
        else:
            w = np.asarray(self.ch_weights, np.float32)
        return w[:no_channels]

    def _masking_params(self) -> mk.MaskingParams:
        if hasattr(self, "mask_q"):
            mask_q = np.asarray(self.mask_q, np.float32)
        else:
            q_sust = float(np.clip(self.mask_q_sust, 1.0, 7.0))
            q_trans = float(np.clip(self.mask_q_trans, 1.0, 7.0))
            mask_q = np.array([q_sust, q_sust, q_sust, q_trans], np.float32)
        return mk.MaskingParams(
            masking_model=self.masking_model, mask_p=float(self.mask_p),
            mask_q=tuple(mask_q.tolist()), mask_c=float(self.mask_c),
            pu_dilate=self.pu_dilate,
            xcm_weights=tuple(np.asarray(self.xcm_weights, np.float32).tolist()),
            do_xchannel_masking=self.do_xchannel_masking, dclamp_type=self.dclamp_type,
            d_max=self.d_max, ce_g=self.ce_g, k_c=self.k_c)

    def met_colorspace(self) -> str:
        """The metric colour space: log-LMS DKL exactly when the contrast is
        "log" (``_ensure_pyramids`` tests the prefix, as the JAX package does)."""
        return "logLMS_DKLd65" if self.contrast == "log" else "DKLd65"

    def loss(self, test_cont, reference_cont, dim_order="BCFHW", frames_per_second=0):
        """10 - JOD of ``predict`` (not differentiable, as in the JAX package)."""
        Q_jod, _ = self.predict(test_cont, reference_cont, dim_order=dim_order,
                                frames_per_second=frames_per_second)
        return 10.0 - Q_jod

    def get_loss_fn(self, height, width, colorspace="sRGB", remat=True, mesh=None):
        """A differentiable loss over display-encoded (B, 3, 1, H, W) float32
        image pairs on the metric's device: fn(test, ref) -> mean(10 - JOD).

        Counterpart of the JAX package's ``get_loss_fn``; ``remat`` wraps the
        per-block compute in ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint``)
        to trade a second forward for activation memory. ``colorspace`` is
        ignored, as in the JAX package.

        ``mesh`` (``parallel/sharding.py`` ``shard_loss_fn``): the pairs are
        this rank's slab (B / n_batch, 3, 1, H / n_space, W) of the global
        (B, 3, 1, ``height``, ``width``) batch; every rank returns the same
        loss, and its backward leaves each rank the gradient of its slab.
        The recompute of a checkpointed block then runs whole (no early
        stop), so that every rank issues the same collectives."""
        self._ensure_pyramids(width, height)
        dm = self.display_photometry
        met_cs = self.met_colorspace()

        def block(test, ref):
            # Run again inside the backward, the block is the checkpoint's
            # recompute.
            name = ("cvvdp.loss.recompute" if spans.inside("cvvdp.loss.backward")
                    else "cvvdp.block")
            with spans.span(name):
                with spans.span("cvvdp.ingest"):
                    T = dm.source_2_target_colorspace(test, met_cs)
                    R = dm.source_2_target_colorspace(ref, met_cs)
                    R = ing.interleave_tr(T, R)
                return self._process_block(R, temp_ch=1, is_image=True, mesh=mesh)[0]

        def loss(test, ref):
            if remat:
                with set_checkpoint_early_stop(mesh is None):
                    Q_per_ch = checkpoint(block, test, ref, use_reentrant=False)
            else:
                Q_per_ch = block(test, ref)
            return torch.mean(10.0 - self.do_pooling_and_jods(Q_per_ch))

        def loss_fn(test, ref):
            with spans.span("cvvdp.loss.forward"):
                if not torch.is_grad_enabled():
                    with no_tf32():
                        return loss(test, ref)
                return _NoTF32.apply(loss, test, ref)

        return loss_fn

    # ------------------------------------------------------------------
    # Scoring

    # The reference metric's memory model of a block, (a, b, c) in
    # total = a + pix (N + fl - 1) b + pix N c bytes: every route but the
    # pooled route on the card (``_block_mem_model``).
    mem_model = (1.6e9, 16, 320)
    # The pooled route's model on the card, from its peak on an H100
    # (``tools/block_memory.py``: 4K blocks of 1 to 32 frames in every
    # contrast coding alike, and of 32 to 160 frames; FHD blocks of 1 to 160):
    # 44.0 bytes a pixel-frame for uint16 arrays, 56.0 for float32 arrays and
    # for a packed 10-bit 4:2:0 .yuv pair (its float32 unpack), plus the tails,
    # 3.189 GB at 4K and 0.80 GB at FHD: fl - 1 = 8 frames of both sides' 3
    # float32 channels, the old and the new alive across the ingest, so
    # b = 48 (the fixed term fits at 3-5 MB). c = 12 puts b + c 6% over 56.0
    # for the caching allocator's rounding: a 32-frame 4K block is 19.2 GB
    # (measured 18.05), a 160-frame one 82.5 GB (measured 77.5). The
    # reference model's c = 320 held a 32-frame 4K clip to 23-frame blocks of
    # an H100.
    pooled_mem_model = (0.1e9, 48, 12)

    def _device_free(self) -> int:
        """The device memory a block may take: the free memory
        ``mem_get_info`` reports and the memory the caching allocator holds
        unused. After a clip the allocator keeps its blocks, which
        ``mem_get_info`` no longer counts free, and the next clip would be
        sized to what is left beside them."""
        dev = self.device
        return (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))

    def _block_mem_model(self, reference_model=False):
        """(a, b, c) of the route this metric's blocks take:
        ``pooled_mem_model`` where every interior band takes the one-pass
        pooled kernel on the card, else ``mem_model``. ``reference_model``:
        the caller's loop keeps ``mem_model`` whatever the metric's state: the
        mesh, and a source read frame by frame (its float32 frames and the
        plain temporal filter peak at 127.6 bytes a pixel-frame, which the
        reference model covers)."""
        pooled = (self.pooled_mem_model is not None and not reference_model
                  and self.device.type == "cuda" and self.enable_fused_kernels
                  and not self.do_heatmap and not self.dump_channels
                  and self._masking_params().fusable())
        return self.pooled_mem_model if pooled else self.mem_model

    def estimate_block_N(self, pix_cnt, N_frames, share=1, reference_model=False):
        """Frames per block from the route's memory model
        (``_block_mem_model``): total = a + pix (N + fl - 1) b + pix N c.
        ``share``: the number of ranks that divide the device's memory.
        On the pooled route, where a large card holds long blocks (about 160
        4K frames on an H100) and block boundaries enter no output, the clip
        is spread evenly over the blocks it needs, so that the padded
        trailing block takes fewer frames than there are blocks; a user's
        ``gpu_mem`` pins the largest block that memory holds
        (``block_gpu_mem``)."""
        if self.device.type == "cuda":
            mem_avail = self._device_free()
            if self.gpu_mem is not None:
                mem_avail = min(mem_avail, self.gpu_mem * 1e9)
        else:
            mem_avail = HOST_MEM_BUDGET if self.gpu_mem is None else self.gpu_mem * 1e9
        mem_avail /= share
        model = self._block_mem_model(reference_model)
        a, b, c = model
        max_frames = int(math.floor(
            (mem_avail - a - pix_cnt * (self.filter_len - 1) * b) / (pix_cnt * (b + c))))
        block_N = max(1, min(max_frames, N_frames))
        if model is self.pooled_mem_model and self.gpu_mem is None:
            block_N = -(-N_frames // -(-N_frames // block_N))
        return block_N

    def block_gpu_mem(self, pix_cnt, block_N, fps, share=1, reference_model=False):
        """The ``gpu_mem`` (GB) under which ``estimate_block_N(pix_cnt, N,
        share, reference_model)`` gives ``block_N``-frame blocks (N >=
        block_N) of a video at ``fps``, when the device has that much free.
        The route is the metric's as it stands: set its heatmap, dumps and
        kernels first."""
        fl = len(get_temporal_filters(fps, self.sigma_tf, self.beta_tf, self.temp_filter)[0][0])
        a, b, c = self._block_mem_model(reference_model)
        return share * (a + pix_cnt * (fl - 1) * b + pix_cnt * (b + c) * (block_N + 0.5)) / 1e9

    def _ensure_pyramids(self, width, height):
        if self.lpyr is not None and self.lpyr.W == width and self.lpyr.H == height:
            return
        if self.contrast.startswith("weber"):
            self.lpyr = WeberContrastPyramid(width, height, self.pix_per_deg,
                                             contrast=self.contrast)
        elif self.contrast.startswith("log"):
            self.lpyr = LogContrastPyramid(width, height, self.pix_per_deg)
        else:
            raise RuntimeError(f"Unknown contrast {self.contrast}")
        if self.do_heatmap:
            self.heatmap_pyr = LaplacianPyramid(width, height, self.pix_per_deg)
        self._cache = {}

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.device)

    def _raw(self, vid_source, a: np.ndarray) -> torch.Tensor:
        """A raw block of ``vid_source`` on the device as (B, F, C, H, W)
        frames: uploaded as it is, or, for a packed source, unpacked to
        display-encoded float32 RGB, luminance-only broadcast to three
        channels."""
        x = self._upload(a)
        if not hasattr(vid_source, "unpack_raw_block"):
            return x
        rgb = vid_source.unpack_raw_block(x)  # (B, C, F, H, W)
        if rgb.shape[1] == 1:
            rgb = rgb.expand(-1, 3, -1, -1, -1)
        return rgb.transpose(1, 2).contiguous()

    @staticmethod
    def _get_symmetric_frame_index(frame_ind, frame_count):
        """Ping-pong mirror index for symmetric temporal padding."""
        is_even = (math.floor((abs(frame_ind) - 1) / (frame_count - 1)) % 2) == 0
        if is_even:
            return ((abs(frame_ind) - 1) % (frame_count - 1)) + 1
        return frame_ind % (frame_count - 1)

    def _temporal_filters(self, vid_source):
        """Set the temporal filters (``F``, ``filter_len``) for the source's
        frame rate; the block model reads ``filter_len``."""
        fps = vid_source.get_frames_per_second()
        self.F, _ = get_temporal_filters(fps, self.sigma_tf, self.beta_tf, self.temp_filter)
        self.filter_len = int(self.F[0].shape[0])

    @no_tf32()
    def predict_video_source(self, vid_source):
        """Score a video source; returns (Q_jod, stats)."""
        with spans.request("cvvdp.predict") as root:
            return self._predict_video_source(vid_source, root)

    def _predict_video_source(self, vid_source, root):
        h, w, N_frames = vid_source.get_video_size()
        batch_sz = vid_source.get_batch_size()
        if batch_sz > 1 and self.do_heatmap:
            raise vq_exception("Heatmaps not supported when batches are used")
        self._ensure_pyramids(w, h)
        is_image = N_frames == 1
        met_cs = self.met_colorspace()
        heatmap = None
        if self.do_heatmap:
            dmap_channels = 1 if self.heatmap == "raw" else 3
            heatmap = np.zeros((1, dmap_channels, N_frames, h, w), dtype=np.float16)
        if not is_image:
            self._temporal_filters(vid_source)

        dump = self.dump_channels
        if dump:
            dump.open(vid_source.get_frames_per_second())

        per_frame = not hasattr(vid_source, "get_raw_block")
        blocks = self._frame_blocks if per_frame else self._raw_blocks
        Q_blocks = []
        block_N = 1 if is_image else self.estimate_block_N(h * w * batch_sz, N_frames,
                                                           reference_model=per_frame)
        root.set(frames=N_frames, block_N=block_N)
        for ff, cur, R, temp_ch in blocks(vid_source, N_frames, block_N, batch_sz, met_cs):
            dumped = {} if dump else None
            Q, hm, context = self._process_block(R, temp_ch=temp_ch, is_image=is_image,
                                                 heatmap=self.do_heatmap, dump=dumped)
            if dump:
                self._dump_block(R, dumped, cur)
            del R, dumped
            self._check_finite(Q, ff)
            Q_blocks.append(Q[:, :, :cur])
            if heatmap is not None:
                heatmap[:, :, ff:ff + cur] = self._heatmap_frames(hm[:, :, :cur],
                                                                  context[:, :cur])

        fps = vid_source.get_frames_per_second()
        with spans.span("cvvdp.readback"):
            Q_per_ch = torch.cat(Q_blocks, dim=2) if len(Q_blocks) > 1 else Q_blocks[0]
            if self.temp_resample:
                # The frame axis resampled linearly to nominal_fps, as the JAX
                # package does (the reference metric's own resampling is dead
                # code that would resample the channel axis).
                t_end = N_frames / fps
                t_org = torch.as_tensor(linspace32(t_end, N_frames), device=Q_per_ch.device)
                N_res = math.ceil(t_end * self.nominal_fps)
                t_res = torch.as_tensor(linspace32(N_res / self.nominal_fps, N_res),
                                        device=Q_per_ch.device)
                Q_per_ch = interp1dim2(t_org, Q_per_ch.movedim(2, 1), t_res).movedim(1, 2)
                N_frames = N_res
                fps = self.nominal_fps
            Q_jod = self.do_pooling_and_jods(Q_per_ch)
            Q_host = Q_per_ch.cpu().numpy()
        stats = {
            "Q_per_ch": Q_host,
            "rho_band": self.lpyr.get_freqs(),
            "frames_per_second": fps,
            "width": w,
            "height": h,
            "N_frames": N_frames,
            "block_N_frames": block_N,
        }
        if heatmap is not None:
            stats["heatmap"] = heatmap
        if dump:
            dump.close()
        return Q_jod, stats

    def _dump_block(self, R, dumped, cur):
        """Hand one block's first ``cur`` frames to the dumps: R, the contrast
        bands and the D bands, each copied to the host once."""
        dump = self.dump_channels

        def host(x):
            return x[:, :, :cur].cpu().numpy()

        dump.dump_temp_ch(host(R))
        dump.dump_lpyr(self.lpyr, [host(b) for b in dumped["bands"]])
        dump.set_diff_bands([host(b) for b in dumped["D_bands"]])
        dump.dump_diff()

    def _raw_blocks(self, vid_source, N_frames, block_N, batch_sz, met_cs, slab=None):
        """(first frame, frames, R, temp_ch) of each block of a raw-block
        source, on the device: the one block producer of the single-device
        metrics and the mesh. Each block is read (the next one on a worker
        thread while this one is scored), uploaded (``_raw``) and ingested:
        the first block through the ingest kernel's first-block modes,
        ``ingest_replicate`` (frame 0 repeated) or, with symmetric padding,
        ``ingest_head`` (the mirror-indexed head frames, read and uploaded
        before the worker starts), and later blocks through ``ingest`` after the tails
        carried between blocks; their plain versions without
        ``enable_fused_kernels``. An image is converted and interleaved.

        ``slab`` (batch slice, row slice): the blocks are a rank's pairs and
        rows under a mesh (``parallel/sharding.py``), whose first block
        repeats frame 0 whatever ``temp_padding`` says, as the JAX
        package's sharded step does."""
        dm = vid_source.dm_photometry
        sides = ("test", "reference")

        def read(start, count):
            if slab is None:
                return [vid_source.get_raw_block(s, start, count) for s in sides]
            # A read-only (memory-mapped) block is copied before torch wraps it.
            return [np.require(vid_source.get_raw_block(s, start, count, batch=slab[0],
                                                        rows=slab[1]), requirements=["C", "W"])
                    for s in sides]

        if N_frames == 1:
            raws = [self._raw(vid_source, a) for a in read(0, 1)]
            with spans.span("cvvdp.block"):
                with spans.span("cvvdp.ingest"):
                    T, R = (ing.raw_to_met(dm, raw, met_cs).expand(batch_sz, -1, -1, -1, -1)
                            for raw in raws)
                    R = ing.interleave_tr(T, R)
                del raws
                # The consumer scores the block inside its span.
                yield 0, 1, R, 1
            return
        filt = np.stack([f[::-1] for f in self.F])
        use_k = self.enable_fused_kernels
        heads = None
        if self.temp_padding == "symmetric" and slab is None:
            idx = [self._get_symmetric_frame_index(fi, N_frames)
                   for fi in range(-self.filter_len + 1, 0)]
            heads = [self._raw(vid_source, vid_source.get_raw_frame_list(s, idx))
                     for s in sides]

        tails = None
        prefetch = None  # the future of this block's host arrays
        with ThreadPoolExecutor(max_workers=1) as pool:
            for ff in range(0, N_frames, block_N):
                if prefetch is not None:
                    with spans.span("cvvdp.prefetch_wait"):
                        host = prefetch.result()
                else:
                    # The source repeats its last frame to fill a trailing
                    # partial block; the padded frames' outputs are trimmed.
                    host = read(ff, block_N)
                nxt = ff + block_N
                prefetch = None
                if nxt < N_frames:
                    task = spans.carried(read)  # the read's parent: this request
                    # Starting the worker hands it the interpreter lock: while
                    # its read runs a copy that keeps the lock, this thread
                    # waits here.
                    with spans.span("cvvdp.prefetch_submit"):
                        prefetch = pool.submit(task, nxt, block_N)
                raws = [self._raw(vid_source, a) for a in host]
                del host
                with spans.span("cvvdp.block"):
                    with spans.span("cvvdp.ingest"):
                        if tails is not None:
                            fn = ing.ingest if use_k else ing.ingest_plain
                            R, *tails = fn(*tails, *raws, dm, filt, met_cs)
                        elif heads is None:
                            fn = ing.ingest_replicate if use_k else ing.ingest_first_plain
                            R, *tails = fn(*raws, dm, filt, met_cs)
                        elif use_k:
                            R, *tails = ing.ingest_head(*heads, *raws, dm, filt, met_cs)
                        else:
                            R, *tails = ing.ingest_first_plain(*raws, dm, filt, met_cs, *heads)
                        heads = None
                    del raws
                    # The consumer scores the block inside its span.
                    yield ff, min(block_N, N_frames - ff), R, 2
                    # Free the scored block before the next one is uploaded.
                    del R

    def _frame_blocks(self, vid_source, N_frames, block_N, batch_sz, met_cs):
        """(first frame, frames, R, temp_ch) of each block of a source read
        frame by frame in the metric colour space (the JAX package's generic
        route): sliding windows of fl-1 + block_N frames, padded as the
        temporal padding says, a partial last block with zero frames, then
        the temporal filter and the interleave in plain PyTorch."""
        def fetch(s, idx):
            get = vid_source.get_test_frame if s == 0 else vid_source.get_reference_frame
            I = get(idx, device=self.device, colorspace=met_cs)
            return I.expand(-1, 3, -1, -1, -1) if I.shape[1] == 1 else I

        if N_frames == 1:
            T, R = (fetch(s, 0).expand(batch_sz, -1, -1, -1, -1) for s in (0, 1))
            with spans.span("cvvdp.block"):
                with spans.span("cvvdp.ingest"):
                    R = ing.interleave_tr(T, R)
                del T
                yield 0, 1, R, 1
            return
        fl = self.filter_len
        filt = np.stack([f[::-1] for f in self.F])
        read_ahead = [[], []]
        tails = [None, None]
        for ff in range(0, N_frames, block_N):
            cur = min(block_N, N_frames - ff)
            news = []
            for s in (0, 1):
                frames = [read_ahead[s].pop(0) if read_ahead[s] else fetch(s, ff + fi)
                          for fi in range(cur)]
                if ff == 0:
                    if self.temp_padding == "replicate":
                        head = [frames[0]] * (fl - 1)
                    else:
                        # Read ahead where the first block is shorter than the filter.
                        read_ahead[s] = [fetch(s, cur + fi) for fi in range(max(fl - cur, 0))]
                        head = []
                        for fi in range(-fl + 1, 0):
                            pos = self._get_symmetric_frame_index(fi, N_frames)
                            head.append(frames[pos] if pos < cur else read_ahead[s][pos - cur])
                    tails[s] = torch.cat(head, dim=2)
                if cur < block_N:
                    frames += [torch.zeros_like(frames[0])] * (block_N - cur)
                news.append(torch.cat(frames, dim=2))
            with spans.span("cvvdp.block"):
                with spans.span("cvvdp.ingest"):
                    R, tails[0], tails[1] = ing.temporal_fir(tails, news, filt)
                del news
                yield ff, cur, R, 2
                del R

    def _check_finite(self, Q, ff):
        """With ``debug``, the JAX package's numeric check of each block."""
        if self.debug and not bool(torch.isfinite(Q).all()):
            raise RuntimeError(f"Non-finite Q_per_ch in block at frame {ff} "
                               "(masking produced NaN/Inf)")

    def _heatmap_frames(self, hm, context) -> np.ndarray:
        """One block's heatmap as the host's float16 frames (``_heatmap_map``).
        The copy waits for the device, so the span is the map's wall time."""
        with spans.span("cvvdp.heatmap") as sp:
            out = self._heatmap_map(hm, context).cpu().numpy()
            sp.set(bytes=out.nbytes)
            return out

    def _heatmap_map(self, hm, context) -> torch.Tensor:
        """One block's heatmap as float16 on the device: the raw map
        (1, 1, F, H, W), or the colour map (3, F, H, W) drawn against the
        block's context (test sustained achromatic channel)."""
        if self.heatmap == "raw":
            return hm.to(torch.float16)
        from ..viz import visualize_diff_map

        return visualize_diff_map(hm, context_image=context,
                                  colormap_type=self.heatmap).to(torch.float16)

    def _band_tables(self, all_ch):
        """(BandConsts, LUT rows (interior bands, C, nk) on the device),
        cached per channel count. BandConsts is None where the band kernel
        does not take the configuration (``MaskingParams.fusable``)."""
        key = ("bands", all_ch)
        if key not in self._cache:
            params = self._masking_params()
            luts = np.stack([
                np.stack([self.csf.logS_of_logL(float(rho), self.omega[0 if cc < 3 else 1],
                                                cc if cc < 3 else 0)
                          for cc in range(all_ch)])
                for rho in self.lpyr.get_freqs()[:-1]])
            x0, x1 = self.csf.lut_range()
            consts = (bm.BandConsts.make(params, all_ch, x0, x1,
                                         10.0 ** (self.sensitivity_correction / 20.0),
                                         self.contrast.endswith("ref"), self.beta,
                                         coding=self.contrast)
                      if params.fusable() else None)
            self._cache[key] = (consts, torch.as_tensor(luts, device=self.device))
        return self._cache[key]

    @no_tf32()
    def _process_block(self, R, temp_ch, is_image, heatmap=False, mesh=None, dump=None):
        """Pyramid -> CSF -> masking -> spatial pooling for one frame block.
        R: (B, 2 * all_ch, F, H, W) interleaved. Returns (Q_per_ch
        (B, all_ch, F, bands), heatmap block, context); with ``heatmap`` the
        heatmap block is 1 - JOD / 10 of the reconstructed distortion map,
        (B, 1, F, H, W), and the context is R[:, 0], else both are None.

        Interior bands take the JAX package's routes (its
        ``metrics/cvvdp.py:1224-1246``, ``:1487-1519``): with the band
        kernel's configuration, raw pairs for every contrast coding
        (``band_pooled``, one pass from each band's level and the next, the
        coding formed inside: the JAX raw-pair route for weber_g1 and
        weber_g1_ref, its contrast-band route for weber_g0_ref and log; with
        a heatmap its D mode ``band_pooled_d``, whose pooled sums give the
        Q columns, so the JOD is the pooled-only JOD); with any other
        configuration the generic chain, the CSF LUT then
        ``apply_masking_model``.

        ``dump``, a dict, takes the block's contrast bands (``"bands"``, as
        the non-raw decomposition gives them: interior bands at half gain)
        and its D bands (``"D_bands"``, D * channel weight / band gain); the
        interior bands then take the D route, as with a heatmap.

        ``mesh`` (``parallel/sharding.py``): R is this rank's pairs and rows;
        see ``_process_block_sharded``. Dumps take no mesh, as in the JAX
        package, whose sharded steps have no dump route."""
        if mesh is not None:
            if dump is not None:
                raise ValueError("channel dumps take no mesh")
            return self._process_block_sharded(R, temp_ch, is_image, mesh, heatmap)
        all_ch = 2 + temp_ch
        use_k = self.enable_fused_kernels
        n_bands = self.lpyr.get_band_count()
        params = self._masking_params()
        consts, luts = self._band_tables(all_ch)
        sens_corr = 10.0 ** (self.sensitivity_correction / 20.0)
        raw_pairs = consts is not None
        with spans.span("cvvdp.pyramid"):
            bands, L_bkg_pyr = self.lpyr.decompose(R, raw_pairs=raw_pairs, use_kernel=use_k)

        with spans.span("cvvdp.bands"):
            Q_cols = [None] * n_bands
            B, _, F = bands[-1].shape[:3]
            shapes = [(bands[bb][0] if raw_pairs else bands[bb]).shape[-2:]
                      for bb in range(n_bands - 1)]
            muls = [1.0 if bb == 0 else 2.0 for bb in range(n_bands - 1)]
            want_D = heatmap or dump is not None
            maps = _BandMaps(self, all_ch, is_image, n_bands, R.device) if want_D else None
            if dump is not None:
                # The raw pairs' contrast bands in plain torch: only the dumps
                # read them.
                dump["bands"] = [
                    pyr.interior_contrast(bands[bb][0],
                                          pyr.gausspyr_expand(bands[bb][1], shapes[bb]),
                                          self.contrast)[0] if raw_pairs else bands[bb]
                    for bb in range(n_bands - 1)] + [bands[-1]]
                dump["D_bands"] = [None] * n_bands

            def put_D(bb, D, sums=None):
                """Band bb's Q column, from the kernel's pooled sums where given,
                and its heatmap and dump bands."""
                Q_cols[bb] = (mk.lp_norm(D, self.beta, dim=(-2, -1), normalize=True, keepdim=False)
                              if sums is None else bm.pooled_norm(sums, *shapes[bb], self.beta))
                if heatmap:
                    maps.bands[bb] = maps.band(D, muls[bb])
                if dump is not None:
                    dump["D_bands"][bb] = D * maps.w_ch / muls[bb]

            if consts is None:
                x0, x1 = self.csf.lut_range()
                for bb in range(n_bands - 1):
                    band = LaplacianPyramid.get_band(bands, bb)
                    # (all_ch, B, 1, F, h, w) -> (B, all_ch, F, h, w)
                    S = CsfLut.apply(L_bkg_pyr[bb], luts[bb], x0, x1, use_k).movedim(0, 1)[:, :, 0]
                    put_D(bb, mk.apply_masking_model(band[:, 0::2], band[:, 1::2], S * sens_corr,
                                                     params, use_k))
            else:
                d_blurs = [params.blurs(int(h), int(w)) for h, w in shapes] if want_D else None
                for sel in bm.band_groups(shapes, B, all_ch, F, d_blurs, gn=True):
                    # One pass from gi and gn: the expand and the coding are
                    # inside the kernel.
                    args = ([bands[bb][0] for bb in sel], [bands[bb][1] for bb in sel],
                            luts[sel], [muls[bb] for bb in sel], consts)
                    if want_D:
                        fn = bp.band_pooled_d if use_k else bp.band_pooled_d_plain
                        Ds, sums = fn(*args)
                        for j, bb in enumerate(sel):
                            put_D(bb, Ds[j], sums[j])
                        del Ds
                        continue
                    sums = bp.band_pooled_sums(*args, use_k)
                    for j, bb in enumerate(sel):
                        Q_cols[bb] = bm.pooled_norm(sums[j], *shapes[bb], self.beta)

        with spans.span("cvvdp.baseband"):
            Q_cols[-1], D = self._baseband(bands[-1], L_bkg_pyr[-1], all_ch, sens_corr)
            Q = torch.stack(Q_cols, dim=-1)
        if dump is not None:
            dump["D_bands"][-1] = D * maps.w_ch
        if not heatmap:
            return Q, None, None
        del bands
        # A copy of the context, so that the caller can free the block's R
        # before drawing.
        return Q, maps.heatmap(D), R[:, 0].clone()

    def _baseband(self, base, logL, all_ch, sens_corr):
        """(Q column, D) of the baseband: the CSF LUT of its adaptation field."""
        rho_bb = 0.1  # baseband CSF frequency
        S = self.csf.sensitivity_multi_channel(
            [rho_bb] * all_ch, [self.omega[0 if cc < 3 else 1] for cc in range(all_ch)],
            logL, [cc if cc < 3 else 0 for cc in range(all_ch)],
            use_kernel=self.enable_fused_kernels)
        # (all_ch, B, 1, F, h, w) -> (B, all_ch, F, h, w); h = w = 1 for weber_g1
        S = S.movedim(0, 1)[:, :, 0] * sens_corr
        D = torch.abs(base[:, 0::2] - base[:, 1::2]) * S
        return mk.lp_norm(D, self.beta, dim=(-2, -1), normalize=True, keepdim=False), D

    def _process_block_sharded(self, R, temp_ch, is_image, mesh, heatmap=False):
        """(Q_per_ch (B, all_ch, F, bands), heatmap block, context) of one
        block under ``mesh``, each the same on every rank; R is this rank's
        (B / n_batch, 2 all_ch, F, H / n_space, W) slab. The JAX package's
        routing under a mesh (``metrics/cvvdp.py:1233-1245``, ``:1478-1515``):

        * with the band kernel's configuration (every contrast coding), the
          bands of row-sharded levels that ``band_shardable`` admits take
          its halo mode on their slabs of gi (``halo_rows``) and the rows of
          gn their expand reads (``halo_gn``), ``band_pooled_halo`` through
          ``BandPooledHalo``, or with a heatmap ``band_pooled_d_halo``; their
          pooled sums are summed over the space group before the norm over
          the band's global size. The other bands run whole
          (``Level.full``) on every rank and are not summed;
        * any other configuration (masking model, clamp, the mix off, a
          per-channel ``d_max``) gathers R's rows and runs the single-device
          block on every rank, the generic chain on whole levels, the math
          of the JAX package's GSPMD route;
        * the baseband is whole on every rank; Q is gathered over the batch
          group.

        With ``heatmap`` each band's D is pooled over the channels on the
        rows it has (a halo band's owned rows, then gathered over the space
        group), the maps are collapsed by the plain reconstruct, and the
        heatmap block and its context (R[:, 0]) are gathered over the batch
        group. Every collective is differentiable (``sharding.py``), so the
        same code is the sharded loss step's forward."""
        from ..parallel import sharding as sh

        all_ch = 2 + temp_ch
        consts, luts = self._band_tables(all_ch)
        if consts is None:
            self.sharded_route = {"chain": "generic", "levels": [], "halo_bands": [],
                                  "halo_gn_rows": []}
            out = self._process_block(sh.gather_rows(R, mesh), temp_ch, is_image, heatmap)
            return tuple(None if x is None else sh.gather_batch(x, mesh) for x in out)
        use_k = self.enable_fused_kernels
        params = self._masking_params()
        sens_corr = 10.0 ** (self.sensitivity_correction / 20.0)
        bands, L_bkg_pyr = self.lpyr.decompose(R, raw_pairs=True, use_kernel=use_k, mesh=mesh)
        n_bands = len(bands)
        B, F = R.shape[0], R.shape[2]
        shapes = self.lpyr.pyr_shape
        muls = [1.0 if bb == 0 else 2.0 for bb in range(n_bands - 1)]
        halo = [bb for bb in range(n_bands - 1)
                if bands[bb][0].sharded and sh.band_shardable(params, *shapes[bb], mesh)]
        whole = [bb for bb in range(n_bands - 1) if bb not in halo]
        # The route of the last block: the chain, the row-sharded levels, the
        # halo bands and, per halo band, the rows of gn handed to the kernel
        # (count, first).
        levels = [pair[0] for pair in bands[:-1]] + [bands[-2][1]]
        self.sharded_route = {"chain": "band",
                              "levels": [i for i, lv in enumerate(levels) if lv.sharded],
                              "halo_bands": halo, "halo_gn_rows": []}
        Q_cols = [None] * n_bands
        maps = _BandMaps(self, all_ch, is_image, n_bands, R.device) if heatmap else None
        sums = []
        slab_h = [shapes[bb][0] // mesh.n_space for bb in halo]
        for sel in bm.band_groups([(hv + 2 * bm.HALO_ROWS, shapes[bb][1])
                                   for bb, hv in zip(halo, slab_h)], B, all_ch, F,
                                  [True] * len(halo) if heatmap else None, gn=True):
            sel = [halo[i] for i in sel]
            xs = [sh.halo_rows(bands[bb][0].x, mesh) for bb in sel]
            ys, row0s = zip(*[sh.halo_gn(bands[bb][1], mesh) for bb in sel])
            slabs = [(mesh.s * (shapes[bb][0] // mesh.n_space), shapes[bb][0], row0)
                     for bb, row0 in zip(sel, row0s)]
            args = (xs, list(ys), luts[sel], [muls[bb] for bb in sel], consts, slabs)
            if heatmap:
                Ds, part = (bp.band_pooled_d_halo if use_k else bp.band_pooled_d_halo_plain)(*args)
                for j, bb in enumerate(sel):
                    # D holds the owned rows: their map is gathered.
                    maps.bands[bb] = sh.gather_rows(maps.band(Ds[j], muls[bb]), mesh)
                del Ds
            else:
                part = bp.band_pooled_halo_sums(*args, use_kernel=use_k)
            sums.append(part)
            self.sharded_route["halo_gn_rows"] += [(y.shape[-2], row0)
                                                   for y, row0 in zip(ys, row0s)]
            del xs, ys, args
        if halo:
            total = sh.sum_space(torch.cat(sums), mesh)
            for j, bb in enumerate(halo):
                Q_cols[bb] = bm.pooled_norm(total[j], *shapes[bb], self.beta)
        d_blurs = [params.blurs(*shapes[bb]) for bb in whole] if heatmap else None
        for sel in bm.band_groups([shapes[bb] for bb in whole], B, all_ch, F, d_blurs, gn=True):
            sel = [whole[i] for i in sel]
            args = ([bands[bb][0].full(mesh) for bb in sel],
                    [bands[bb][1].full(mesh) for bb in sel], luts[sel], [muls[bb] for bb in sel],
                    consts)
            if heatmap:
                Ds, out = (bp.band_pooled_d if use_k else bp.band_pooled_d_plain)(*args)
                for j, bb in enumerate(sel):
                    maps.bands[bb] = maps.band(Ds[j], muls[bb])
                del Ds
            else:
                out = bp.band_pooled_sums(*args, use_k)
            for j, bb in enumerate(sel):
                Q_cols[bb] = bm.pooled_norm(out[j], *shapes[bb], self.beta)
        Q_cols[-1], D = self._baseband(bands[-1], L_bkg_pyr[-1], all_ch, sens_corr)
        Q = sh.gather_batch(torch.stack(Q_cols, dim=-1), mesh)
        if not heatmap:
            return Q, None, None
        del bands
        return (Q, sh.gather_batch(maps.heatmap(D), mesh),
                sh.gather_batch(sh.gather_rows(R[:, 0].clone(), mesh), mesh))

    def do_pooling_and_jods(self, Q_per_ch):
        """Band/channel/frame pooling and the JOD mapping; Q_per_ch is
        (B, C, F, bands)."""
        no_channels, no_frames, no_bands = Q_per_ch.shape[1:]
        dev = Q_per_ch.device
        per_ch_w = torch.as_tensor(self.get_ch_weights(no_channels), device=dev).reshape(
            1, -1, 1, 1)
        per_sband_w = np.ones((1, no_channels, 1, no_bands), np.float32)
        per_sband_w[:, :, 0, -1] = self.baseband_weight[:no_channels]
        per_sband_w = torch.as_tensor(per_sband_w, device=dev)
        Q_sc = mk.lp_norm(Q_per_ch * per_ch_w * per_sband_w, self.beta_sch, dim=3,
                          normalize=False)
        is_image = no_frames == 1
        if self.block_channels is not None:
            keep = np.nonzero(self.block_channels[:no_channels])[0]
            Q_sc = Q_sc[:, torch.as_tensor(keep, device=dev)]
        Q_tc = mk.lp_norm(Q_sc, self.beta_tch, dim=1, normalize=False)
        if is_image:
            Q = Q_tc * self.image_int
        else:
            Q = mk.lp_norm(Q_tc, self.beta_t, dim=2, normalize=True)
        return self.met2jod(torch.squeeze(Q))

    def met2jod(self, Q):
        return mk.met2jod(Q, self.jod_a, self.jod_exp)

    # ------------------------------------------------------------------
    # Reporting

    def full_name(self):
        return "ColorVideoVDP"

    def short_name(self):
        return "cvvdp"

    def quality_unit(self):
        return "JOD"

    def get_info_string(self):
        if self.display_name.startswith("standard_"):
            standard_str = self.display_name
        else:
            standard_str = f"custom-display: {self.display_name}"
        L_black, L_refl = self.display_photometry.get_black_level()
        return (
            f'"{self.full_name()} v{self.version}, '
            f"{self.pix_per_deg:.4g} [pix/deg], "
            f"Lpeak={self.display_photometry.get_peak_luminance():.5g}, "
            f"Lblack={L_black:.4g}, Lrefl={L_refl:.4g} [cd/m^2], "
            f'({standard_str})"'
        )

    def write_features_to_json(self, stats, dest_fname):
        """Per-band feature export for calibration (reference:
        cvvdp_metric.py:1112-1127). The port's own ``block_N_frames`` is left
        out, so that the file is the JAX package's."""
        Q_per_ch = stats["Q_per_ch"]
        fmap = {}
        for key, value in stats.items():
            if key not in ("Q_per_ch", "heatmap", "block_N_frames"):
                fmap[key] = value.tolist() if isinstance(value, np.ndarray) else value
        for cc in range(Q_per_ch.shape[1]):
            for bb in range(Q_per_ch.shape[3]):
                fmap[f"t{cc}_b{bb}"] = Q_per_ch[:, cc, :, bb].tolist()
        with open(dest_fname, "w", encoding="utf-8") as f:
            json.dump(fmap, f, ensure_ascii=False, indent=4)

    def save_to_config(self, fname, comment):
        """Write the current (possibly re-calibrated) parameters back to JSON
        (reference: cvvdp_metric.py:1129-1154)."""
        from datetime import date

        assert fname.endswith(".json"), "Please provide a .json file"
        parameters = json2dict(self.parameters_file)
        remap = {"csf": "csf_version"}
        for key in parameters:
            attr = remap.get(key, key)
            if isinstance(parameters[key], (str, int)) or not hasattr(self, attr):
                continue
            val = getattr(self, attr)
            if isinstance(parameters[key], float):
                parameters[key] = float(np.asarray(val))
            elif isinstance(parameters[key], list):
                parameters[key] = [float(x) for x in np.asarray(val).flatten()]
        parameters["__comment"] = comment
        parameters["calibration_date"] = date.today().strftime("%d/%m/%Y")
        with open(fname, "w") as f:
            json.dump(parameters, f, indent=4)

    def export_distogram(self, stats, fname, jod_max=None, base_size=6):
        """Plot ``stats["Q_per_ch"]`` per channel, band and frame to ``fname``
        (needs matplotlib)."""
        from ..viz import export_distogram

        export_distogram(self, stats, fname, jod_max=jod_max, base_size=base_size)


register_metric(cvvdp)
