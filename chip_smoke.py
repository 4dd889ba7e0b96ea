"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it builds the kernels from ``csrc/`` itself.

Phase 0  card, power limit, torch and CUDA versions; constructing a metric
         must leave the TF32 flags as they were, and inside a metric call
         (``_process_block``) both must be off.
Phase 1  build the kernel library.
Phase 2  every kernel against its plain PyTorch version on the card, at the
         shapes the 4K main path gives it (the first block of the 4K clip),
         on seeded random frames, and the loss path's CSF LUT, its backward,
         the blur and its adjoint mode at the shapes of phase 5: the worst
         relative error of any channel against the stated tolerance, kernel
         and plain times (CUDA events around one call, median of 5). The
         LUT (bit for bit) also on the ML trunk's 4K band-0 field (C = 4)
         and the baseband; the blur (bit for bit) and its adjoint (bit for
         bit ``blur_adjoint_plain``, within 1e-5 of autograd of
         ``blur_plain``) also at (3, 135, 241), the ML trunk's 4K band 0
         (1, 4, 8, 2160, 3840) and at 33 taps, each beside a depthwise
         n x n reflect convolution (the library yardstick). These rows add
         the device time (``tools/kernel_times.py`` ``device_ms``: the CUDA
         kernels' time under ``torch.profiler``, the wrapper's host work
         left out) as ``device_ms`` beside ``ms``, which is the call time in
         every row. The ingest kernel also on uint16 and
         float16 frames, its code-value table route against the same frames
         as float32 (v / 255, v / 65535 correctly rounded, float16 widened)
         through the per-sample path, bit for bit; on channel-last uint16
         raws at the 4K clip cells' 23-frame block, bit for bit the planar
         launch and against plain, device time in turns with planar. The
         reduce at every
         level of the 4K pyramid, each from the kernel's previous level, bit
         for bit, timed beside its bound. The one-pass pooled band
         kernel (``band_pooled``)
         at 4K band 0 and at the launch that stacks the narrow bands,
         against its plain version, timed.
Phase 3  the 4K HDR clip (3840x2160, 32 frames, 30 fps, seed 7,
         standard_hdr_pq) through ``cvvdp.predict`` with the kernels, then
         with ``enable_fused_kernels = False``. Every kernel must have
         launched (the ingest kernel's replicate mode for the first block,
         tail mode for any later one; ``band_pooled`` for the raw bands),
         the two JODs must agree within 1e-3, the JOD must be
         within 0.01 of 7.8784, the value the reference metric gives, and
         within 1e-4 of 7.877874, the port's JOD before the one-pass band
         kernel. The clip again with the first block's padding formed in
         plain PyTorch (frame 0 converted by ``raw_to_met``, then tail mode):
         JOD and ``Q_per_ch`` within 1e-5 of the replicate mode's. Then the
         clip as FHWC with the kernels: blocks uploaded
         channel-last, the HWCF run's launches, its JOD and ``Q_per_ch``
         bit for bit. Then the host relayout of the input arrays and the block
         loop are timed apart, and the warm block loop's device time is
         split per kernel (``torch.profiler``), and one warm block's stages
         (ingest, decomposition, band kernel launches, baseband and pooling)
         with CUDA events.
Phase 4  a 1920x1080 sRGB image pair on standard_fhd (the image step, C = 3).
Phase 5  a training step at full width: ``get_loss_fn(1080, 1920)`` on
         standard_fhd with 4 seeded sRGB pairs (seed 11). First the reduce
         and band masking kernels against their plain versions on every
         pyramid level and band launch of that batch. Loss and gradient
         with the kernels, then with ``enable_fused_kernels = False``; every
         kernel of the loss path (reduce, band masking, CSF LUT forward and
         backward, blur, and the blur's adjoint as often as the blur) must
         have launched; then three Adam steps on a leaf copy of the test
         batch must lower the loss. Forward+backward ms per step (median of
         5) both ways, and the peak memory; with the kernels, the device
         time of ``Blur.backward`` within a step (CUDA events around each
         call) and the step's device time by kernel (``torch.profiler``).
Phase 6  the heatmap. First the one-pass kernel's D mode
         (``band_pooled_d``, the heatmap's route) against its plain version
         at the shapes of the runs below: 4K band 0 at the block length, the
         launch that takes the smallest 4K bands together (C = 4), and band 0,
         the 6-row band and all bands of a 1280x720 image (C = 3; the 6-row
         band takes no masking blur), with sums bit for bit those of
         ``band_pooled``, timed. Then
         ``predict`` with heatmap="raw" and "supra-threshold" on 12 frames of
         the phase-3 content (3840x2160, standard_hdr_pq; 32 frames cut to 12
         to fit the time limit) with ``gpu_mem`` set for 8-frame blocks, so
         that the clip runs as one full and one trailing partial block, and
         with heatmap="threshold" on the 1280x720 image (standard_4k). Each
         with the kernels, then plain: equal block lengths, heatmaps within
         1.1e-3 (one float16 quantum and a rounding), JODs within 1e-3, and
         the 4K JOD with a heatmap within 1e-4 of the pooled-only JOD;
         ``band_pooled_d`` must have launched.
Phase 7  the non-default configurations, each a copy of the default
         cvvdp_parameters.json with one or two keys changed, written to a
         temporary directory and passed as ``config_paths``. First the
         log-LMS mode of the ingest kernel at 8 frames of 4K. Then the
         one-pass kernel's contrast-band codings (``band_pooled`` /
         ``band_pooled_d`` with weber_g0_ref and with log, from each band's
         level and the next) against their plain versions at 4K band 0
         (1, 8, 8, 2160, 3840) and the smallest-bands launch, timed at band
         0 (D with log, and over the 720p log heatmap's bands); the
         blur kernel at the texture models' 33 taps on (3, 1080, 1920).
         Then ``predict`` on 12 frames of the phase-3 content (BFCHW,
         8-frame blocks) with contrast weber_g0_ref and with log, kernels
         then plain (JODs within 1e-3; ingest, reduce, ``band_pooled`` and
         the CSF LUT must have launched; wall time and peak memory); a
         log-contrast "raw" heatmap of the 720p image of phase 6
         (``band_pooled_d`` with log); a FHD image with
         mult-transducer-texture (the generic chain: CSF LUT and 33-tap blur
         kernels); and a ``get_loss_fn(1080, 1920)`` step of 2 pairs with
         weber_g0_ref: loss within 1e-4, gradient within 1e-4 of max|g|.

Phase 8  the ColorVideoVDP-ML metrics. First the ingest kernel's first-block
         modes, "replicate" and "head", against their plain version
         (``ingest_first_plain``) and against tail mode fed their padding
         converted in plain PyTorch, at (1, 8, 3, 2160, 3840) uint8 on
         standard_hdr_pq.
         Then ``predict`` with ``cvvdp_ml_saliency`` and
         ``cvvdp_ml_transformer`` (dim 256, depth 4, 8 heads) on the phase-6
         12-frame 4K content (BFCHW, ``gpu_mem`` for 8-frame blocks: a first
         block and a tail block), with replicate and with symmetric padding,
         weights from a seeded npz in the published layout
         (``tools/cvvdp_ml_manifest.json``) written to a temporary directory
         and found through ``config_paths``; kernels, then plain: JODs within
         1e-3; the first-block mode, tail ingest, reduce, CSF LUT and blur
         must have launched. Before them, a 1920x1080 image through
         ``cvvdp_ml_transformer`` on standard_fhd. Each run prints its wall
         time, peak memory and the split between trunk, feature pooling and
         head.

Phase 9  the one-pass kernel on one band: ``band_pooled`` and
         ``band_pooled_d`` against their plain versions at 4K band 0
         (1, 8, 8, 2160, 3840) and at an off-grid 1081x1921 band, the D
         mode's sums bit for bit the pooled mode's, timed. Then a B = 1
         ``get_loss_fn(2160, 3840)`` step on standard_4k: loss within 1e-4
         and gradient within 1e-4 of max|g| against plain, ``band_pooled``
         launched once a band group in the forward and once in the
         checkpointed block's recompute.
Phase 10 the interleave micro-benchmark
         (``colorvideovdp_tpu_torch/tools/interleave_bench.py``) at its shape
         (48, 2160, 3840): interleave, concat and de-interleave bit for bit
         against their plain versions, then timed against their plain
         versions, the PyTorch calls that compute them, the copy floor and
         the bound.

Phase 11 multi-device scoring (``colorvideovdp_tpu_torch/parallel``). First
         the reduce kernel's slab mode (``pyramid_reduce_slab``, bit for bit)
         and the one-pass kernel's halo mode (``band_pooled_halo``, from gi
         slabs and the rows of gn their expand reads; pooled sums within
         1e-4 relative of its plain version) at every
         launch shape the sharded run gives them, rank 0's and rank 1's:
         16-frame blocks of 4K on a (1, 2) mesh, the slab reduce at levels
         0-2 (level 0 (128, 1096, 3840)) and the halo mode at bands 0-3 as
         ``band_groups`` packs them; timed at level 0 and the first halo
         launch, with their bounds and each halo exchange's bytes; each launch's two ranks'
         halo sums against the whole bands'. Then the phase-3 clip (BFCHW,
         so no host relayout) through the sharded ``predict_video_source``
         (``parallel/sharding.py``, the metric's block producer on each
         rank's slab) on a (1, 2) mesh
         via ``run_ranks``: NCCL
         with one rank per card where there are two or more cards, else two
         gloo ranks sharing card 0, ``gpu_mem`` set for the same 16-frame
         blocks (each rank's must be 16 frames). The JOD must be within 0.01
         of 7.8784 and within 1e-4 of phase 3's, on every rank, and both new
         modes, ingest (replicate and tail), reduce, the one-pass band
         kernel and the CSF LUT must have launched on every rank. Each
         rank's set-up (groups,
         metric, kernel library, one collective per group) is timed apart
         from its block loop, and each block is timed. Between the two,
         the halo mode in the weber_g0_ref and log codings and its D mode
         (``band_pooled_d_halo``, all three codings) at the first halo
         launch of an 8-frame 4K block, both ranks' slabs: sums within 1e-3
         of the plain version, D within 1e-5, D's owned rows bit for bit the
         whole bands' ``band_pooled_d`` and its sums the pooled mode's; the
         D mode and the log coding timed. Last, one more ``run_ranks`` spawn
         (``run_jobs``) on the same mesh, each part against single-device
         scoring on the card, each with its launches, block-loop or step
         time and each rank's peak memory: weber_g0_ref and log on the first
         8 frames of the phase-3 clip (JOD within 1e-4; the halo mode and
         the slab reduce on every rank); a "raw" heatmap of a 1280x720
         image on standard_4k (within 1.1e-3, ``band_pooled_d_halo`` on every
         rank); the generic chain (mult-transducer-texture) on a 1920x1080
         image on standard_fhd (JOD within 1e-4; the CSF LUT and blur
         kernels); a B = 2 FHD ``shard_loss_fn`` step on standard_fhd (loss
         within 1e-4, the gathered gradient within 1e-3 of max|g|; the halo
         mode, the slab reduce, the LUT's backward and the blur's adjoint on
         every rank).
Phase 12 file sources: the first 12 frames of the phase-3 clip as a
         10-bit 4:2:0 BT.2020 limited-range .yuv pair (2x2 chroma means,
         about 300 MB a file in a temporary directory, removed at the end)
         through ``video_source_file`` and ``predict_video_source``, with
         the kernels and plain (JODs within 1e-3; ingest, the reduce,
         ``band_pooled`` and the CSF LUT launched); one
         block's host read, upload and unpack on the card timed; the
         array route fed the port's own unpacked float32 frames within
         1e-4 of the file route; a FHD crop (8 frames at 24 fps): 4 frames
         through the per-frame route (``get_raw_block`` hidden; no ingest)
         within 1e-4 of the block route, and ``temp_resample=True``
         kernels against plain within 1e-3; PSNR-RGB, PU21-PSNR-Y,
         PU21-PSNR-RGB2020 and SSIM on the 4K pair on the card, timed,
         and on 2 frames against the CPU (1e-4 dB, SSIM 1e-5).
Phase 13 the file-driven entry points on phase 12's files (phase 0 prints
         which of cv2, imageio, PIL and matplotlib import): the CLI
         in-process on the 4K pair (cvvdp, PU21-PSNR-Y, SSIM, --result,
         --features) with the kernels and plain (``cvvdp`` registered with
         its kernels off), its CSV within 1e-4 of the API's JOD
         (``video_source_file`` + ``predict_video_source``, symmetric
         padding as the CLI's) and of phase 12's aux metrics (1e-4 dB,
         SSIM 1e-5), kernels against plain within 1e-3, the features file
         with the API's keys; ``python -m colorvideovdp_tpu_torch.cli -q``
         in a process of its own, timed from its start, printing the same
         value; a supra-threshold heatmap through the CLI in one block,
         its file byte for byte what ``np2vid`` writes of the API's
         heatmap (scoring and writing timed apart); the three channel
         dumps of the FHD pair, kernels against plain within 1 code value,
         the JOD within 1e-4 of the pooled-only JOD; the HDR (.y4m) and
         EXR previews of 2 FHD frames read back; the clip-list runner's
         two workers, a resume and a merge on the 4K pair, the FHD pair
         and a missing file, whose row alone reads "error". Without
         matplotlib the distogram is left to the CPU tests.
Phase 14 calibration (``colorvideovdp_tpu_torch.calibration``) on a seeded
         rated dataset in a temporary directory: 3 contents x 3 noise levels
         of FHD 10-bit 4:2:0 BT.2020 PQ .yuv pairs (8 frames, about 50 MB a
         file) on standard_hdr_pq and one sRGB PNG pair per content on
         standard_fhd, the CSV's header naming the per-row display, the
         content split, 67 % train and seed 0. Extraction worker 1/2
         in-process (its launches are the kernels line's ``calib`` path:
         ingest, the reduce, ``band_pooled`` and the CSF LUT), worker 2/2
         as ``python -m``, then ``--resume`` (no file rewritten, no
         launch); the files are the CSV's rows in the split of numpy's
         seeded permutation. Every row's features bit for bit the API's
         ``Q_per_ch`` for the pair; one video and one image row plain,
         their JODs within 1e-3 of the kernels'. The refit (30 epochs,
         batch 2, ``--save best-rmse``) on the card and on the CPU: every
         fitted float within 1e-5, no kernel launched; a pair scored with
         the fitted config within 1e-4 JOD of the trainer's prediction from
         its features. Both ML families' seeded weights through a
         Lightning-style checkpoint, the port's converter and
         ``--validate``: the converted npz scores a FHD image pair bit for
         bit as the seeded metric. Extraction seconds a pair, one pair's
         host read, the refit's ms an epoch on each device, the phase's
         wall time.

Every kernel's row also carries its bound: the least time the card could
take for the same work, the larger of the bytes it must move (each input
read once, each output written once) over the HBM rate and its float32
operations counted as instructions (the kernels issue no fused
multiply-add; a powf as the 25 instructions of its SASS) over 33.5 T
instructions a second, half the non-tensor float32 peak of 67 TFLOP/s,
which counts an FMA as two; both from the published H100 SXM figures at
700 W.

Any failure raises (non-zero exit). The last line of standard output is a
JSON object naming the device; the line before it is the card's name and
power limit, and the one before that lists the kernels.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from colorvideovdp_tpu_torch.tools.clips import FrameByFrame
from colorvideovdp_tpu_torch.tools.kernel_times import blur_backward_split, device_ms, timing_row
from colorvideovdp_tpu_torch.tools.kernel_times import call_ms as time_ms

CLIP_JOD = 7.8784  # the reference metric's JOD for the 4K HDR clip
PORT_JOD = 7.877874  # the port's JOD for it before the one-pass band kernel
PORT_JOD_TOL = 1e-4
# The block length of the benchmark's 4K clip cells (32-frame uint16 clips,
# one block on an 80 GB card): the shape of phase 2's channel-last ingest
# check.
FHWC_BLK = 32
# The pinned block of phase 3's split loop: the clip's block under the
# reference metric's memory model on an 80 GB card, against the one block
# the pooled route's model gives it.
SPLIT_BLK = 23
TOL = {"ingest": 1e-5, "pyramid_reduce": 1e-6, "band_pooled": 1e-4,
       "csf_lut": 1e-5, "band_pooled_d": 1e-5, "blur_adjoint": 1e-5,
       "csf_lut_bwd": 1e-5, "blur": 1e-5,
       "ingest_replicate": 1e-5, "ingest_head": 1e-5,
       "interleave": 0.0, "concat": 0.0, "deinterleave": 0.0,
       "pyramid_reduce_slab": 0.0, "band_pooled_halo": 1e-4,
       "band_pooled_d_halo": 1e-5}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# Float32 instructions a second outside the tensor cores: the data sheet's 67
# TFLOP/s counts a fused multiply-add as two operations, and the kernels issue
# none (each multiply and add is rounded apart), so every operation counted
# below is one instruction at half that rate.
FP32_INSTR_PER_S = 33.5e12
# powf(10, v): the instructions of its inlined body in the SASS of
# csrc/csf_lut.cu (`cuobjdump -sass`, tools/kernel_times.py --sass; PERF.md).
POWF_INSTR = 25
# Training step bounds (phase 5): kernels against plain on the card.
LOSS_TOL, GRAD_TOL = 1e-4, 1e-4
# Heatmap bounds (phase 6): float16 heatmaps kernels against plain, and the
# JOD with a heatmap against the pooled-only JOD.
HEATMAP_TOL, HEATMAP_JOD_TOL = 1.1e-3, 1e-4
# ML metrics (phase 8): kernels against plain.
ML_JOD_TOL = 1e-3
# Multi-device scoring (phase 11): JOD against single-device scoring.
SHARD_JOD_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def clip_content(H, W, N, rng):
    """Synthetic HDR content (H, W, 3, N) uint8: a gradient plus noise."""
    from colorvideovdp_tpu_torch.tools.clips import hdr_clip

    return hdr_clip(H, W, N, rng)


def rel_err_per(a, b, dim):
    """The worst relative error over the slices along ``dim`` (channels),
    each held to its own scale so that a small channel cannot hide."""
    a, b = a.movedim(dim, 0).flatten(1), b.movedim(dim, 0).flatten(1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1e-30)).max())


def max_abs(a, b):
    return float((a - b).abs().max())


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time for the work, its float32
    operations counted as instructions."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_INSTR_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def blur_instr(n_taps):
    """Instructions an element of the separable blur (or its adjoint): each
    pass n_taps multiplies and n_taps - 1 adds."""
    return 2 * (2 * n_taps - 1)


def lut_instr(C, backward=False):
    """Instructions an element of the CSF LUT: the index (7: subtract, scale,
    clamp, floor, fraction; backward 10 with the gradient's range test) and
    per channel the lerp (4) and powf; backward also the slope and the
    four-product term (7)."""
    return (10 + C * (4 + POWF_INSTR + 7)) if backward else (7 + C * (4 + POWF_INSTR))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def tuple_str(shape):
    return str(tuple(shape)).replace(" ", "")


def check(name, err, tol):
    log(f"  {name}: max error {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


# The kernels the heatmap path launches (phase 6).
HEAT_PATH = ("ingest", "pyramid_reduce", "csf_lut", "band_pooled_d")


def phase_heatmap(m, fps, rows, record, counters, gen):
    """Phase 6; returns the kernels' launch counts of the heatmap run."""
    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
    from colorvideovdp_tpu_torch.ops.kernels import ingest, masking_fused
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
    from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

    dev = torch.device("cuda")
    H, W, N, blk = 2160, 3840, 12, 8
    Hi, Wi = 720, 1280
    t_phase = time.time()
    # gpu_mem for 8-frame blocks on the heatmap's route (estimate_block_N with
    # the reference metric's model, a = 1.6e9, b = 16, c = 320 bytes per
    # pixel); the pooled-only run below takes its own blocks.
    pix = H * W
    probe = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True, heatmap="raw")
    gpu_mem = probe.gpu_mem = probe.block_gpu_mem(pix, blk, fps)
    probe.filter_len = m.filter_len
    if probe.estimate_block_N(pix, N) != blk:
        raise AssertionError(f"gpu_mem {gpu_mem} does not give {blk}-frame blocks")

    # The D mode against its plain version, with sums bit for bit those of
    # band_pooled (these launches are not counted).
    def hold_pooled_d(a, note):
        """(rel. error, abs. error) of band_pooled_d against its plain
        version, after the bit-for-bit check against the pooled mode."""
        Ds, sums = bp.band_pooled_d(*a)
        check(f"band_pooled_d {note} sums vs band_pooled", max_abs(sums, bp.band_pooled(*a)),
              0.0)
        D_p, _ = bp.band_pooled_d_plain(*a)
        err = max(rel_err_per(x, y, 1) for x, y in zip(Ds, D_p))
        check(f"band_pooled_d {note} vs plain", err, TOL["band_pooled_d"])
        return err, max(max_abs(x, y) for x, y in zip(Ds, D_p))

    def pooled_d_bound(a, Ds):
        # Bytes: gi's 2C planes and gn's 2C quarter planes read once, the
        # tables, D and the sums written. Operations: ~115 per pixel and
        # channel, as band_pooled's (phase 2).
        n_pix = sum(gi.numel() for gi in a[0]) // 2
        return bound(nbytes(*a[0], *a[1], a[2], *Ds) + 4 * n_pix // 1024, 115 * n_pix)

    dm = m.display_photometry
    F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
    filt = np.stack([f[::-1] for f in F_taps])
    raws = [torch.randint(0, 256, (1, blk, 3, H, W), dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(2)]
    R = ingest.ingest_replicate(raws[0], raws[1], dm, filt)[0]
    del raws
    m._ensure_pyramids(W, H)
    consts, luts = m._band_tables(4)
    gn0 = prd.pyramid_reduce(R)
    a0 = ([R], [gn0], luts[0:1], [1.0], consts)
    errs_pd = [hold_pooled_d(a0, f"4K band 0 {tuple(R.shape)}")]
    k_pd = time_ms(lambda: bp.band_pooled_d(*a0))
    p_pd = time_ms(lambda: bp.band_pooled_d_plain(*a0))
    b_pd = pooled_d_bound(a0, bp.band_pooled_d(*a0)[0])
    log(f"  band_pooled_d 4K band 0: kernel {k_pd:.3f} ms")
    del a0, gn0
    torch.cuda.empty_cache()
    bands, _ = m.lpyr.decompose(R, raw_pairs=True, use_kernel=False)
    shapes = [b[0].shape[-2:] for b in bands[:-1]]
    blurs = [consts.params.blurs(int(h), int(w)) for h, w in shapes]
    groups_pd = masking_fused.band_groups(shapes, 1, 4, blk, blurs, gn=True)
    log(f"phase 6: band_pooled_d launches per 4K block: {groups_pd}")
    sel = groups_pd[-1]
    a_st = ([bands[bb][0] for bb in sel], [bands[bb][1] for bb in sel],
            luts[sel[0]:sel[-1] + 1].contiguous(), [1.0 if bb == 0 else 2.0 for bb in sel],
            consts)
    note = f"4K bands {sel} {[tuple(g.shape[-2:]) for g in a_st[0]]}"
    errs_pd.append(hold_pooled_d(a_st, note))
    k_st = time_ms(lambda: bp.band_pooled_d(*a_st))
    b_st = pooled_d_bound(a_st, bp.band_pooled_d(*a_st)[0])
    log(f"  band_pooled_d 4K stacked launch: kernel {k_st:.3f} ms, bound {b_st[0]:.4f} ms "
        f"({b_st[1]}, {100 * b_st[0] / k_st:.1f}% of it)")
    del R, bands, a_st

    # C = 3: a seeded 1280x720 image pair on standard_4k, as the image step forms it.
    rng = np.random.RandomState(17)
    I_ref = (rng.rand(Hi, Wi, 3) * 255).astype(np.uint8)
    I_test = np.clip(I_ref.astype(np.int16) + (rng.randn(Hi, Wi, 3) * 6).astype(np.int16),
                     0, 255).astype(np.uint8)
    mi = cvt.cvvdp(display_name="standard_4k", device="cuda", quiet=True)
    mi._ensure_pyramids(Wi, Hi)
    dmi = mi.display_photometry
    Ri = ingest.interleave_tr(
        *(ingest.raw_to_met(dmi, mi._upload(np.ascontiguousarray(a.transpose(2, 0, 1))
                                            [None, None])) for a in (I_test, I_ref)))
    bands_i, _ = mi.lpyr.decompose(Ri, raw_pairs=True, use_kernel=False)
    consts_i, luts_i = mi._band_tables(3)
    shapes_i = [b[0].shape[-2:] for b in bands_i[:-1]]
    noblur = [bb for bb, (h, w) in enumerate(shapes_i)
              if not consts_i.params.blurs(int(h), int(w))]
    if not noblur:
        raise AssertionError(f"no band without the blur in {shapes_i}")

    def pooled_d_args(sel):
        return ([bands_i[bb][0] for bb in sel], [bands_i[bb][1] for bb in sel],
                luts_i[sel[0]:sel[-1] + 1].contiguous(), [1.0 if bb == 0 else 2.0 for bb in sel],
                consts_i)

    # band_pooled_d on the 720p bands: band 0, the band without the blur
    # alone, and every band in one launch (both kinds).
    all_i = list(range(len(shapes_i)))
    for sel, note in (([0], "720p band 0"), ([noblur[0]], f"720p band {noblur[0]}"),
                      (all_i, f"720p bands {all_i}")):
        a = pooled_d_args(sel)
        errs_pd.append(hold_pooled_d(a, f"{note} {[tuple(g.shape) for g in a[0]]}"))
        if sel == [noblur[0]]:
            b_n = pooled_d_bound(a, bp.band_pooled_d(*a)[0])
            log(f"  band_pooled_d {note}: kernel {time_ms(lambda: bp.band_pooled_d(*a)):.3f} "
                f"ms, bound {b_n[0]:.6f} ms ({b_n[1]}), plain "
                f"{time_ms(lambda: bp.band_pooled_d_plain(*a)):.3f} ms")
    record("band_pooled_d", max(e for e, _ in errs_pd), errs_pd[0][1], k_pd, p_pd, b_pd)
    del Ri, bands_i, a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The heatmap path. The clip goes in as (1, F, 3, H, W) "BFCHW", the
    # layout the source keeps its blocks in, so no host relayout is timed.
    t0 = time.time()
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    V_test, V_ref = (np.ascontiguousarray(v.transpose(3, 2, 0, 1)[None]) for v in (V_test, V_ref))
    log(f"phase 6: clip content made in {time.time() - t0:.1f} s")
    runs = [("raw", "standard_hdr_pq", V_test, V_ref, dict(dim_order="BFCHW",
                                                          frames_per_second=fps)),
            ("supra-threshold", "standard_hdr_pq", V_test, V_ref,
             dict(dim_order="BFCHW", frames_per_second=fps)),
            ("threshold", "standard_4k", I_test, I_ref, dict(dim_order="HWC"))]
    out = {}
    heat_launches = None
    for fused in (True, False):
        for fn in counters.values():
            fn.launches = 0
        for hm_type, disp, t_in, r_in, kw in runs:
            mv = cvt.cvvdp(display_name=disp, device="cuda", quiet=True, heatmap=hm_type,
                           gpu_mem=gpu_mem)
            mv.enable_fused_kernels = fused
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            Q, st = mv.predict(t_in, r_in, **kw)
            jod = float(Q)
            torch.cuda.synchronize()
            dt = time.time() - t0
            hm = st["heatmap"]
            if hm.dtype != np.float16 or not np.isfinite(hm).all() or hm.min() < 0:
                raise AssertionError(f"heatmap {hm_type}: not finite non-negative float16")
            out[(fused, hm_type)] = (jod, hm, st["block_N_frames"])
            log(f"phase 6: {'kernels' if fused else 'plain  '} heatmap {hm_type} "
                f"{tuple(hm.shape)}: JOD {jod:.6f}, blk {st['block_N_frames']}, {dt:.3f} s, "
                f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if fused:
            heat_launches = {k: fn.launches for k, fn in counters.items()}
            log(f"phase 6: launches {heat_launches}")
    for k in HEAT_PATH:
        if heat_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the heatmap path")
    for hm_type, *_ in runs:
        (jk, hk, bk), (jp, hp, bp) = out[(True, hm_type)], out[(False, hm_type)]
        d_hm = float(np.abs(hk.astype(np.float32) - hp.astype(np.float32)).max())
        log(f"phase 6: heatmap {hm_type}: blk kernels {bk} plain {bp}, max |kernels - plain| "
            f"{d_hm:.3e} (tolerance {HEATMAP_TOL:.1e}), |JOD kernels - plain| {abs(jk - jp):.2e}")
        if bk != bp:
            raise AssertionError(f"heatmap {hm_type}: block lengths {bk} and {bp} differ")
        if not (d_hm <= HEATMAP_TOL and abs(jk - jp) <= 1e-3):
            raise AssertionError(f"heatmap {hm_type}: kernels disagree with plain")
    if out[(True, "raw")][2] != blk:
        raise AssertionError(f"4K blocks of {out[(True, 'raw')][2]} frames, not {blk}")
    mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True, gpu_mem=gpu_mem)
    torch.cuda.synchronize()
    t0 = time.time()
    jod_pooled = float(mv.predict(V_test, V_ref, dim_order="BFCHW", frames_per_second=fps)[0])
    torch.cuda.synchronize()
    dt = time.time() - t0
    d_jod = max(abs(out[(True, t)][0] - jod_pooled) for t in ("raw", "supra-threshold"))
    log(f"phase 6: 4K JOD pooled-only {jod_pooled:.6f} ({dt:.3f} s with the kernels), with a "
        f"heatmap {out[(True, 'raw')][0]:.6f}: |difference| {d_jod:.2e} (tolerance "
        f"{HEATMAP_JOD_TOL:.0e})")
    if not d_jod <= HEATMAP_JOD_TOL:
        raise AssertionError("the JOD with a heatmap differs from the pooled-only JOD")
    log(f"phase 6: {time.time() - t_phase:.1f} s")
    return heat_launches


def phase_configs(m, fps, rows, record, counters, gen):
    """Phase 7; returns the kernels' launch counts per path."""
    import shutil
    import tempfile

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d
    from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
    from colorvideovdp_tpu_torch.ops.kernels import blur as blr
    from colorvideovdp_tpu_torch.ops.kernels import ingest, masking_fused
    from colorvideovdp_tpu_torch.ops.kernels.pyramid_reduce import pyramid_reduce as prd_reduce
    from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters
    from colorvideovdp_tpu_torch.utils.config import write_parameters

    dev = torch.device("cuda")
    H, W, N, blk = 2160, 3840, 12, 8
    t_phase = time.time()
    tmp = tempfile.mkdtemp(prefix="cvvdp_configs_")
    try:
        cfg = {name: write_parameters(f"{tmp}/{name}", **over) for name, over in (
            ("weber_g0_ref", dict(contrast="weber_g0_ref")), ("log", dict(contrast="log")),
            ("texture", dict(masking_model="mult-transducer-texture")))}
        pix = H * W
        launches = {}

        # The log-LMS mode of the ingest kernel, then the contrast-band
        # codings of the one-pass kernel at the 4K shapes (these launches are
        # not counted).
        mg = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                       config_paths=cfg["weber_g0_ref"])
        dm = mg.display_photometry
        F_taps, _ = get_temporal_filters(fps, mg.sigma_tf, mg.beta_tf, mg.temp_filter)
        filt = np.stack([f[::-1] for f in F_taps])
        fl = filt.shape[1]
        raws = [torch.randint(0, 256, (1, blk, 3, H, W), dtype=torch.uint8, device=dev,
                              generator=gen) for _ in range(2)]
        log_tails = [ingest.raw_to_met(dm, r[:, :1], "logLMS_DKLd65")
                     .expand(-1, -1, fl - 1, -1, -1).contiguous() for r in raws]
        args = (*log_tails, *raws, dm, filt, "logLMS_DKLd65")
        out_k = ingest.ingest(*args)
        out_p = ingest.ingest_plain(*args)
        err = max(rel_err_per(a, b, 1) for a, b in zip(out_k, out_p))
        check(f"ingest log-LMS mode {tuple(out_k[0].shape)}", err, TOL["ingest"])
        # As phase 2's ingest bound, with ~18 more operations per new source
        # pixel for the three log10 and the second 3x3.
        b_log = bound(nbytes(*raws, *log_tails) + nbytes(out_k[0]) + 2 * nbytes(out_k[1]),
                      43 * 2 * raws[0].numel() // 3 + 2 * fl * out_k[0].numel())
        k_log = time_ms(lambda: ingest.ingest(*args))
        log(f"  ingest log-LMS mode: max abs error {max_abs(out_k[0], out_p[0]):.3e}, kernel "
            f"{k_log:.3f} ms, plain {time_ms(lambda: ingest.ingest_plain(*args)):.3f} ms, bound "
            f"{b_log[0]:.3f} ms ({b_log[1]}, {100 * b_log[0] / k_log:.1f}% of it)")
        R_log = out_k[0]  # the log coding's 4K block
        del out_k, out_p, args, log_tails
        R = ingest.ingest_replicate(*raws, dm, filt)[0]
        del raws
        mg._ensure_pyramids(W, H)
        consts, luts = mg._band_tables(4)

        # The contrast-band codings of the one-pass kernel (the route of both
        # contrasts): from each 4K band's level gi and the next level gn, the
        # coding formed per sample. Against their plain versions at band 0
        # and the launch that takes the smallest bands; timed at 4K band 0
        # (pooled, both codings; D with log), and D over the 720p log
        # heatmap's bands in one launch.
        ml_ = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                        config_paths=cfg["log"])
        ml_._ensure_pyramids(W, H)
        coding_consts = {"weber_g0_ref": consts, "log": ml_._band_tables(4)[0]}
        n_lv = len(mg.lpyr.pyr_shape)

        def pooled_bound(a, extra=0):
            # As band_pooled's (phase 2): gi's 2C planes and gn's 2C quarter
            # planes read once, the tables, C partial sums a 32x32 tile and
            # the sums written (+ D); ~115 operations a pixel and channel.
            B_, C2_, F_ = a[0][0].shape[:3]
            n_tiles = B_ * F_ * sum(-(-gi.shape[-2] // 32) * -(-gi.shape[-1] // 32)
                                    for gi in a[0])
            return bound(nbytes(*a[0], *a[1], a[2]) + 4 * (C2_ // 2) * n_tiles
                         + 4 * len(a[0]) * B_ * (C2_ // 2) * F_ + extra,
                         115 * sum(gi.numel() for gi in a[0]) // 2)

        modes_p, modes_d = {}, {}
        for coding, R_c in (("weber_g0_ref", R), ("log", R_log)):
            kc = coding_consts[coding]
            levels = [R_c]
            for _ in range(1, n_lv):
                levels.append(prd_reduce(levels[-1]))
            shapes_c = [lv.shape[-2:] for lv in levels[:-1]]
            groups_c = masking_fused.band_groups(shapes_c, 1, 4, blk, gn=True)
            log(f"phase 7: {coding}: band_pooled launches per 4K block: {groups_c}")
            errs, abs_errs = [], []
            for sel in ([0], groups_c[-1]):
                a = ([levels[bb] for bb in sel], [levels[bb + 1] for bb in sel],
                     luts[sel[0]:sel[-1] + 1].contiguous(),
                     [1.0 if bb == 0 else 2.0 for bb in sel], kc)
                note = f"{coding} bands {sel} {[tuple(x.shape[-2:]) for x in a[0]]}"
                s_k, s_p = bp.band_pooled(*a), bp.band_pooled_plain(*a)
                D_k, s_d = bp.band_pooled_d(*a)
                D_p, _ = bp.band_pooled_d_plain(*a)
                q_k, q_p = ([masking_fused.pooled_norm(x[j], *gi.shape[-2:], mg.beta)
                             for j, gi in enumerate(a[0])] for x in (s_k, s_p))
                errs.append(max(rel_err_per(x, y, 1) for x, y in zip(q_k, q_p)))
                abs_errs.append(max(max_abs(x, y) for x, y in zip(q_k, q_p)))
                check(f"band_pooled {note} vs plain", errs[-1], TOL["band_pooled"])
                check(f"band_pooled_d {note} sums vs band_pooled", max_abs(s_d, s_k), 0.0)
                check(f"band_pooled_d {note} vs plain",
                      max(rel_err_per(x, y, 1) for x, y in zip(D_k, D_p)), TOL["band_pooled_d"])
                if sel == [0]:
                    b_c = pooled_bound(a)
                    k_ms = time_ms(lambda: bp.band_pooled(*a))
                    modes_p[coding] = dict(
                        shape=tuple_str(a[0][0].shape), ms=k_ms,
                        plain_ms=time_ms(lambda: bp.band_pooled_plain(*a)), bound_ms=b_c[0],
                        bound_by=b_c[1], max_abs_err=abs_errs[-1])
                    log(f"  band_pooled {coding} 4K band 0: kernel {k_ms:.3f} ms, plain "
                        f"{modes_p[coding]['plain_ms']:.3f} ms, bound {b_c[0]:.4f} ms ({b_c[1]}, "
                        f"{100 * b_c[0] / k_ms:.1f}% of it)")
                    if coding == "log":
                        b_d = pooled_bound(a, nbytes(*D_k))
                        k_ms = time_ms(lambda: bp.band_pooled_d(*a))
                        modes_d["log"] = dict(
                            shape=tuple_str(a[0][0].shape), ms=k_ms,
                            plain_ms=time_ms(lambda: bp.band_pooled_d_plain(*a)),
                            bound_ms=b_d[0], bound_by=b_d[1],
                            max_abs_err=max(max_abs(x, y) for x, y in zip(D_k, D_p)))
                        log(f"  band_pooled_d log 4K band 0: kernel {k_ms:.3f} ms, bound "
                            f"{b_d[0]:.4f} ms ({b_d[1]}, {100 * b_d[0] / k_ms:.1f}% of it)")
                del a, s_k, s_p, D_k, D_p, s_d
                torch.cuda.empty_cache()
            modes_p[coding]["max_rel_err"] = max(errs)
            del levels
        del R, R_log
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        # The texture models' blur: 33 taps, radius 16.
        taps33 = gaussian_kernel1d(33, 8.0)
        xb = torch.rand((3, 1080, 1920), device=dev, generator=gen)
        y_k, y_p = blr.blur(xb, taps33), blur_plain(xb, taps33)
        check("blur 33 taps (3, 1080, 1920)", float((y_k - y_p).abs().max() / y_p.abs().max()),
              TOL["blur"])
        b33 = bound(nbytes(xb, y_k), blur_instr(33) * xb.numel())
        k33 = time_ms(lambda: blr.blur(xb, taps33))
        log(f"  blur 33 taps (3, 1080, 1920): max abs error {max_abs(y_k, y_p):.3e}, kernel "
            f"{k33:.3f} ms, plain {time_ms(lambda: blur_plain(xb, taps33)):.3f} ms, bound "
            f"{b33[0]:.4f} ms ({b33[1]}, {100 * b33[0] / k33:.1f}% of it)")
        del xb, y_k, y_p

        # predict with the two contrasts: the one-pass kernel's codings.
        V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
        V_test, V_ref = (np.ascontiguousarray(v.transpose(3, 2, 0, 1)[None])
                         for v in (V_test, V_ref))
        contrast_path = ("ingest", "pyramid_reduce", "band_pooled", "csf_lut")
        for name in ("weber_g0_ref", "log"):
            jods = {}
            for fused in (True, False):
                mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                               config_paths=cfg[name])
                mv.enable_fused_kernels = fused
                # 8-frame blocks on this metric's route.
                mv.gpu_mem = mv.block_gpu_mem(pix, blk, fps)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.time()
                Q, st = mv.predict(V_test, V_ref, dim_order="BFCHW", frames_per_second=fps)
                jods[fused] = float(Q)
                torch.cuda.synchronize()
                dt = time.time() - t0
                peak = torch.cuda.max_memory_allocated() / 2**30
                counts = {k: fn.launches for k, fn in counters.items()}
                if fused:
                    launches[f"{name}_4k_video"] = counts
                log(f"phase 7: {name} {'kernels' if fused else 'plain  '}: JOD {jods[fused]:.6f}, "
                    f"blk {st['block_N_frames']}, {dt:.3f} s, peak {peak:.2f} GiB, launches "
                    f"{ {k: v for k, v in counts.items() if v} }")
            if not all(math.isfinite(j) for j in jods.values()):
                raise AssertionError(f"{name}: JOD is not finite")
            if not abs(jods[True] - jods[False]) <= 1e-3:
                raise AssertionError(f"{name}: JOD kernels {jods[True]} vs plain {jods[False]}")
            for k in contrast_path:
                if launches[f"{name}_4k_video"][k] <= 0:
                    raise AssertionError(f"kernel {k} was not launched on the {name} path")
        del V_test, V_ref

        # A log-contrast raw heatmap of a 720p image: the D mode on contrast
        # bands, including the 6-row band without the masking blur.
        rng = np.random.RandomState(17)
        I_ref = (rng.rand(720, 1280, 3) * 255).astype(np.uint8)
        I_test = np.clip(I_ref.astype(np.int16) + (rng.randn(720, 1280, 3) * 6).astype(np.int16),
                         0, 255).astype(np.uint8)
        hms = {}
        for fused in (True, False):
            mv = cvt.cvvdp(display_name="standard_4k", device="cuda", quiet=True, heatmap="raw",
                           config_paths=cfg["log"])
            mv.enable_fused_kernels = fused
            for fn in counters.values():
                fn.launches = 0
            Q, st = mv.predict(I_test, I_ref, dim_order="HWC")
            hms[fused] = (float(Q), st["heatmap"].astype(np.float32))
            if fused:
                launches["log_heatmap_720p_image"] = {k: fn.launches for k, fn in counters.items()}
        d_hm = float(np.abs(hms[True][1] - hms[False][1]).max())
        log(f"phase 7: log heatmap 720p: max |kernels - plain| {d_hm:.3e} (tolerance "
            f"{HEATMAP_TOL:.1e}), JOD {hms[True][0]:.6f} vs {hms[False][0]:.6f}, launches "
            f"{ {k: v for k, v in launches['log_heatmap_720p_image'].items() if v} }")
        if not (d_hm <= HEATMAP_TOL and abs(hms[True][0] - hms[False][0]) <= 1e-3):
            raise AssertionError("log heatmap: kernels disagree with plain")
        if launches["log_heatmap_720p_image"]["band_pooled_d"] <= 0:
            raise AssertionError("band_pooled_d was not launched on the log heatmap path")

        # The log heatmap's D launch at its shapes: every interior band of
        # the 720p image in one band_pooled_d launch (C = 3).
        mh = cvt.cvvdp(display_name="standard_4k", device="cuda", quiet=True,
                       config_paths=cfg["log"])
        mh._ensure_pyramids(1280, 720)
        kh, luts_h = mh._band_tables(3)
        g720 = [torch.rand((1, 6, 1, 720, 1280), device=dev, generator=gen) * 2 - 1]
        for _ in range(1, len(mh.lpyr.pyr_shape)):
            g720.append(prd_reduce(g720[-1]))
        sel = list(range(len(g720) - 1))
        a = (g720[:-1], g720[1:], luts_h, [1.0] + [2.0] * (len(sel) - 1), kh)
        D_k, _ = bp.band_pooled_d(*a)
        D_p, _ = bp.band_pooled_d_plain(*a)
        check(f"band_pooled_d log 720p bands {[tuple(x.shape[-2:]) for x in a[0]]} vs plain",
              max(rel_err_per(x, y, 1) for x, y in zip(D_k, D_p)), TOL["band_pooled_d"])
        k_h = time_ms(lambda: bp.band_pooled_d(*a))
        b_h = pooled_bound(a, nbytes(*D_k))
        modes_d["log_720p_image"] = dict(shape=tuple_str(a[0][0].shape), ms=k_h,
                                         bound_ms=b_h[0], bound_by=b_h[1])
        log(f"  band_pooled_d log 720p image, {len(sel)} bands in one launch: kernel "
            f"{k_h:.3f} ms")
        del g720, a, D_k, D_p

        # The generic chain: a FHD image with mult-transducer-texture.
        rng = np.random.RandomState(5)
        I_ref = (rng.rand(1080, 1920, 3) * 255).astype(np.uint8)
        I_test = np.clip(I_ref.astype(np.int16) + (rng.randn(1080, 1920, 3) * 6).astype(np.int16),
                         0, 255).astype(np.uint8)
        jods = {}
        for fused in (True, False):
            mv = cvt.cvvdp(display_name="standard_fhd", device="cuda", quiet=True,
                           config_paths=cfg["texture"])
            mv.enable_fused_kernels = fused
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.time()
            jods[fused] = float(mv.predict(I_test, I_ref, dim_order="HWC")[0])
            torch.cuda.synchronize()
            dt = time.time() - t0
            if fused:
                launches["texture_fhd_image"] = {k: fn.launches for k, fn in counters.items()}
            log(f"phase 7: mult-transducer-texture FHD image {'kernels' if fused else 'plain  '}: "
                f"JOD {jods[fused]:.6f}, {dt:.3f} s")
        tex = launches["texture_fhd_image"]
        log(f"phase 7: texture launches { {k: v for k, v in tex.items() if v} }")
        if not abs(jods[True] - jods[False]) <= 1e-3 * max(1.0, abs(10.0 - jods[False])):
            raise AssertionError(f"texture: JOD kernels {jods[True]} vs plain {jods[False]}")
        if tex["csf_lut"] <= 0 or tex["blur"] <= 0:
            raise AssertionError("the generic chain did not launch the CSF LUT and blur kernels")

        # A training step with weber_g0_ref.
        rng = np.random.RandomState(11)
        ref_np = rng.rand(2, 3, 1, 1080, 1920).astype(np.float32)
        test_np = np.clip(ref_np + rng.randn(*ref_np.shape).astype(np.float32) * 0.1, 0, 1)
        ref_t, test_t = torch.from_numpy(ref_np).to(dev), torch.from_numpy(test_np).to(dev)
        mt = cvt.cvvdp(display_name="standard_fhd", device="cuda", quiet=True,
                       config_paths=cfg["weber_g0_ref"])
        loss_fn = mt.get_loss_fn(1080, 1920)
        res = {}
        for fused in (True, False):
            mt.enable_fused_kernels = fused
            for fn in counters.values():
                fn.launches = 0
            x = test_t.clone().requires_grad_()
            v = loss_fn(x, ref_t)
            (gx,) = torch.autograd.grad(v, x)
            torch.cuda.synchronize()
            res[fused] = (float(v.detach()), gx)
            if fused:
                launches["train_fhd_weber_g0_ref"] = {k: fn.launches for k, fn in counters.items()}
        d_loss = abs(res[True][0] - res[False][0])
        d_grad = float((res[True][1] - res[False][1]).abs().max() / res[False][1].abs().max())
        log(f"phase 7: weber_g0_ref training step: loss {res[True][0]:.6f}, |dloss| {d_loss:.3e}, "
            f"max |dgrad| / max |grad| {d_grad:.3e}, launches "
            f"{ {k: v for k, v in launches['train_fhd_weber_g0_ref'].items() if v} }")
        if not (d_loss <= LOSS_TOL and d_grad <= GRAD_TOL and res[True][1].abs().max() > 0):
            raise AssertionError("weber_g0_ref training step: kernels disagree with plain")
        g0t = launches["train_fhd_weber_g0_ref"]
        if g0t["band_pooled"] <= 0:
            raise AssertionError("band_pooled was not launched on the training path")
        if not g0t["blur_adjoint"] == g0t["blur"] > 0:
            raise AssertionError(f"weber_g0_ref training step: blur {g0t['blur']}, blur_adjoint "
                                 f"{g0t['blur_adjoint']} launches")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows["band_pooled"]["modes"] = modes_p
    rows["band_pooled_d"]["modes"] = modes_d
    log(f"phase 7: {time.time() - t_phase:.1f} s")
    return launches


def seeded_ml_weights(seed):
    """Weights with every key and shape of the published checkpoints (the
    port's ``tools/cvvdp_ml_manifest.json``, both ML families): Linear
    weights uniform in +-1/sqrt(fan_in) (non-negative in the MLPs' last layers, so
    that the saliency head's two ReLU outputs respond), biases uniform in
    +-0.3, LayerNorm gains near 1, the class token standard normal."""
    from colorvideovdp_tpu_torch.tools.convert_ml_ckpt import load_manifest

    manifest = load_manifest()
    shapes = {**manifest["cvvdp_ml_saliency"], **manifest["cvvdp_ml_transformer"]}
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(shapes):
        shape = tuple(shapes[key])
        if key.endswith("cls_token"):
            v = rng.randn(*shape)
        elif len(shape) == 2:
            b = 1.0 / np.sqrt(shape[1])
            v = rng.uniform(0.0 if key in ("feature_net.9.weight", "att_net.12.weight") else -b,
                            b, shape)
        elif "norm" in key or ".reg_head.0." in key:
            v = (1.0 if key.endswith("weight") else 0.0) + rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.uniform(-0.3, 0.3, shape)
        out[key] = v.astype(np.float32)
    return out


# The kernels every ML video run launches besides its first-block mode.
ML_PATH = ("ingest", "pyramid_reduce", "csf_lut", "blur")


def phase_ml(m, fps, record, counters, gen):
    """Phase 8; returns the kernels' launch counts per path."""
    import shutil
    import tempfile

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.metrics import ml
    from colorvideovdp_tpu_torch.ops.kernels import ingest
    from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

    dev = torch.device("cuda")
    H, W, N, blk = 2160, 3840, 12, 8
    t_phase = time.time()
    dm = m.display_photometry
    F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
    filt = np.stack([f[::-1] for f in F_taps])
    fl = filt.shape[1]

    # The first-block modes against their plain version and against tail
    # mode fed their padding converted in plain PyTorch, frame 0 repeated or
    # the heads (these launches are not counted).
    raws = [torch.randint(0, 256, (1, blk, 3, H, W), dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(2)]
    heads = [torch.randint(0, 256, (1, fl - 1, 3, H, W), dtype=torch.uint8, device=dev,
                           generator=gen) for _ in range(2)]
    modes = {
        "ingest_replicate": (lambda: ingest.ingest_replicate(*raws, dm, filt),
                             lambda: ingest.ingest_first_plain(*raws, dm, filt),
                             [ingest.raw_to_met(dm, r[:, :1]).expand(-1, -1, fl - 1, -1, -1)
                              .contiguous() for r in raws], []),
        "ingest_head": (lambda: ingest.ingest_head(*heads, *raws, dm, filt),
                        lambda: ingest.ingest_first_plain(*raws, dm, filt, "DKLd65", *heads),
                        [ingest.raw_to_met(dm, h).contiguous() for h in heads], heads),
    }
    for name, (fn_k, fn_p, tails, pads) in modes.items():
        out_k, out_p = fn_k(), fn_p()
        err = max(rel_err_per(a, b, 1) for a, b in zip(out_k, out_p))
        d_tail = max(max_abs(a, b) for a, b in zip(out_k, ingest.ingest(*tails, *raws, dm, filt)))
        log(f"  {name} {tuple(out_k[0].shape)}: max |kernel - tail mode on formed tails| "
            f"{d_tail:.3e}")
        if not d_tail <= 1e-5 * float(out_p[0].abs().max()):
            raise AssertionError(f"{name} disagrees with tail mode on the formed tails")
        # As the tail mode's bound: ~25 operations per converted source pixel
        # (the new frames, and the heads in head mode), fl multiply-adds per
        # output element; raws (and raw heads) in, the block and tails out.
        n_conv = raws[0].numel() + sum(h.numel() for h in pads[:1])
        bnd = bound(nbytes(*raws, *pads) + nbytes(out_k[0]) + 2 * nbytes(out_k[1]),
                    25 * 2 * n_conv // 3 + 2 * fl * out_k[0].numel())
        record(name, err, max(max_abs(x, y) for x, y in zip(out_k, out_p)), time_ms(fn_k),
               time_ms(fn_p), bnd)
        del out_k, out_p, tails
    del raws, heads, modes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # predict with both ML metrics. The split: feature pooling and the head
    # are timed apart (synchronised), the trunk is the rest of the wall time.
    split = {"pool": 0.0, "head": 0.0}
    pool = ml.feature_pooling

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args)
            torch.cuda.synchronize()
            split[key] += time.time() - t0
            return out
        return run

    pix = H * W
    # gpu_mem for 8-frame blocks under the ML metrics' block model.
    mem_a, mem_b, mem_c = cvt.cvvdp_ml_transformer.mem_model
    gpu_mem = (mem_a + pix * (fl - 1) * mem_b + pix * (mem_b + mem_c) * (blk + 0.5)) / 1e9
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    V_test, V_ref = (np.ascontiguousarray(v.transpose(3, 2, 0, 1)[None]) for v in (V_test, V_ref))
    rng = np.random.RandomState(5)
    I_ref = (rng.rand(1080, 1920, 3) * 255).astype(np.uint8)
    I_test = np.clip(I_ref.astype(np.int16) + (rng.randn(1080, 1920, 3) * 6).astype(np.int16),
                     0, 255).astype(np.uint8)
    video = dict(dim_order="BFCHW", frames_per_second=fps)
    # The FHD image first: its run also warms up the matrix-product library,
    # so that the 4K runs' head times hold no one-time set-up.
    runs = [("ml_transformer_fhd_image", cvt.cvvdp_ml_transformer, "standard_fhd",
             "replicate", I_test, I_ref, dict(dim_order="HWC"))]
    runs += [(f"ml_{fam}_4k_{pad}", cls, "standard_hdr_pq", pad, V_test, V_ref, video)
             for fam, cls in (("saliency", cvt.cvvdp_ml_saliency),
                              ("transformer", cvt.cvvdp_ml_transformer))
             for pad in ("replicate", "symmetric")]
    tmp = tempfile.mkdtemp(prefix="cvvdp_ml_")
    launches = {}
    ml.feature_pooling = timed(pool, "pool")
    try:
        np.savez(f"{tmp}/cvvdp_ml.npz", **seeded_ml_weights(13))
        for path, cls, disp, pad, t_in, r_in, kw in runs:
            jods = {}
            for fused in (True, False):
                mv = cls(display_name=disp, device="cuda", quiet=True, gpu_mem=gpu_mem,
                         temp_padding=pad, config_paths=[tmp])
                mv.enable_fused_kernels = fused
                mv.do_pooling_and_jods = timed(mv.do_pooling_and_jods, "head")
                split.update(pool=0.0, head=0.0)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.time()
                Q, st = mv.predict(t_in, r_in, **kw)
                jods[fused] = float(Q)
                torch.cuda.synchronize()
                dt = time.time() - t0
                counts = {k: fn.launches for k, fn in counters.items()}
                if fused:
                    launches[path] = counts
                log(f"phase 8: {path} {'kernels' if fused else 'plain  '}: JOD {jods[fused]:.6f}, "
                    f"blk {st['block_N_frames']}, {dt:.3f} s (trunk "
                    f"{dt - split['pool'] - split['head']:.3f}, feature pooling "
                    f"{split['pool']:.3f}, head {split['head']:.3f}), peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
                    f"{ {k: v for k, v in counts.items() if v} }")
                del mv
            if not (all(math.isfinite(j) for j in jods.values())
                    and abs(10.0 - jods[True]) > 1e-3):
                raise AssertionError(f"{path}: JOD {jods[True]} is not finite or does not respond")
            if not abs(jods[True] - jods[False]) <= ML_JOD_TOL:
                raise AssertionError(f"{path}: JOD kernels {jods[True]} vs plain {jods[False]}")
            need = (("pyramid_reduce", "csf_lut", "blur") if path.endswith("image") else
                    ML_PATH + (("ingest_replicate",) if pad == "replicate" else ("ingest_head",)))
            for k in need:
                if launches[path][k] <= 0:
                    raise AssertionError(f"kernel {k} was not launched on the {path} path")
            log(f"phase 8: {path}: |JOD kernels - plain| {abs(jods[True] - jods[False]):.2e} "
                f"(tolerance {ML_JOD_TOL:.0e})")
    finally:
        ml.feature_pooling = pool
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 8: {time.time() - t_phase:.1f} s")
    return launches


def phase_one_band(m, fps, counters, gen):
    """Phase 9; returns the kernels' launch counts of the 4K training step."""
    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
    from colorvideovdp_tpu_torch.ops.kernels import ingest, masking_fused
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
    from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

    dev = torch.device("cuda")
    H, W, blk = 2160, 3840, 8
    t_phase = time.time()

    # The one-pass kernel on one band, pooled and D, against its plain
    # versions (these launches are not counted): 4K band 0 of an 8-frame
    # block, and an off-grid band.
    dm = m.display_photometry
    F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
    filt = np.stack([f[::-1] for f in F_taps])
    raws = [torch.randint(0, 256, (1, blk, 3, H, W), dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(2)]
    gi = ingest.ingest_replicate(raws[0], raws[1], dm, filt)[0]
    del raws
    m._ensure_pyramids(W, H)
    consts, luts = m._band_tables(4)
    cases = [("4K band 0", gi, prd.pyramid_reduce(gi), luts[0], 1.0)]
    g_off = torch.rand((1, 8, 2, 1081, 1921), device=dev, generator=gen) * 40 + 10
    cases.append(("off-grid", g_off, prd.pyramid_reduce(g_off), luts[1], 2.0))
    for note, g, gn, lut, mul in cases:
        args = ([g], [gn], lut[None].contiguous(), [mul], consts)
        s_k, s_p = bp.band_pooled(*args)[0], bp.band_pooled_plain(*args)[0]
        h, w = g.shape[-2:]
        q_k, q_p = (masking_fused.pooled_norm(x, h, w, m.beta) for x in (s_k, s_p))
        (D_k,), sd_k = bp.band_pooled_d(*args)
        (D_p,), _ = bp.band_pooled_d_plain(*args)
        check(f"band_pooled_d {note} sums vs band_pooled", max_abs(sd_k[0], s_k), 0.0)
        check(f"band_pooled {note} {tuple(g.shape)}", rel_err_per(q_k, q_p, 1),
              TOL["band_pooled"])
        check(f"band_pooled_d {note} {tuple(g.shape)}", rel_err_per(D_k, D_p, 1),
              TOL["band_pooled_d"])
        log(f"phase 9: {note} {tuple(g.shape)}: pooled {time_ms(lambda: bp.band_pooled(*args)):.3f}"
            f" ms, D {time_ms(lambda: bp.band_pooled_d(*args)):.3f} ms")
        del s_k, s_p, D_k, D_p, sd_k
    del cases, g_off, gi
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # A 4K training step, kernels against plain.
    rng = np.random.RandomState(11)
    ref_np = rng.rand(1, 3, 1, H, W).astype(np.float32)
    test_np = np.clip(ref_np + rng.randn(*ref_np.shape).astype(np.float32) * 0.1, 0, 1)
    ref_t, test_t = torch.from_numpy(ref_np).to(dev), torch.from_numpy(test_np).to(dev)
    del ref_np, test_np
    out, launches = {}, None
    for fused in (True, False):
        mt = cvt.cvvdp(display_name="standard_4k", device="cuda", quiet=True)
        mt.enable_fused_kernels = fused
        loss_fn = mt.get_loss_fn(H, W)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.time()
        x = test_t.clone().requires_grad_()
        v = loss_fn(x, ref_t)
        (gx,) = torch.autograd.grad(v, x)
        torch.cuda.synchronize()
        dt = time.time() - t0
        out[fused] = (float(v.detach()), gx)
        if fused:
            launches = {k: fn.launches for k, fn in counters.items()}
            groups = masking_fused.band_groups(mt.lpyr.pyr_shape[:-1], 1, 3, 1, gn=True)
        log(f"phase 9: 4K training step {'kernels' if fused else 'plain  '}: loss "
            f"{float(v.detach()):.6f}, {dt:.3f} s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del loss_fn, mt, x, v
    (vk, gk), (vp, gp) = out[True], out[False]
    if not (torch.isfinite(gk).all() and gk.abs().max() > 0):
        raise AssertionError("4K training gradient is not finite and non-zero")
    d_loss = abs(vk - vp)
    d_grad = float((gk - gp).abs().max() / gp.abs().max())
    log(f"phase 9: 4K training step: |dloss| {d_loss:.3e}, max |dgrad| / max |grad| "
        f"{d_grad:.3e} (tolerances {LOSS_TOL:.0e}, {GRAD_TOL:.0e})")
    if not (d_loss <= LOSS_TOL and d_grad <= GRAD_TOL):
        raise AssertionError("4K training step: kernels disagree with plain")
    # Once in the forward, once in the checkpointed block's recompute.
    if launches["band_pooled"] != 2 * len(groups):
        raise AssertionError(f"band_pooled launched {launches['band_pooled']} times on the 4K "
                             f"training step, not {2 * len(groups)}")
    log(f"phase 9: {time.time() - t_phase:.1f} s")
    return {"train_4k_image": launches}


def phase_interleave(record, counters):
    """Phase 10; returns the kernels' launch counts of the timed run."""
    from colorvideovdp_tpu_torch.tools import interleave_bench as ib

    t_phase = time.time()
    ev, od, x = ib.make_inputs(*ib.SHAPE, "cuda")
    errs = ib.check(ev, od, x)  # raises unless bit-equal (not counted)
    for fn in counters.values():
        fn.launches = 0
    rows_i = ib.measure(ev, od, x)
    counts = {k: fn.launches for k, fn in counters.items()}
    for name, r in rows_i.items():
        log(f"  {name} {ib.SHAPE}: copy floor {r['copy_floor_ms']:.3f} ms, {r['gb_per_s']:.0f} GB/s")
        record(name, errs[name], errs[name], r["ms"], r["plain_ms"],
               (r["bound_ms"], r["bound_by"]), r["library_ms"])
    del ev, od, x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 10: {time.time() - t_phase:.1f} s")
    return {"interleave_bench": counts}


# The kernels every rank of the sharded 4K video must launch (phase 11).
SHARD_PATH = ("ingest", "ingest_replicate", "pyramid_reduce", "pyramid_reduce_slab",
              "band_pooled", "band_pooled_halo", "csf_lut")
# Frames per block of the sharded run; phase 11 holds the kernels at its shapes.
SHARD_BLOCK = 16
# The coded runs' block (weber_g0_ref, log) and the kernels' bound against
# plain there; the sharded loss step's gradient against single-device.
SHARD_CODED_FRAMES, SHARD_KERNEL_TOL, SHARD_GRAD_TOL = 8, 1e-3, 1e-3
# The sharded heatmap's image and the generic chain's and loss step's size.
SHARD_CFG_SIZES = {"hm": (720, 1280), "fhd": (1080, 1920)}


def halo_slab(x, s, n_sp, edge):
    """Rank s's slab of x with 8 rows of each neighbour, and at a global
    edge zeros (the reduce) or the exclude-edge reflection (the band)."""
    from colorvideovdp_tpu_torch.ops.kernels.masking_fused import HALO_ROWS as r

    h_loc = x.shape[-2] // n_sp
    lo, hi = s * h_loc, (s + 1) * h_loc
    z = torch.zeros_like(x[..., :r, :])
    above = x[..., lo - r:lo, :] if s > 0 else (z if edge == "zero"
                                                 else x[..., 1:r + 1, :].flip(-2))
    below = x[..., hi:hi + r, :] if s < n_sp - 1 else (z if edge == "zero"
                                                       else x[..., -r - 1:-1, :].flip(-2))
    return torch.cat([above, x[..., lo:hi, :], below], dim=-2).contiguous()


def halo_gn_slab(gn, s, n_sp, sharded):
    """(rows, row0) of gn as sharding.halo_gn hands them to rank s."""
    from colorvideovdp_tpu_torch.ops.kernels.band_pooled import GN_HALO_ROWS as gr

    if not sharded:
        return gn, 0
    hn_loc = gn.shape[-2] // n_sp
    z = torch.zeros_like(gn[..., :gr, :])
    above = gn[..., s * hn_loc - gr:s * hn_loc, :] if s > 0 else z
    below = gn[..., (s + 1) * hn_loc:(s + 1) * hn_loc + gr, :] if s < n_sp - 1 else z
    return (torch.cat([above, gn[..., s * hn_loc:(s + 1) * hn_loc, :], below], -2)
            .contiguous(), s * hn_loc - gr)


def phase_sharded(m, fps, rows, record, jod_single, gen):
    """Phase 11; returns each sharded path's launch counts, summed over the
    ranks: the 4K clip's and those of ``sharded_configs``."""
    import os
    import shutil
    import tempfile
    from types import SimpleNamespace

    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
    from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
    from colorvideovdp_tpu_torch.parallel import run_ranks
    from colorvideovdp_tpu_torch.parallel import sharding as sh

    t_phase = time.time()
    H, W, N, blk, n_sp = 2160, 3840, 32, SHARD_BLOCK, 2
    r = bm.HALO_ROWS
    dev = torch.device("cuda")

    def slab(x, s, edge):
        return halo_slab(x, s, n_sp, edge)

    # The launches of the sharded run, from the global shapes as its routing
    # makes them: levels are slab-reduced while the gate admits them (4K:
    # levels 0-2); the bands of the row-sharded levels that band_shardable
    # admits take the halo mode, packed into launches by band_groups.
    m._ensure_pyramids(W, H)
    shapes = m.lpyr.pyr_shape
    n_red = 0
    while sh.slab_reducible(shapes[n_red][0] // n_sp, shapes[n_red][1]):
        n_red += 1
    params = m._masking_params()
    halo = [bb for bb in range(min(n_red + 1, len(shapes) - 1))
            if sh.band_shardable(params, *shapes[bb], SimpleNamespace(n_space=n_sp))]
    groups = [[halo[i] for i in sel] for sel in bm.band_groups(
        [(shapes[bb][0] // n_sp + 2 * r, shapes[bb][1]) for bb in halo], 1, 4, blk, gn=True)]
    log(f"phase 11: {blk}-frame blocks: slab reduce at levels {list(range(n_red))}, "
        f"halo launches {groups}")

    # The slab reduce at every level it takes (P = 8 channels x blk frames).
    errs, abs_errs = [], []
    for lv in range(n_red):
        x = torch.rand((1, 8, blk) + tuple(shapes[lv]), device=dev, generator=gen)
        for s in range(n_sp):
            xs = slab(x, s, "zero")
            y_k, y_p = prd.pyramid_reduce_slab(xs, False), pyr.reduce_slab_plain(xs, False)
            errs.append(float((y_k - y_p).abs().max()) / max(1.0, float(y_p.abs().max())))
            abs_errs.append(max_abs(y_k, y_p))
            log(f"  pyramid_reduce_slab level {lv} rank {s} {tuple(xs.shape)}: max |kernel - "
                f"plain| {abs_errs[-1]:.3e}")
            if lv == 0 and s == 0:
                k_ms = time_ms(lambda: prd.pyramid_reduce_slab(xs, False))
                p_ms = time_ms(lambda: pyr.reduce_slab_plain(xs, False))
                # 5 taps vertically over (H_loc/2, W), 5 over (H_loc/2, W/2).
                h_loc = xs.shape[-2] - 2 * r
                b_red = bound(nbytes(xs, y_k), 7.5 * xs.numel() * h_loc // (h_loc + 2 * r))
        del x, xs, y_k, y_p
    record("pyramid_reduce_slab", max(errs), max(abs_errs), k_ms, p_ms, b_red)

    # The one-pass kernel's halo mode (band_pooled_halo, the route) at every
    # launch it takes, C = 4, from gi slabs and the rows of gn their expand
    # reads (5 a side of a sharded gn, levels 1..n_red; a replicated gn
    # whole), against its plain version; per group the two ranks' sums
    # against the whole bands' band_pooled. Timed at the first launch on
    # rank 0.
    consts, luts = m._band_tables(4)
    gr = bp.GN_HALO_ROWS

    def gn_rows(gn, s, sharded):
        return halo_gn_slab(gn, s, n_sp, sharded)

    errs, abs_errs = [], []
    for g, sel in enumerate(groups):
        gis = [torch.rand((1, 8, blk) + tuple(shapes[bb]), device=dev, generator=gen) * 20 + 30
               for bb in sel]
        gns = [prd.pyramid_reduce(gi) for gi in gis]
        sharded = [bb + 1 <= n_red for bb in sel]
        muls = [1.0 if bb == 0 else 2.0 for bb in sel]
        whole = bp.band_pooled(gis, gns, luts[sel], muls, consts)
        total = 0
        for s in range(n_sp):
            xs = [slab(gi, s, "reflect") for gi in gis]
            ys, row0s = zip(*[gn_rows(gn, s, sh_) for gn, sh_ in zip(gns, sharded)])
            ys = list(ys)
            slabs = [(s * (shapes[bb][0] // n_sp), shapes[bb][0], row0)
                     for bb, row0 in zip(sel, row0s)]
            h_valids = [shapes[bb][0] // n_sp for bb in sel]
            args = (xs, ys, luts[sel], muls, consts, slabs)
            s_k, s_p = bp.band_pooled_halo(*args), bp.band_pooled_halo_plain(*args)
            errs.append(rel_err_per(s_k, s_p, 2))
            abs_errs.append(max_abs(s_k, s_p))
            total = total + s_k
            log(f"  band_pooled_halo bands {sel} rank {s} {[tuple(x.shape) for x in xs]}, gn "
                f"{[tuple(y.shape[-2:]) for y in ys]} from rows {list(row0s)}: error vs plain "
                f"{errs[-1]:.3e}")
            if g == 0 and s == 0:
                k_ms = time_ms(lambda: bp.band_pooled_halo(*args))
                p_ms = time_ms(lambda: bp.band_pooled_halo_plain(*args))
                # gi's slab and gn's rows read once, the tables, C partials a
                # tile of the owned rows and the sums written; ~115
                # operations a pixel and channel of the owned rows.
                n_tiles = blk * sum(-(-hv // 32) * -(-x.shape[-1] // 32)
                                    for hv, x in zip(h_valids, xs))
                b_pd = bound(nbytes(*xs, *ys, luts[sel], s_k) + 4 * 4 * n_tiles,
                             sum(115 * 4 * blk * hv * x.shape[-1] for hv, x in zip(h_valids, xs)))
                log(f"  band_pooled_halo bands {sel} rank 0: kernel {k_ms:.3f} ms, bound "
                    f"{b_pd[0]:.4f} ms ({b_pd[1]}, {100 * b_pd[0] / k_ms:.1f}% of it)")
                for bb, x, y, sh_ in zip(sel, xs, ys, sharded):
                    C2, F_, w = x.shape[1], x.shape[2], x.shape[-1]
                    i_bytes = 2 * r * w * C2 * F_ * 4
                    g_bytes = 2 * gr * y.shape[-1] * C2 * F_ * 4 if sh_ else 0
                    log(f"  halo exchange of band {bb} a rank: gi's 2 x {r} rows "
                        f"{i_bytes / 1e6:.3f} MB, gn's "
                        f"{'2 x %d rows' % gr if sh_ else 'none (replicated)'} "
                        f"{g_bytes / 1e6:.3f} MB")
        check(f"band_pooled_halo bands {sel}: the ranks' sums against the whole bands",
              rel_err_per(total, whole, 2), TOL["band_pooled_halo"])
        del gis, gns, xs, ys, args, s_k, s_p, whole, total
    record("band_pooled_halo", max(errs), max(abs_errs), k_ms, p_ms, b_pd)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The halo mode in the contrast-band codings (band_pooled_halo) at the
    # first halo launch of an 8-frame 4K block (rank 0's and rank 1's slabs
    # of bands 0-3, C = 4), against its plain version; the D mode
    # (band_pooled_d_halo) there too, as an extra check logged only: D's
    # owned rows bit for bit the whole bands' band_pooled_d, its sums the
    # pooled mode's. Timed on rank 0's slabs in turns. The D mode's row of
    # the kernels line comes from the heatmap run's own shapes (below).
    t0 = time.time()
    from colorvideovdp_tpu_torch.utils.config import write_parameters

    cfg_tmp = tempfile.mkdtemp(prefix="cvvdp_phase11_cfg_")
    coded = {}
    for coding in ("weber_g0_ref", "log"):
        mc = cvvdp_for(m.display_name, write_parameters(os.path.join(cfg_tmp, coding),
                                                        contrast=coding))
        mc._ensure_pyramids(W, H)
        coded[coding] = mc._band_tables(4)
    sel, blk_c = groups[0], SHARD_CODED_FRAMES
    muls = [1.0 if bb == 0 else 2.0 for bb in sel]
    sharded = [bb + 1 <= n_red for bb in sel]
    gis = [torch.rand((1, 8, blk_c) + tuple(shapes[bb]), device=dev, generator=gen) * 20 + 30
           for bb in sel]
    gns = [prd.pyramid_reduce(gi) for gi in gis]
    h_valids = [shapes[bb][0] // n_sp for bb in sel]
    errs_c, abs_c, errs_d, abs_d = [], [], [], []
    for name, (kc, lc) in [("weber_g1", (consts, luts))] + list(coded.items()):
        if name == "log":  # log-LMS levels: 0..1 in place of 30..50
            gis = [gi * 0.05 - 1.5 for gi in gis]
            gns = [prd.pyramid_reduce(gi) for gi in gis]
        D_whole, _ = bp.band_pooled_d(gis, gns, lc[sel], muls, kc)
        for s in range(n_sp):
            xs = [slab(gi, s, "reflect") for gi in gis]
            ys, row0s = zip(*[gn_rows(gn, s, sh_) for gn, sh_ in zip(gns, sharded)])
            slabs = [(s * hv, shapes[bb][0], row0) for bb, hv, row0 in zip(sel, h_valids, row0s)]
            args = (xs, list(ys), lc[sel], muls, kc, slabs)
            s_k = bp.band_pooled_halo(*args)
            Ds, s_d = bp.band_pooled_d_halo(*args)
            check(f"band_pooled_d_halo {name} rank {s}: sums vs band_pooled_halo",
                  max_abs(s_d, s_k), 0.0)
            D_p, s_p = bp.band_pooled_d_halo_plain(*args)
            if name != "weber_g1":
                errs_c.append(rel_err_per(s_k, s_p, 2))
                abs_c.append(max_abs(s_k, s_p))
            errs_d.append(max(rel_err_per(D, Dp, 1) for D, Dp in zip(Ds, D_p)))
            abs_d.append(max(max_abs(D, Dp) for D, Dp in zip(Ds, D_p)))
            for D, Dw, hv in zip(Ds, D_whole, h_valids):
                check(f"band_pooled_d_halo {name} rank {s} bands {sel}: owned rows vs the whole "
                      "band's band_pooled_d", max_abs(D, Dw[..., s * hv:(s + 1) * hv, :]), 0.0)
            log(f"  band_pooled_halo / _d_halo {name} bands {sel} rank {s}: sums vs plain "
                f"{rel_err_per(s_k, s_p, 2):.3e}, D vs plain {errs_d[-1]:.3e}")
            if s == 0:
                # gi's slab and gn's rows read once, the tables, C partials a
                # tile of the owned rows and the sums written (the D mode adds
                # D of the owned rows); ~115 operations a pixel and channel of
                # the owned rows.
                n_tiles = blk_c * sum(-(-hv // 32) * -(-x.shape[-1] // 32)
                                      for hv, x in zip(h_valids, xs))
                n_ops = sum(115 * 4 * blk_c * hv * x.shape[-1] for hv, x in zip(h_valids, xs))
                b_in = nbytes(*xs, *ys, lc[sel], s_k) + 4 * 4 * n_tiles
                turns = [time_ms(lambda: bp.band_pooled_halo(*args)),
                         time_ms(lambda: bp.band_pooled_d_halo(*args)),
                         time_ms(lambda: bp.band_pooled_d_halo(*args)),
                         time_ms(lambda: bp.band_pooled_halo(*args))]
                b_c = bound(b_in, n_ops)
                log(f"  band_pooled_halo {name} bands {sel} rank 0 {blk_c} frames: pooled "
                    f"{turns[0]:.3f}/{turns[3]:.3f} ms, D mode {turns[1]:.3f}/{turns[2]:.3f} ms "
                    f"in turns; pooled bound {b_c[0]:.4f} ms ({b_c[1]})")
            if s == 0 and name == "weber_g1":
                d_pms = time_ms(lambda: bp.band_pooled_d_halo_plain(*args))
                b_dh = bound(b_in + nbytes(*Ds), n_ops)
                log(f"  band_pooled_d_halo at the 8-frame 4K slab (not on a path): kernel "
                    f"{(turns[1] + turns[2]) / 2:.3f} ms, plain {d_pms:.3f} ms, bound "
                    f"{b_dh[0]:.4f} ms ({b_dh[1]})")
        del D_whole
    check("band_pooled_halo weber_g0_ref/log vs plain", max(errs_c), SHARD_KERNEL_TOL)
    check("band_pooled_d_halo at the 8-frame 4K slab vs plain", max(errs_d), SHARD_KERNEL_TOL)
    log(f"  band_pooled_halo codings: worst sums error {max(errs_c):.3e} (max abs "
        f"{max(abs_c):.3e}) against plain, tolerance {SHARD_KERNEL_TOL}; band_pooled_d_halo "
        f"at 4K: D error {max(errs_d):.3e} (max abs {max(abs_d):.3e})")
    del gis, gns, xs, ys, Ds, D_p, args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 11: coded halo modes held in {time.time() - t0:.1f} s")

    hm_route = heatmap_halo_d(record, gen, n_sp, dev)

    # The 4K clip through the sharded predict_video_source on a (1, 2) mesh.
    t0 = time.time()
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    tmp = tempfile.mkdtemp(prefix="cvvdp_phase11_")
    paths = [os.path.join(tmp, f"{k}.npy") for k in ("test", "reference")]
    for p, V in zip(paths, (V_test, V_ref)):
        np.save(p, np.ascontiguousarray(V.transpose(3, 2, 0, 1)[None]))  # (1, F, 3, H, W)
    V8 = [np.ascontiguousarray(V[..., :SHARD_CODED_FRAMES].transpose(3, 2, 0, 1)[None])
          for V in (V_test, V_ref)]
    del V_test, V_ref
    log(f"phase 11: BFCHW clip written in {time.time() - t0:.1f} s")
    n_cards = torch.cuda.device_count()
    share = 1 if n_cards >= n_sp else n_sp
    gpu_mem = m.block_gpu_mem(H // n_sp * W, blk, fps, share, reference_model=True)
    spec = dict(test=paths[0], reference=paths[1], dim_order="BFCHW", fps=fps,
                display_name="standard_hdr_pq", gpu_mem=gpu_mem)
    log(f"phase 11: {n_cards} card(s): {'one rank per card, NCCL' if share == 1 else 'two gloo ranks on card 0'}, "
        f"gpu_mem {gpu_mem:.3f} GB for {blk}-frame blocks")
    t0 = time.time()
    try:
        res = run_ranks(sh.score_rank, n_sp, (spec,), device="cuda", timeout_s=300)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.time() - t0
    for rr in res:
        jod = float(rr["jod"])
        log(f"phase 11: rank {rr['rank']} (b {rr['b']}, s {rr['s']}) on {rr['device']}: JOD "
            f"{jod:.6f}, blk {rr['block_N']}, set-up {rr['setup_s']:.3f} s, block loop "
            f"{rr['block_loop_s']:.3f} s, "
            f"peak memory {rr['peak_bytes'] / 2**30:.2f} GiB, route {rr['route']}, launches "
            f"{rr['launches']}")
        if rr["block_N"] != blk:
            raise AssertionError(f"rank {rr['rank']}: {rr['block_N']}-frame blocks, the kernels "
                                 f"were held at {blk}")
        for k in SHARD_PATH:
            if rr["launches"][k] <= 0:
                raise AssertionError(f"rank {rr['rank']}: kernel {k} was not launched")
        if not abs(jod - jod_single) <= SHARD_JOD_TOL:
            raise AssertionError(f"rank {rr['rank']}: sharded JOD {jod} vs single-device "
                                 f"{jod_single}")
        if not abs(jod - CLIP_JOD) <= 0.01:
            raise AssertionError(f"rank {rr['rank']}: sharded JOD {jod} vs reference {CLIP_JOD}")
    log(f"phase 11: sharded 4K JOD {float(res[0]['jod']):.6f}, |JOD - single-device| "
        f"{abs(float(res[0]['jod']) - jod_single):.2e}, wall {wall:.3f} s for {N} frames "
        f"(spawn and set-up included)")
    paths = {"sharded_4k_video": {k: sum(rr["launches"][k] for rr in res)
                                  for k in res[0]["launches"]}}
    try:
        paths.update(sharded_configs(m, fps, V8, cfg_tmp, n_sp, gen, hm_route))
    finally:
        shutil.rmtree(cfg_tmp, ignore_errors=True)
    log(f"phase 11: {time.time() - t_phase:.1f} s")
    return paths


def heatmap_halo_d(record, gen, n_sp, dev):
    """band_pooled_d_halo at the launches of the sharded heatmap run
    (sharded_hm_720p_image: a 1280x720 image on the (1, n_sp) mesh, C = 3,
    F = 1, the halo groups band_groups makes of its halo bands): both
    ranks' slabs against the plain version, D's owned rows bit for bit the
    whole bands' band_pooled_d and its sums the pooled mode's; timed on
    rank 0 (every launch of a rank, in turns with the plain version), with
    the bound, into the kernels line. Returns the route the heatmap run
    must show: its halo bands and each rank's gn rows (count, first)."""
    from types import SimpleNamespace

    from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
    from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
    from colorvideovdp_tpu_torch.parallel import sharding as sh

    r = bm.HALO_ROWS
    t0 = time.time()
    hh, hw = SHARD_CFG_SIZES["hm"]
    mh = cvvdp_for("standard_4k", None, heatmap="raw")
    mh._ensure_pyramids(hw, hh)
    shapes_h, params_h = mh.lpyr.pyr_shape, mh._masking_params()
    n_red_h = 0
    while sh.slab_reducible(shapes_h[n_red_h][0] // n_sp, shapes_h[n_red_h][1]):
        n_red_h += 1
    halo_h = [bb for bb in range(min(n_red_h + 1, len(shapes_h) - 1))
              if sh.band_shardable(params_h, *shapes_h[bb], SimpleNamespace(n_space=n_sp))]
    groups_h = [[halo_h[i] for i in sel] for sel in bm.band_groups(
        [(shapes_h[bb][0] // n_sp + 2 * r, shapes_h[bb][1]) for bb in halo_h], 1, 3, 1,
        [True] * len(halo_h), gn=True)]
    kh, lh = mh._band_tables(3)
    hm_route = {"halo_bands": halo_h, "halo_gn_rows": [[] for _ in range(n_sp)]}
    errs_d, abs_d, d_turns, b_in, n_ops = [], [], [], 0, 0
    for sel in groups_h:
        muls = [1.0 if bb == 0 else 2.0 for bb in sel]
        sharded = [bb + 1 <= n_red_h for bb in sel]
        h_valids = [shapes_h[bb][0] // n_sp for bb in sel]
        gis = [torch.rand((1, 6, 1) + tuple(shapes_h[bb]), device=dev, generator=gen) * 20 + 30
               for bb in sel]
        gns = [prd.pyramid_reduce(gi) for gi in gis]
        D_whole, _ = bp.band_pooled_d(gis, gns, lh[sel], muls, kh)
        for s in range(n_sp):
            xs = [halo_slab(gi, s, n_sp, "reflect") for gi in gis]
            ys, row0s = zip(*[halo_gn_slab(gn, s, n_sp, sh_) for gn, sh_ in zip(gns, sharded)])
            hm_route["halo_gn_rows"][s] += [(y.shape[-2], row0) for y, row0 in zip(ys, row0s)]
            slabs = [(s * hv, shapes_h[bb][0], row0)
                     for bb, hv, row0 in zip(sel, h_valids, row0s)]
            args = (xs, list(ys), lh[sel], muls, kh, slabs)
            Ds, s_d = bp.band_pooled_d_halo(*args)
            check(f"band_pooled_d_halo 720p rank {s} bands {sel}: sums vs band_pooled_halo",
                  max_abs(s_d, bp.band_pooled_halo(*args)), 0.0)
            D_p, s_p = bp.band_pooled_d_halo_plain(*args)
            errs_d.append(max([rel_err_per(D, Dp, 1) for D, Dp in zip(Ds, D_p)]
                              + [rel_err_per(s_d, s_p, 2)]))
            abs_d.append(max(max_abs(D, Dp) for D, Dp in zip(Ds, D_p)))
            for D, Dw, hv in zip(Ds, D_whole, h_valids):
                check(f"band_pooled_d_halo 720p rank {s} bands {sel}: owned rows vs the whole "
                      "band's band_pooled_d", max_abs(D, Dw[..., s * hv:(s + 1) * hv, :]), 0.0)
            log(f"  band_pooled_d_halo 720p bands {sel} rank {s} "
                f"{[tuple(x.shape) for x in xs]}, gn {[tuple(y.shape) for y in ys]}: D and sums "
                f"vs plain {errs_d[-1]:.3e} (max abs {abs_d[-1]:.3e})")
            if s == 0:
                # As at 4K: gi's slab and gn's rows read once, the tables, C
                # partials a tile of the owned rows, the sums and D written;
                # ~115 operations a pixel and channel of the owned rows.
                n_tiles = sum(-(-hv // 32) * -(-x.shape[-1] // 32) for hv, x in zip(h_valids, xs))
                b_in += nbytes(*xs, *ys, lh[sel], s_d, *Ds) + 3 * 4 * n_tiles
                n_ops += sum(115 * 3 * hv * x.shape[-1] for hv, x in zip(h_valids, xs))
                d_turns.append([time_ms(lambda: bp.band_pooled_d_halo(*args)),
                                time_ms(lambda: bp.band_pooled_d_halo_plain(*args)),
                                time_ms(lambda: bp.band_pooled_d_halo_plain(*args)),
                                time_ms(lambda: bp.band_pooled_d_halo(*args))])
        del gis, gns, D_whole, xs, ys, Ds, D_p, args
    d_ms = sum((t[0] + t[3]) / 2 for t in d_turns)
    d_pms = sum((t[1] + t[2]) / 2 for t in d_turns)
    b_dh = bound(b_in, n_ops)
    check("band_pooled_d_halo at the 720p heatmap's launches vs plain", max(errs_d),
          SHARD_KERNEL_TOL)
    record("band_pooled_d_halo", max(errs_d), max(abs_d), d_ms, d_pms, b_dh)
    log(f"phase 11: band_pooled_d_halo at the 720p heatmap's {len(groups_h)} launch(es) a rank "
        f"(groups {groups_h}): kernel {d_ms:.4f} ms, plain {d_pms:.4f} ms on rank 0 (in turns "
        f"{[[round(x, 4) for x in t] for t in d_turns]}), bound {b_dh[0]:.4f} ms ({b_dh[1]}), "
        f"worst error {max(errs_d):.3e}; held in {time.time() - t0:.1f} s")
    del mh
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return hm_route


def cvvdp_for(display, config_paths, **kw):
    """A metric on the card for ``display`` with ``config_paths``."""
    import colorvideovdp_tpu_torch as cvt

    return cvt.cvvdp(display_name=display, device="cuda", quiet=True,
                     config_paths=config_paths, **kw)


def sharded_configs(m, fps, V8, cfg_tmp, n_sp, gen, hm_route=None):
    """Phase 11's other configurations on the (1, n_sp) mesh, in one spawn of
    ``run_ranks`` (``run_jobs``): weber_g0_ref and log on one 8-frame block of
    the phase-3 content, a "raw" heatmap of a 1280x720 image, the generic
    chain (mult-transducer-texture) on a 1920x1080 image and a B = 2 FHD
    ``shard_loss_fn`` step; each against single-device scoring on the card
    (computed first in this process). ``hm_route``: the heatmap run's halo
    bands and each rank's gn rows, as ``phase_sharded`` held the D mode at
    them (the heatmap's route must match). Returns each path's launches,
    summed over the ranks."""
    import os

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.parallel import launch, run_ranks
    from colorvideovdp_tpu_torch.parallel import sharding as sh
    from colorvideovdp_tpu_torch.utils.config import write_parameters

    t0 = time.time()
    rng = np.random.RandomState(23)
    (hh, hw), (fh, fw) = SHARD_CFG_SIZES["hm"], SHARD_CFG_SIZES["fhd"]
    img = [rng.randint(0, 255, (hh, hw, 3), dtype=np.uint8) for _ in range(2)]
    fhd_ref = rng.randint(0, 255, (fh, fw, 3)).astype(np.int16)
    fhd = [np.clip(fhd_ref + rng.randn(fh, fw, 3) * 12, 0, 255).astype(np.uint8),
           fhd_ref.astype(np.uint8)]
    l_ref = rng.rand(2, 3, 1, fh, fw).astype(np.float32)
    l_test = np.clip(l_ref + rng.randn(*l_ref.shape).astype(np.float32) * 0.1, 0, 1)
    arrays = {"g0ref": V8, "log": V8, "hm": img, "tex": fhd, "train": (l_test, l_ref)}
    files = {}
    for name, pair in arrays.items():
        files[name] = [os.path.join(cfg_tmp, f"{name}_{i}.npy") for i in range(2)]
        for p, a in zip(files[name], pair):
            np.save(p, a)
    # The displays: the phase-3 clip's, phase 6's for the 720p image and
    # phase 5's for the FHD work (the PQ display's gradient is NaN where a
    # display-encoded value is exactly 0, single-device and sharded alike).
    specs = {
        "g0ref": dict(dim_order="BFCHW", fps=fps, contrast="weber_g0_ref",
                      display_name=m.display_name),
        "log": dict(dim_order="BFCHW", fps=fps, contrast="log", display_name=m.display_name),
        "hm": dict(dim_order="HWC", fps=0, heatmap="raw", display_name="standard_4k"),
        "tex": dict(dim_order="HWC", fps=0, masking_model="mult-transducer-texture",
                    display_name="standard_fhd"),
        "train": dict(loss=True, steps=3, display_name="standard_fhd"),
    }
    # Single-device references on the card.
    ref = {}
    for name, over in (("g0ref", {"contrast": "weber_g0_ref"}), ("log", {"contrast": "log"}),
                       ("tex", {"masking_model": "mult-transducer-texture"})):
        pair, sp = arrays[name], specs[name]
        mc = cvvdp_for(sp["display_name"],
                       write_parameters(os.path.join(cfg_tmp, f"single_{name}"), **over))
        ref[name] = float(mc.predict(*pair, dim_order=sp["dim_order"],
                                     frames_per_second=sp["fps"])[0])
    q_hm, st = cvvdp_for("standard_4k", None, heatmap="raw").predict(*img, dim_order="HWC")
    ref["hm"] = (float(q_hm), st["heatmap"].astype(np.float32))
    mt = cvvdp_for("standard_fhd", None)
    loss_fn, r_dev, step_s = mt.get_loss_fn(fh, fw), torch.from_numpy(l_ref).cuda(), []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(3):  # as the ranks: the first step cold, the last timed warm
        t = torch.from_numpy(l_test).cuda().requires_grad_()
        t1 = time.time()
        v = loss_fn(t, r_dev)
        v.backward()
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
    ref["train"] = (float(v.detach()), t.grad.cpu().numpy())
    log(f"phase 11: single-device B = 2 FHD step {[round(x, 4) for x in step_s]} s, peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB over what this process "
        "held before")
    del mt, t, v, loss_fn, r_dev
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 11: single-device references in {time.time() - t0:.1f} s: "
        + ", ".join(f"{k} {v if isinstance(v, float) else v[0]:.6f}" for k, v in ref.items()))

    jobs = [(sh.score_rank, (dict(test=files[k][0], reference=files[k][1], batch=1, **sp),))
            for k, sp in specs.items()]
    t0 = time.time()
    res = run_ranks(launch.run_jobs, n_sp, (jobs,), device="cuda", timeout_s=400)
    log(f"phase 11: the configurations' spawn in {time.time() - t0:.3f} s (set-up included)")
    out = {}
    labels = {"g0ref": "sharded_g0ref_4k_8f", "log": "sharded_log_4k_8f",
              "hm": "sharded_hm_720p_image", "tex": "sharded_tex_fhd_image",
              "train": "sharded_train_fhd"}
    want_k = {"g0ref": ("band_pooled_halo", "pyramid_reduce_slab"),
              "log": ("band_pooled_halo", "pyramid_reduce_slab"),
              "hm": ("band_pooled_d_halo", "pyramid_reduce_slab"),
              "tex": ("pyramid_reduce", "csf_lut", "blur"),
              "train": ("band_pooled_halo", "pyramid_reduce_slab", "csf_lut_bwd",
                        "blur_adjoint")}
    for j, name in enumerate(specs):
        rr_all = [r[j] for r in res]
        for rr in rr_all:
            for k in want_k[name]:
                if rr["launches"][k] <= 0:
                    raise AssertionError(f"{name} rank {rr['rank']}: kernel {k} was not launched")
            peak = rr["peak_bytes"] / 2**30
            if name == "train":
                d_loss = abs(rr["loss"] - ref["train"][0])
                log(f"phase 11: {name} rank {rr['rank']}: loss {rr['loss']:.6f} (|d| "
                    f"{d_loss:.2e}), steps {[round(x, 4) for x in rr['step_s']]} s, peak "
                    f"{peak:.2f} GiB, route {rr['route']}")
                if not d_loss <= LOSS_TOL:
                    raise AssertionError(f"sharded loss {rr['loss']} vs {ref['train'][0]}")
                continue
            jod = float(rr["jod"])
            want = ref[name][0] if name == "hm" else ref[name]
            extra = ""
            if name == "hm":
                route = rr["route"]
                if hm_route is not None and (
                        route["halo_bands"] != hm_route["halo_bands"]
                        or [tuple(x) for x in route["halo_gn_rows"]]
                        != hm_route["halo_gn_rows"][rr["s"]]):
                    raise AssertionError(f"hm rank {rr['rank']}: route {route}, the D mode was "
                                         f"held at {hm_route}")
                d_hm = float(np.abs(rr["heatmap"].astype(np.float32) - ref["hm"][1]).max())
                extra = f", heatmap max |d| {d_hm:.3e}"
                if not d_hm <= HEATMAP_TOL:
                    raise AssertionError(f"sharded heatmap differs by {d_hm}")
            log(f"phase 11: {name} rank {rr['rank']}: JOD {jod:.6f} (single-device {want:.6f}, "
                f"|d| {abs(jod - want):.2e}{extra}), block loop {rr['block_loop_s']:.3f} s, "
                f"peak {peak:.2f} GiB, route {rr['route']}")
            if not abs(jod - want) <= SHARD_JOD_TOL:
                raise AssertionError(f"{name}: sharded JOD {jod} vs single-device {want}")
        if name == "train":
            g1 = ref["train"][1]
            got = np.concatenate([r["grad"] for r in sorted(rr_all, key=lambda r: r["s"])], -2)
            d_g = float(np.abs(got - g1).max() / np.abs(g1).max())
            log(f"phase 11: train: gathered gradient max |d| / max |g| {d_g:.3e}")
            if not d_g <= SHARD_GRAD_TOL:
                raise AssertionError(f"sharded gradient differs by {d_g} of max |g|")
        out[labels[name]] = {k: sum(rr["launches"][k] for rr in rr_all)
                             for k in rr_all[0]["launches"]}
    return out


# The file route (phase 12): the .yuv pair's JOD with the kernels against
# plain, against the array route fed the port's own unpacked frames, and the
# per-frame route against the block route; the aux metrics on the card
# against the CPU.
FILE_JOD_TOL, UNPACK_JOD_TOL, FRAME_ROUTE_JOD_TOL = 1e-3, 1e-4, 1e-4
FILE_FRAMES = 12  # frames of the phase-3 clip in the 4K .yuv pair
AUX_DB_TOL, AUX_SSIM_TOL = 1e-4, 1e-5
# The kernels the file route launches (packed frames unpacked on the card go
# through ingest as float32 frames); the per-frame route skips ingest.
FILE_PATH = ("ingest", "pyramid_reduce", "band_pooled", "csf_lut")
INGEST_MODES = ("ingest", "ingest_replicate", "ingest_head")


def path_launches(launches, k):
    """A path's launches of kernel ``k``, where "ingest" counts the ingest
    kernel in every mode: a clip of one block takes only the first block's
    mode (replicate, or head with symmetric padding)."""
    return sum(launches[x] for x in INGEST_MODES) if k == "ingest" else launches[k]
FRAME_PATH = ("pyramid_reduce", "band_pooled", "csf_lut")


def write_yuv(dirname, tag, V, fps):
    """A 10-bit 4:2:0 BT.2020 limited-range .yuv file of uint8
    display-encoded (H, W, 3, N) RGB, each chroma sample the mean of its 2x2
    block, named by ``create_yuv_fname``. Returns its path."""
    import os

    from colorvideovdp_tpu_torch.io.ffcodec import rgb_to_ycbcr_coeffs
    from colorvideovdp_tpu_torch.io.yuv import create_yuv_fname

    H, W, _, N = V.shape
    rows = [c.astype(np.float32) for c in rgb_to_ycbcr_coeffs("2020")]
    name = os.path.join(dirname, create_yuv_fname(tag, dict(
        width=W, height=H, fps=fps, bit_depth=10, chroma_ss="420", color_space="2020")))
    with open(name, "wb") as f:
        for i in range(N):
            rgb = V[:, :, :, i].astype(np.float32) / 255.0
            planes = [rgb @ rows[0] * 219.0 + 16.0]
            for row in rows[1:]:
                c = (rgb @ row).reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
                planes.append(c * 224.0 + 128.0)
            for plane in planes:
                np.clip(np.round(plane * 4.0), 0, 1023).astype("<u2").tofile(f)
    return name


def write_yuv_pair(dirname, V_test, V_ref, fps):
    """``write_yuv`` of the test and the reference. Returns the (test,
    reference) paths."""
    return [write_yuv(dirname, tag, V, fps) for tag, V in (("test", V_test), ("ref", V_ref))]


def phase_files(V_test, V_ref, fps, counters, smi, tmp):
    """Phase 12: file sources, written to ``tmp``. Returns the launches per
    path and the files for phase 13: the 4K pair, the FHD pair and the aux
    metrics' values on the 4K pair."""
    import os

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file

    t_phase = time.time()
    H, W, _, N = V_ref.shape
    paths = {}
    aux = {}

    def run(m, vs):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.time()
        Q, st = m.predict_video_source(vs)
        jod = float(Q)
        torch.cuda.synchronize()
        return jod, st, time.time() - t0, {k: fn.launches for k, fn in counters.items()}

    def expect(name, launches, path, off=()):
        for k in path:
            if path_launches(launches, k) <= 0:
                raise AssertionError(f"phase 12: kernel {k} was not launched on {name}")
        for k in off:
            if launches[k] != 0:
                raise AssertionError(f"phase 12: {k} launched on {name}: {launches}")

    t0 = time.time()
    names = write_yuv_pair(tmp, V_test, V_ref, fps)
    log(f"phase 12: 10-bit 4:2:0 BT.2020 .yuv pair, {N} frames of {W}x{H} "
        f"({os.path.getsize(names[0]) / 1e6:.1f} MB a file), written in "
        f"{time.time() - t0:.1f} s")
    res = {}
    # In turns, kernels first: the first run also pays one-time set-up
    # (the matrix-product library, the LUT tables).
    for turn, fused in enumerate((True, False, True)):
        m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
        m.enable_fused_kernels = fused
        vs = video_source_file(*names, display_photometry="standard_hdr_pq")
        jod, st, dt, launches = run(m, vs)
        res[fused] = (jod, st["block_N_frames"], launches, dt)
        if fused:
            paths["files_4k_yuv"] = launches
        log(f"phase 12: .yuv {'kernels' if fused else 'plain  '} (turn {turn + 1}): JOD "
            f"{jod:.6f}, blk {st['block_N_frames']}, wall {dt:.3f} s = {N / dt:.2f} "
            f"frames/s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({smi}), launches { {k: v for k, v in launches.items() if v} }")
    (jod_k, blk, launches, dt_k), jod_p = res[True], res[False][0]
    from colorvideovdp_tpu_torch.tools.path_times import profile_device

    m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    prof, busy, wall = profile_device(lambda: m.predict_video_source(
        video_source_file(*names, display_photometry="standard_hdr_pq")))
    log(f"phase 12: profiled file route {wall:.3f} s, device busy {busy:.3f} ms "
        f"({100 * busy / (1e3 * wall):.1f}%), by kernel:")
    for ms, count, name in prof[:8]:
        log(f"  {ms:9.3f} ms {count:5d}x  {name[:100]}")
    expect("the file route", launches, FILE_PATH)
    if not (math.isfinite(jod_k) and abs(jod_k - jod_p) <= FILE_JOD_TOL):
        raise AssertionError(f"phase 12: .yuv JOD kernels {jod_k} vs plain {jod_p}")
    # One block's host read and unpack on the card, against the block.
    m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    vs = video_source_file(*names, display_photometry="standard_hdr_pq")
    t0 = time.time()
    packed = vs.get_raw_block("test", 0, blk)
    t_read = time.time() - t0
    t0 = time.time()
    x = m._upload(packed)
    torch.cuda.synchronize()
    t_up = time.time() - t0
    unpack_ms = time_ms(lambda: vs.unpack_raw_block(x))
    unpack_dev = device_ms(lambda: vs.unpack_raw_block(x), reps=3)
    n_blocks = math.ceil(N / blk)
    block_ms, block_dev = 1e3 * dt_k / n_blocks, busy / n_blocks
    log(f"phase 12: one {blk}-frame block of one file: host read {1e3 * t_read:.1f} ms, "
        f"upload {1e3 * t_up:.1f} ms, unpack on the card {unpack_ms:.3f} ms, device "
        f"{unpack_dev:.3f} ms ({unpack_ms / blk:.3f} ms a frame); both files' unpack "
        f"{2 * unpack_ms:.3f} ms = {100 * 2 * unpack_ms / block_ms:.1f}% of the "
        f"{block_ms:.1f} ms a block of the kernels' wall time, device "
        f"{100 * 2 * unpack_dev / block_dev:.1f}% of the block's {block_dev:.3f} ms "
        f"({smi})")
    del x, packed
    # The array route fed the port's own unpacked float32 RGB.
    rgb = [vs.unpack_raw_block(m._upload(vs.get_raw_block(s, 0, N))).cpu().numpy()
           for s in ("test", "reference")]
    jod_a, _, dt_a, _ = run(m, cvt.video_source_array(
        rgb[0], rgb[1], fps, dim_order="BCFHW", display_photometry="standard_hdr_pq"))
    del rgb
    log(f"phase 12: array route on the unpacked frames: JOD {jod_a:.6f} ({dt_a:.3f} s), "
        f"|JOD - file route| {abs(jod_a - jod_k):.2e} (tolerance {UNPACK_JOD_TOL:.0e})")
    if not abs(jod_a - jod_k) <= UNPACK_JOD_TOL:
        raise AssertionError(f"phase 12: unpacked array route {jod_a} vs file route {jod_k}")

    # FHD: 8 frames at 24 fps (a crop of the same content).
    fhd = write_yuv_pair(tmp, V_test[:1080, :1920, :, :8], V_ref[:1080, :1920, :, :8], 24)
    vs4 = video_source_file(*fhd, display_photometry="standard_hdr_pq", frames=4)
    jods = {}
    for route, src in (("block", vs4), ("per-frame", FrameByFrame(vs4))):
        m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
        jods[route], _, dt, launches = run(m, src)
        paths[f"files_fhd_{route}"] = launches
        log(f"phase 12: FHD 4 frames, {route} route: JOD {jods[route]:.6f} ({dt:.3f} s), "
            f"launches { {k: v for k, v in launches.items() if v} }")
    expect("the per-frame route", paths["files_fhd_per-frame"], FRAME_PATH,
           off=("ingest", "ingest_replicate", "ingest_head"))
    if not abs(jods["block"] - jods["per-frame"]) <= FRAME_ROUTE_JOD_TOL:
        raise AssertionError(f"phase 12: per-frame route {jods['per-frame']} vs block "
                             f"route {jods['block']}")
    vs8 = video_source_file(*fhd, display_photometry="standard_hdr_pq")
    res = {}
    for fused in (True, False):
        m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                      temp_resample=True)
        m.enable_fused_kernels = fused
        jod, st, dt, launches = run(m, vs8)
        res[fused] = jod
        if fused:
            paths["files_fhd_temp_resample"] = launches
            expect("temp_resample", launches, FILE_PATH)
        if st["N_frames"] != math.ceil(8 / 24 * m.nominal_fps):
            raise AssertionError(f"phase 12: temp_resample gave {st['N_frames']} frames")
        log(f"phase 12: FHD 8 frames at 24 fps, temp_resample to {m.nominal_fps} fps "
            f"({st['N_frames']} frames) {'kernels' if fused else 'plain  '}: JOD {jod:.6f} "
            f"({dt:.3f} s)")
    if not abs(res[True] - res[False]) <= FILE_JOD_TOL:
        raise AssertionError(f"phase 12: temp_resample kernels {res[True]} vs plain "
                             f"{res[False]}")

    # The aux metrics: the 4K pair on the card, then 2 frames on the card
    # against the CPU.
    vs2 = video_source_file(*names, display_photometry="standard_hdr_pq", frames=2)
    for cls, tol in ((cvt.psnr_rgb, AUX_DB_TOL), (cvt.pu_psnr_y, AUX_DB_TOL),
                     (cvt.pu_psnr_rgb2020, AUX_DB_TOL), (cvt.ssim_metric, AUX_SSIM_TOL)):
        metric = cls(display_name="standard_hdr_pq")
        torch.cuda.synchronize()
        t0 = time.time()
        q, _ = metric.predict_video_source(video_source_file(
            *names, display_photometry="standard_hdr_pq"))
        q = float(q.reshape(-1)[0])
        dt = time.time() - t0
        aux[metric.short_name()] = q
        q2 = float(metric.predict_video_source(vs2)[0].reshape(-1)[0])
        t0 = time.time()
        q2_cpu = float(cls(display_name="standard_hdr_pq", device="cpu")
                       .predict_video_source(vs2)[0].reshape(-1)[0])
        dt_cpu = time.time() - t0
        log(f"phase 12: {metric.short_name()}: {q:.6f} on {N} frames of {W}x{H} in {dt:.3f} s "
            f"= {N / dt:.2f} frames/s ({smi}); 2 frames {q2:.6f}, on the CPU {q2_cpu:.6f} "
            f"({dt_cpu:.1f} s), difference {abs(q2 - q2_cpu):.2e} (tolerance {tol:.0e})")
        if not (math.isfinite(q) and abs(q2 - q2_cpu) <= tol):
            raise AssertionError(f"phase 12: {metric.short_name()} card vs CPU")
    log(f"phase 12: {time.time() - t_phase:.1f} s")
    return paths, {"4k": names, "fhd": fhd, "aux": aux}


# The file-driven entry points (phase 13): the CLI, its heatmap, the channel
# dumps, the previews and the clip-list runner on phase 12's files. The
# CLI's CSV against the API on the same files (the CLI's temporal padding,
# symmetric), the aux metrics against phase 12's, kernels against plain.
CLI_JOD_TOL, CLI_PLAIN_TOL = 1e-4, 1e-3
DUMP_CODE_TOL = 1  # dumped 8-bit frames, kernels against plain
# The kernels a heatmap and the dumps launch (the D route).
D_PATH = ("ingest", "pyramid_reduce", "band_pooled_d", "csf_lut")
OPTIONAL_MODULES = ("cv2", "imageio", "PIL", "matplotlib")


def optional_imports():
    """{module: whether it imports} for the writers' optional back ends."""
    import importlib

    have = {}
    for name in OPTIONAL_MODULES:
        try:
            importlib.import_module(name)
            have[name] = True
        except ImportError:
            have[name] = False
    return have


def video_frames(path):
    """(frame count, height, width) of a written video: an .mp4 decoded with
    OpenCV, a .y4m from its header and frame markers."""
    if path.endswith(".y4m"):
        with open(path, "rb") as f:
            header = f.readline().split()
            data = f.read()
        tags = {t[:1]: t[1:] for t in header[1:]}
        W, H = int(tags[b"W"]), int(tags[b"H"])
        size = (H * W + 2 * (H // 2) * (W // 2)) * (2 if b"p10" in tags[b"C"] else 1)
        if len(data) % (6 + size) or data[:6] != b"FRAME\n":
            raise AssertionError(f"{path}: not a 4:2:0 YUV4MPEG2 stream")
        return len(data) // (6 + size), H, W
    frames = decode_mp4(path)
    return len(frames), *frames[0].shape[:2]


def decode_mp4(path):
    """Every frame of an .mp4 (OpenCV), as BGR uint8 arrays."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


@contextlib.contextmanager
def plain_cvvdp():
    """The CLI's "cvvdp" with its kernels off (``enable_fused_kernels =
    False``: the plain versions on the card) while the block runs."""
    from colorvideovdp_tpu_torch.metrics.base import vq_metric_dict
    from colorvideovdp_tpu_torch.metrics.cvvdp import cvvdp

    class cvvdp_plain(cvvdp):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.enable_fused_kernels = False

    vq_metric_dict["cvvdp"] = cvvdp_plain
    try:
        yield
    finally:
        vq_metric_dict["cvvdp"] = cvvdp


@contextlib.contextmanager
def recorded_dumps(frames):
    """The channel dumps' video writers also keep each frame they are given,
    in ``frames`` by file stem."""
    import os

    from colorvideovdp_tpu_torch import dump_channels

    writer = dump_channels.VideoWriter

    class Tee(writer):
        def __init__(self, fname, **kw):
            super().__init__(fname, **kw)
            self.stem = os.path.splitext(os.path.basename(fname))[0]
            frames[self.stem] = []

        def write_frame_rgb(self, rgb):
            frames[self.stem].append(np.array(rgb))
            super().write_frame_rgb(rgb)

    dump_channels.VideoWriter = Tee
    try:
        yield
    finally:
        dump_channels.VideoWriter = writer


def phase_cli(files, fps, counters, smi, tmp, have):
    """Phase 13: the port's entry points on phase 12's files. Returns the
    launches per path."""
    import contextlib as cl
    import csv
    import glob
    import os

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch import cli
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file
    from colorvideovdp_tpu_torch.io.writers import np2vid
    from colorvideovdp_tpu_torch.tools import run_cluster

    t_phase = time.time()
    log("phase 13: optional modules: " + ", ".join(
        f"{k} {'imports' if v else 'absent'}" for k, v in have.items()))
    names, fhd = files["4k"], files["fhd"]
    stem4k, stemfhd = (os.path.splitext(os.path.basename(p[0]))[0] for p in (names, fhd))
    (H, W, N), (Hf, Wf, Nf) = (video_source_file(*p).get_video_size() for p in (names, fhd))
    fps_fhd = video_source_file(*fhd).get_frames_per_second()
    hdr = ["--display", "standard_hdr_pq"]
    paths, walls = {}, {}

    def launched():
        return {k: fn.launches for k, fn in counters.items()}

    def run_cli(argv):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        cli.run_on_args(cli.parse_args(argv))
        torch.cuda.synchronize()
        return time.time() - t0, launched()

    def expect(name, launches, path):
        for k in path:
            if path_launches(launches, k) <= 0:
                raise AssertionError(f"phase 13: kernel {k} was not launched on {name}")

    def read_csv(path):
        with open(path, newline="") as f:
            rows = [[c.strip() for c in r] for r in csv.reader(f)]
        return dict(zip(rows[0][2:], (float(v) for v in rows[1][2:])))

    def api(pair, **kw):
        """(JOD, stats, scoring seconds, metric) through video_source_file and
        predict_video_source with the CLI's temporal padding."""
        m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                      temp_padding="symmetric", **kw)
        vs = video_source_file(*pair, display_photometry="standard_hdr_pq")
        torch.cuda.synchronize()
        t0 = time.time()
        Q, st = m.predict_video_source(vs)
        jod = float(Q)
        torch.cuda.synchronize()
        return jod, st, time.time() - t0, m

    # The CLI in-process on the 4K pair, with the kernels and plain.
    jod_api, st_api, _, m_api = api(names)
    m_api.write_features_to_json(st_api, os.path.join(tmp, "api_fmap.json"))
    with open(os.path.join(tmp, "api_fmap.json")) as f:
        api_keys = sorted(json.load(f))
    res = {}
    for fused in (True, False):
        out = os.path.join(tmp, f"cli_{int(fused)}")
        csv_path = out + ".csv"
        argv = ["-t", *names[:1], "-r", names[1], *hdr, "-m", "cvvdp", "pu-psnr-y",
                "ssim-metric", "--result", csv_path, "--features", "-o", out]
        with cl.nullcontext() if fused else plain_cvvdp():
            walls[f"cli {'kernels' if fused else 'plain'}"], launches = run_cli(argv)
        res[fused] = read_csv(csv_path)
        if fused:
            paths["cli_4k_yuv"] = launches
            expect("the CLI", launches, FILE_PATH)
            with open(os.path.join(out, f"{stem4k}_fmap.json")) as f:
                if sorted(json.load(f)) != api_keys:
                    raise AssertionError("phase 13: the CLI's features are not the API's keys")
        elif any(path_launches(launches, k) for k in FILE_PATH):
            raise AssertionError(f"phase 13: the plain CLI run launched kernels: {launches}")
    q = res[True]
    log(f"phase 13: CLI on the 4K pair: {q} (kernels {walls['cli kernels']:.3f} s, plain "
        f"{walls['cli plain']:.3f} s); API JOD {jod_api:.6f}; phase 12's PU21-PSNR-Y "
        f"{files['aux']['PU21-PSNR-Y']:.6f}, SSIM {files['aux']['SSIM']:.6f}")
    if not abs(q["cvvdp"] - jod_api) <= CLI_JOD_TOL:
        raise AssertionError(f"phase 13: CLI JOD {q['cvvdp']} vs the API's {jod_api}")
    if not abs(q["cvvdp"] - res[False]["cvvdp"]) <= CLI_PLAIN_TOL:
        raise AssertionError(f"phase 13: CLI kernels {q['cvvdp']} vs plain {res[False]['cvvdp']}")
    if not (abs(q["PU21-PSNR-Y"] - files["aux"]["PU21-PSNR-Y"]) <= AUX_DB_TOL
            and abs(q["SSIM"] - files["aux"]["SSIM"]) <= AUX_SSIM_TOL):
        raise AssertionError(f"phase 13: the CLI's aux metrics {q} vs phase 12's {files['aux']}")

    # The console entry point, a process of its own, timed from its start.
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "colorvideovdp_tpu_torch.cli", "-t", names[0],
                           "-r", names[1], *hdr, "-q"], capture_output=True, text=True,
                          cwd=root, env=dict(os.environ, PYTHONPATH=root), timeout=600)
    walls["console"] = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 13: the console entry point failed: {proc.stderr[-2000:]}")
    printed = proc.stdout.split()
    log(f"phase 13: python -m colorvideovdp_tpu_torch.cli -q printed {printed} in "
        f"{walls['console']:.3f} s from the process's start ({smi})")
    if printed != [f"{q['cvvdp']:.4f}"]:
        raise AssertionError(f"phase 13: the console printed {printed}, the CLI {q['cvvdp']}")

    # The heatmap through the CLI, in one block on both sides, and the API's
    # heatmap written by np2vid (gpu_mem on the heatmap's route).
    m_api.do_heatmap = True
    gpu_mem = m_api.block_gpu_mem(H * W, N, fps)
    out = os.path.join(tmp, "cli_heatmap")
    walls["cli heatmap"], launches = run_cli(
        ["-t", names[0], "-r", names[1], *hdr, "--heatmap", "supra-threshold", "--gpu-mem",
         str(gpu_mem), "-o", out])
    paths["cli_heatmap_4k_yuv"] = launches
    expect("the CLI's heatmap", launches, D_PATH)
    (written,) = glob.glob(os.path.join(out, f"{stem4k}_heatmap.*"))
    n, h, w = video_frames(written)
    if (n, h, w) != (N, H, W):
        raise AssertionError(f"phase 13: {written} holds {n} frames of {w}x{h}")
    _, st, walls["api heatmap scoring"], _ = api(names, heatmap="supra-threshold",
                                                 gpu_mem=gpu_mem)
    if st["block_N_frames"] != N:
        raise AssertionError(f"phase 13: heatmap blocks of {st['block_N_frames']} frames")
    t0 = time.time()
    frames = np.asarray(st["heatmap"], np.float32)[0].transpose(1, 2, 3, 0)
    api_file = np2vid(frames, os.path.join(tmp, "api_heatmap.mp4"), fps)
    walls["heatmap writing"] = time.time() - t0
    if os.path.splitext(api_file)[1] != os.path.splitext(written)[1]:
        raise AssertionError(f"phase 13: the CLI wrote {written}, np2vid {api_file}")
    with open(written, "rb") as f, open(api_file, "rb") as g:
        same_bytes = f.read() == g.read()
    log(f"phase 13: CLI heatmap {os.path.basename(written)}: {n} frames of {w}x{h}, "
        f"{'the same bytes' if same_bytes else 'OTHER BYTES'} as np2vid of the API's heatmap; "
        f"CLI {walls['cli heatmap']:.3f} s, API scoring {walls['api heatmap scoring']:.3f} s, "
        f"writing {N} frames {walls['heatmap writing']:.3f} s (the transpose and np2vid on "
        "the host)")
    if not same_bytes:
        raise AssertionError("phase 13: the CLI's heatmap is not np2vid of the API's")
    del st, frames

    # The channel dumps on the FHD pair (one block), kernels and plain.
    jod_fhd, _, _, m_fhd = api(fhd)
    # Dumps take the heatmap's D route and its block model.
    m_fhd.do_heatmap = True
    gpu_mem = m_fhd.block_gpu_mem(Hf * Wf, Nf, fps_fhd)
    dumped, jods = {}, {}
    for fused in (True, False):
        out = os.path.join(tmp, f"dumps_{int(fused)}")
        dumped[fused] = {}
        argv = ["-t", fhd[0], "-r", fhd[1], *hdr, "--dump-channels", "temporal", "lpyr",
                "difference", "--gpu-mem", str(gpu_mem), "--result", out + ".csv", "-o", out]
        with cl.nullcontext() if fused else plain_cvvdp(), recorded_dumps(dumped[fused]):
            walls[f"dumps {'kernels' if fused else 'plain'}"], launches = run_cli(argv)
        jods[fused] = read_csv(out + ".csv")["cvvdp"]
        for stem in ("temp_channels", "lpyr", "diff"):
            (f,) = glob.glob(os.path.join(out, stem + ".*"))
            n, h, w = video_frames(f)
            if n != Nf or len(dumped[fused][stem]) != Nf:
                raise AssertionError(f"phase 13: {f} holds {n} frames")
        if fused:
            paths["cli_dumps_fhd_yuv"] = launches
            expect("the dumps", launches, D_PATH)
    d_code = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                 for stem in dumped[True] for a, b in zip(dumped[True][stem], dumped[False][stem]))
    log(f"phase 13: dumps of the FHD pair: JOD {jods[True]:.6f} (plain {jods[False]:.6f}), "
        f"pooled-only {jod_fhd:.6f}; dumped frames kernels against plain within {d_code} code "
        f"values; {walls['dumps kernels']:.3f} s with the kernels, {walls['dumps plain']:.3f} s "
        "plain")
    if not (abs(jods[True] - jod_fhd) <= CLI_JOD_TOL and d_code <= DUMP_CODE_TOL):
        raise AssertionError("phase 13: the dumps disagree")
    del dumped

    # The previews on the FHD pair's first 2 frames.
    out = os.path.join(tmp, "previews")
    walls["previews"], _ = run_cli(["-t", fhd[0], "-r", fhd[1], *hdr, "--nframes", "2", "-m",
                                    "dm-preview", "dm-preview-exr", "-o", out])
    from colorvideovdp_tpu_torch.utils import exr

    for side in ("test", "reference"):
        (f,) = glob.glob(os.path.join(out, f"{stemfhd}-{side}.*"))
        if video_frames(f) != (2, Hf, Wf):
            raise AssertionError(f"phase 13: {f} holds {video_frames(f)}")
        for ff in range(2):
            img = exr.read(os.path.join(out, f"{stemfhd}-{ff:04d}-{side}.exr"))
            if img.shape != (Hf, Wf, 3) or not np.isfinite(img).all():
                raise AssertionError(f"phase 13: preview frame {ff} of {side}: {img.shape}")
    log(f"phase 13: dm-preview wrote {sorted(os.listdir(out))} in {walls['previews']:.3f} s")

    if have["matplotlib"]:
        out = os.path.join(tmp, "distogram")
        run_cli(["-t", fhd[0], "-r", fhd[1], *hdr, "--distogram", "-o", out])
        if not os.path.getsize(os.path.join(out, f"{stemfhd}_distogram.png")):
            raise AssertionError("phase 13: no distogram")
    else:
        log("phase 13: matplotlib does not import here, so --distogram is not run on the "
            "card (the CPU tests write one)")

    # The clip-list runner: two workers, a resume, a merge.
    clips = os.path.join(tmp, "clips.csv")
    missing = os.path.join(tmp, os.path.basename(fhd[0]).replace("test", "missing"))
    with open(clips, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["test", "reference", "display", "tag"])
        wr.writerows([[*names, "standard_hdr_pq", "4k"], [*fhd, "", "fhd"],
                      [missing, fhd[1], "", "missing"]])
    result = os.path.join(tmp, "scores.csv")
    common = ["--list", clips, "--result", result, "--display", "standard_hdr_pq"]
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    for argv in (["--worker", "0/2"], ["--worker", "1/2"], ["--worker", "0/2", "--resume"]):
        run_cluster.main(common + argv)
    run_cluster.main(["--merge", "--result", result, "--nshards", "2"])
    torch.cuda.synchronize()
    walls["runner"] = time.time() - t0
    paths["run_cluster"] = launched()
    expect("the runner", paths["run_cluster"], FILE_PATH)
    with open(result, newline="") as f:
        rows = {r["tag"]: r["Q_JOD"] for r in csv.DictReader(f)}
    log(f"phase 13: runner rows {rows} in {walls['runner']:.3f} s")
    if sorted(rows) != ["4k", "fhd", "missing"] or rows["missing"] != "error":
        raise AssertionError(f"phase 13: runner rows {rows}")
    if not (abs(float(rows["4k"]) - jod_api) <= CLI_JOD_TOL
            and abs(float(rows["fhd"]) - jod_fhd) <= CLI_JOD_TOL):
        raise AssertionError(f"phase 13: runner rows {rows} vs the API {jod_api}, {jod_fhd}")

    log("phase 13: wall times " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f" ({smi})")
    log(f"phase 13: {time.time() - t_phase:.1f} s")
    return paths


# Calibration on the card (phase 14): a seeded rated dataset, feature
# extraction by two workers and a resume, the features against the API,
# the refit on the card and on the CPU, and the ML checkpoint converter.
CALIB_PATH = FILE_PATH
CALIB_H, CALIB_W, CALIB_N, CALIB_FPS = 1080, 1920, 8, 30.0
CALIB_SIGMAS = (2.0, 6.0, 14.0)  # noise levels (8-bit code values) of the distortions
CALIB_EPOCHS = 30
CALIB_PLAIN_JOD_TOL = 1e-3  # a pair's JOD from plain features against the kernels'
CALIB_FIT_TOL = 1e-5  # every fitted float, the card's refit against the CPU's
CALIB_CONFIG_JOD_TOL = 1e-4  # the fitted config's JOD against the trainer's prediction


def write_calib_dataset(d):
    """Phase 14's rated dataset in ``d``: for each of 3 contents a FHD
    10-bit 4:2:0 BT.2020 PQ .yuv reference (a gradient with a sinusoidal
    texture, 8 static frames at 30 fps) and 3 tests with one dynamic noise
    field at growing strength on standard_hdr_pq, and one sRGB PNG pair on
    standard_fhd; the CSV with its header (per-row display, split by
    content, 67 % train, seed 0). Returns the CSV path and its rows
    (test, reference, jod, display, content)."""
    import os

    import cv2

    H, W, N = CALIB_H, CALIB_W, CALIB_N
    rng = np.random.default_rng(14)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rows = []
    for c in range(3):
        tex = np.sin(xx / (6.0 + 4 * c)) * np.cos(yy / (9.0 + 3 * c))
        ref = np.stack([0.15 + 0.5 * xx / W + 0.1 * c + k * tex
                        for k in (0.06, 0.04, 0.08)], axis=-1)
        ref = np.clip(np.round(ref * 255), 0, 255).astype(np.uint8)
        V_ref = np.repeat(ref[..., None], N, axis=3)
        ref_name = os.path.basename(write_yuv(d, f"c{c}_ref", V_ref, CALIB_FPS))
        # One noise field a content, scaled to each level.
        noise = rng.standard_normal((H, W, 3, N), dtype=np.float32)
        for lvl, sigma in enumerate(CALIB_SIGMAS):
            V_test = np.clip(V_ref + np.round(noise * sigma), 0, 255).astype(np.uint8)
            test_name = os.path.basename(write_yuv(d, f"c{c}_d{lvl}", V_test, CALIB_FPS))
            rows.append((test_name, ref_name, round(9.6 - 1.3 * lvl - 0.25 * c, 2),
                         "standard_hdr_pq", f"c{c}"))
        noise = rng.standard_normal((H, W, 3), dtype=np.float32) * (4.0 + 4 * c)
        img = np.clip(ref + np.round(noise), 0, 255).astype(np.uint8)
        for tag, I in (("test", img), ("ref", ref)):
            cv2.imwrite(os.path.join(d, f"c{c}_img_{tag}.png"), I[..., ::-1],
                        [cv2.IMWRITE_PNG_COMPRESSION, 1])
        rows.append((f"c{c}_img_test.png", f"c{c}_img_ref.png", round(8.8 - 0.4 * c, 2),
                     "standard_fhd", f"c{c}"))
    csv = os.path.join(d, "ratings.csv")
    with open(csv, "w") as f:
        f.write("display: per-row\nsplit-column: content\ntrain-ratio: 67\nseed: 0\n")
        f.write("test,reference,jod,display,content\n")
        f.writelines(",".join(map(str, r)) + "\n" for r in rows)
    return csv, rows


def phase_calib(counters, smi):
    """Phase 14: calibration on the card. Returns the extraction's launches
    (the in-process worker's) as the ``calib`` path."""
    import glob
    import os

    import pandas as pd

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.calibration import data, extract_features, train
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file
    from colorvideovdp_tpu_torch.tools import convert_ml_ckpt

    t_phase = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    d = tempfile.mkdtemp(prefix="cvvdp_calib_")
    try:
        t0 = time.time()
        csv, rows = write_calib_dataset(d)
        log(f"phase 14: {len(rows)} rated pairs ({3 * len(CALIB_SIGMAS)} FHD {CALIB_N}-frame "
            f".yuv, {os.path.getsize(os.path.join(d, rows[0][0])) / 1e6:.1f} MB a file; 3 FHD "
            f"PNG) written in {time.time() - t0:.1f} s")
        # The split of the JAX scripts: numpy's permutation of the contents
        # under seed 0, the first 67 % train.
        contents = list(dict.fromkeys(r[4] for r in rows))
        train_cond = set(np.random.RandomState(0).permutation(contents)[: 3 * 67 // 100])
        want = {os.path.join("train" if r[4] in train_cond else "test",
                             os.path.splitext(r[0])[0] + "_fmap.json") for r in rows}
        feats = os.path.join(d, "features")

        def written():
            return {os.path.relpath(f, feats): os.stat(f).st_mtime_ns
                    for f in glob.glob(os.path.join(feats, "*", "*_fmap.json"))}

        # Worker 1 of 2 in-process, its launches counted; worker 2 of 2 in
        # a process of its own; then a resume of the whole list.
        argv = [csv, "-p", d]
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.chdir(d):
            extract_features.main(argv + ["-w", "1/2"])
        torch.cuda.synchronize()
        t_w1 = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        n_w1 = len(range(0, len(rows), 2))
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m",
                               "colorvideovdp_tpu_torch.calibration.extract_features", *argv,
                               "-w", "2/2"], cwd=d, env=dict(os.environ, PYTHONPATH=root),
                              capture_output=True, text=True, timeout=300)
        t_w2 = time.time() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 14: worker 2/2 failed: {proc.stderr[-3000:]}")
        before = written()
        for fn in counters.values():
            fn.launches = 0
        with contextlib.chdir(d):
            extract_features.main(argv + ["--resume"])
        resumed = {k: fn.launches for k, fn in counters.items() if fn.launches}
        vs = video_source_file(*(os.path.join(d, n) for n in rows[0][:2]),
                               display_photometry=rows[0][3])
        t0 = time.time()
        for side in ("test", "reference"):
            vs.get_raw_block(side, 0, CALIB_N)
        t_read = time.time() - t0
        log(f"phase 14: extraction worker 1/2 in-process {t_w1:.3f} s for {n_w1} pairs "
            f"({t_w1 / n_w1:.3f} s a pair, the metric's set-up included); worker 2/2 as "
            f"python -m {t_w2:.3f} s for {len(rows) - n_w1} pairs from the process's start; "
            f"launches of worker 1/2 { {k: v for k, v in launches.items() if v} }; host read of "
            f"one .yuv pair's {CALIB_N} packed frames {1e3 * t_read:.1f} ms ({smi})")
        for k in CALIB_PATH:
            if path_launches(launches, k) <= 0:
                raise AssertionError(f"phase 14: kernel {k} was not launched by the extraction")
        if set(before) != want:
            raise AssertionError(f"phase 14: feature files {sorted(before)}, want {sorted(want)}")
        if written() != before or resumed:
            raise AssertionError(f"phase 14: --resume rewrote files or launched {resumed}")
        log(f"phase 14: the two workers wrote the {len(want)} rows' features, "
            f"{sum(f.startswith('train') for f in want)} train (contents "
            f"{sorted(map(str, train_cond))}); --resume rewrote none")

        # The features against the API, bit for bit; one video and one
        # image row plain.
        def api(r, fused=True):
            display = r[3]
            geom = cvt.vvdp_display_geometry.load(display)
            m = cvt.cvvdp(display_name=display, device="cuda", quiet=True,
                          temp_padding="replicate")
            m.enable_fused_kernels = fused
            vs = video_source_file(os.path.join(d, r[0]), os.path.join(d, r[1]),
                                   display_photometry=display, resize_resolution=geom.resolution)
            _, st = m.predict_video_source(vs)
            return m, np.asarray(st["Q_per_ch"])

        # The features as the trainer reads them (float32, exactly the
        # JSON's values), by test file.
        table = pd.read_csv(csv, skiprows=4)
        feat = {}
        for split in ("train", "test"):
            sub = table[table["content"].isin(train_cond) == (split == "train")]
            ds = data.VideoDataset(feats, sub, split, False)
            feat.update((t, ds[i][0]) for i, t in enumerate(sub["test"]))

        t0 = time.time()
        for r in rows:
            _, Q = api(r)
            if not np.array_equal(feat[r[0]], Q):
                raise AssertionError(f"phase 14: the features of {r[0]} are not the API's "
                                     f"Q_per_ch (max |d| {np.abs(feat[r[0]] - Q).max()})")
        t_api = time.time() - t0
        msgs = []
        for r in (rows[0], rows[3]):
            Q = feat[r[0]]
            m, Q_p = api(r, fused=False)
            jk, jp = (float(m.do_pooling_and_jods(torch.as_tensor(q, dtype=torch.float32,
                                                                  device=m.device)))
                      for q in (Q, Q_p))
            rel = float(np.abs(Q.astype(np.float64) - Q_p).max() / np.abs(Q_p).max())
            msgs.append(f"{r[0]}: JOD kernels {jk:.6f} plain {jp:.6f}, max relative feature "
                        f"difference {rel:.3e}")
            if not abs(jk - jp) <= CALIB_PLAIN_JOD_TOL:
                raise AssertionError(f"phase 14: {r[0]}: JOD kernels {jk} vs plain {jp}")
        log(f"phase 14: every row's features are the API's Q_per_ch bit for bit ({len(rows)} "
            f"pairs scored again in {t_api:.3f} s); " + "; ".join(msgs))

        # The refit on the card and on the CPU, on the same features.
        fits = {}
        for device in ("cuda", "cpu"):
            for fn in counters.values():
                fn.launches = 0
            t0 = time.time()
            with contextlib.chdir(d):
                fits[device] = train.main([csv, "-e", str(CALIB_EPOCHS), "-b", "2", "--save",
                                           "best-rmse", "-o", os.path.join(d, f"fitted_{device}"),
                                           "--device", device])
            wall = time.time() - t0
            ran = {k: fn.launches for k, fn in counters.items() if fn.launches}
            ep = fits[device]["epoch_s"]
            log(f"phase 14: refit on {device}: {CALIB_EPOCHS} epochs in {wall:.3f} s, "
                f"{1e3 * float(np.median(ep)):.3f} ms per epoch (median; min "
                f"{1e3 * min(ep):.3f}, max {1e3 * max(ep):.3f}), kernel launches {ran}")
            if ran:
                raise AssertionError(f"phase 14: the refit launched kernels: {ran}")
        cfg = {}
        for device, fit in fits.items():
            with open(fit["config"]) as f:
                cfg[device] = {k: np.asarray(v, np.float64) for k, v in json.load(f).items()
                               if k not in ("__comment", "calibration_date")
                               and not isinstance(v, (str, int))}
        if sorted(cfg["cuda"]) != sorted(cfg["cpu"]):
            raise AssertionError("phase 14: the fitted configs hold other keys")
        d_fit = max(float(np.abs(cfg["cuda"][k] - cfg["cpu"][k]).max()) for k in cfg["cpu"])
        with open(os.path.join(root, "colorvideovdp_tpu", "vvdp_data",
                               "cvvdp_parameters.json")) as f:
            init = json.load(f)
        moved = {k: round(float(np.abs(cfg["cuda"][k] - np.asarray(init[k])).max()), 6)
                 for k in train.PARAMS}
        log(f"phase 14: fitted floats card against CPU within {d_fit:.3e} (tolerance "
            f"{CALIB_FIT_TOL:.0e}); moved from the default by {moved}")
        if not d_fit <= CALIB_FIT_TOL:
            raise AssertionError(f"phase 14: fitted configs differ by {d_fit}")

        # A pair scored with the fitted config against the trainer's
        # prediction from its features.
        out_dir = os.path.dirname(fits["cuda"]["config"])
        r = rows[1]
        m_fit = cvt.cvvdp(display_name=r[3], device="cuda", quiet=True,
                          temp_padding="replicate", config_paths=[out_dir])
        geom = cvt.vvdp_display_geometry.load(r[3])
        vs = video_source_file(os.path.join(d, r[0]), os.path.join(d, r[1]),
                               display_photometry=r[3], resize_resolution=geom.resolution)
        jod_api = float(m_fit.predict_video_source(vs)[0])
        jod_fit = train.predict(train.init_params(m_fit, m_fit.device), feat[r[0]],
                                train.pool_kwargs(m_fit))
        log(f"phase 14: {r[0]} with the fitted config: JOD {jod_api:.6f}, the trainer's "
            f"prediction {jod_fit:.6f} (|d| {abs(jod_api - jod_fit):.2e}, tolerance "
            f"{CALIB_CONFIG_JOD_TOL:.0e})")
        if not abs(jod_api - jod_fit) <= CALIB_CONFIG_JOD_TOL:
            raise AssertionError(f"phase 14: fitted config JOD {jod_api} vs {jod_fit}")

        # The ML checkpoint converter: seeded weights (phase 8's, whose
        # saliency head responds) through a checkpoint, the port's tool and
        # config_paths score as the seeded metric.
        img = [os.path.join(d, n) for n in rows[3][:2]]
        manifest = convert_ml_ckpt.load_manifest()
        weights = seeded_ml_weights(14)
        for family, cls in (("cvvdp_ml_saliency", cvt.cvvdp_ml_saliency),
                            ("cvvdp_ml_transformer", cvt.cvvdp_ml_transformer)):
            fam_dir = os.path.join(d, family)
            os.makedirs(fam_dir)
            m_seed = cls(display_name="standard_fhd", device="cuda", random_init=True)
            m_seed.load_weights({k: weights[k] for k in manifest[family]})
            ckpt = os.path.join(fam_dir, "cvvdp.ckpt")
            torch.save({"state_dict": {k: torch.from_numpy(v)
                                       for k, v in m_seed.ml_weights().items()}}, ckpt)
            npz = os.path.join(fam_dir, "cvvdp_ml.npz")
            convert_ml_ckpt.main([ckpt, npz])
            convert_ml_ckpt.main(["--validate", npz, family])
            m_conv = cls(display_name="standard_fhd", device="cuda", config_paths=[fam_dir])
            jods = []
            for m in (m_seed, m_conv):
                vs = video_source_file(*img, display_photometry="standard_fhd")
                jods.append(float(m.predict_video_source(vs)[0]))
            log(f"phase 14: {family}: converted checkpoint JOD {jods[1]!r}, seeded metric "
                f"{jods[0]!r}")
            if jods[1] != jods[0] or not 0.0 < jods[0] < 10.0:
                raise AssertionError(f"phase 14: {family}: converted JOD {jods[1]} vs {jods[0]}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"phase 14: {time.time() - t_phase:.1f} s ({smi})")
    return {"calib": launches}


def ingest_modes(first, stats):
    """The ingest kernel's modes a video run launches: the first block's
    mode, and tail mode where the clip takes more than one block."""
    return (first,) + (("ingest",) if stats["N_frames"] > stats["block_N_frames"] else ())


# The first block's padding (phase 3): the clip scored with the padding
# formed in the ingest kernel's replicate mode, against the same clip with
# frame 0 converted in plain PyTorch and handed to tail mode as the tails.
FIRST_BLOCK_JOD_TOL, FIRST_BLOCK_Q_TOL = 1e-5, 1e-5


def first_block_padding(cvt, ingest, V_test, V_ref, fps, jod_k, stats_k):
    """Phase 3: the 4K clip's JOD and ``Q_per_ch`` (relative to the largest
    value) with its first block padded by ``ingest_replicate`` (``jod_k``,
    ``stats_k``) against tails formed by the plain ``raw_to_met``."""
    replicate = ingest.ingest_replicate

    def formed_tails(raw_t, raw_r, dm, filt, colorspace="DKLd65"):
        fl = np.asarray(filt).shape[1]
        tails = [ingest.raw_to_met(dm, r[:, :1], colorspace).expand(-1, -1, fl - 1, -1, -1)
                 .contiguous() for r in (raw_t, raw_r)]
        return ingest.ingest(*tails, raw_t, raw_r, dm, filt, colorspace)

    ingest.ingest_replicate = formed_tails
    before = (ingest.ingest.launches, replicate.launches)
    try:
        mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
        torch.cuda.empty_cache()
        Q, st = mv.predict(V_test, V_ref, dim_order="HWCF", frames_per_second=fps)
    finally:
        ingest.ingest_replicate = replicate
    if (ingest.ingest.launches - before[0], replicate.launches - before[1]) != (
            -(-st["N_frames"] // st["block_N_frames"]), 0):
        raise AssertionError("phase 3: the formed-tails run did not take tail mode alone")
    q_a, q_b = stats_k["Q_per_ch"], st["Q_per_ch"]
    d_jod = abs(float(Q) - jod_k)
    d_q = float(np.abs(q_a - q_b).max() / np.abs(q_b).max())
    log(f"phase 3: first block padded in the kernel vs tails formed in plain PyTorch "
        f"({stats_k['block_N_frames']}/{st['block_N_frames']}-frame blocks): |dJOD| "
        f"{d_jod:.3e} (tolerance {FIRST_BLOCK_JOD_TOL:.0e}), max |dQ_per_ch| / max |Q_per_ch| "
        f"{d_q:.3e} (tolerance {FIRST_BLOCK_Q_TOL:.0e}), max |dQ_per_ch| "
        f"{float(np.abs(q_a - q_b).max()):.3e}")
    if st["block_N_frames"] != stats_k["block_N_frames"]:
        raise AssertionError("phase 3: the formed-tails run took other blocks")
    if not (d_jod <= FIRST_BLOCK_JOD_TOL and d_q <= FIRST_BLOCK_Q_TOL):
        raise AssertionError(f"phase 3: first-block padding gap {d_jod}, {d_q}")


def block_loop_split(cvt, vs, N, pix, fps, split_blk):
    """Where phase 3's block loop spends its time. First the loop from an
    emptied allocator cache, at the split's blocks (pinned with ``gpu_mem``)
    and at the blocks the model gives an empty card, which separates the
    block length from the allocator's state. Then the device time of one
    run at the latter blocks, each kernel's sum and count from
    ``torch.profiler`` (``tools/path_times.py`` ``profile_device``) and the
    device's busy share; then one warm block's stages with CUDA events
    (ingest, the decomposition, the band kernel's launches, baseband and
    pooling), which hold even where the profiler records no device time."""
    from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
    from colorvideovdp_tpu_torch.ops.kernels import ingest
    from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm
    from colorvideovdp_tpu_torch.tools.path_times import profile_device

    def loop(gpu_mem=None):
        m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True, gpu_mem=gpu_mem)
        # The caching allocator's blocks count as used in the block model.
        torch.cuda.empty_cache()
        t0 = time.time()
        _, st = m.predict_video_source(vs)
        torch.cuda.synchronize()
        return m, time.time() - t0, st["block_N_frames"]

    probe = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    _, t_split, b_split = loop(probe.block_gpu_mem(pix, split_blk, fps))
    if b_split != split_blk:
        raise AssertionError(f"phase 3: gpu_mem pinned {b_split}-frame blocks, not {split_blk}")
    mv, t_full, blk = loop()
    log(f"phase 3: block loop from an emptied allocator cache: {t_split:.3f} s in "
        f"{b_split}-frame blocks, {t_full:.3f} s in {blk}-frame blocks")
    torch.cuda.empty_cache()
    rows, busy, wall = profile_device(lambda: mv.predict_video_source(vs))
    log(f"phase 3: profiled block loop {wall:.3f} s for {N} frames in {blk}-frame blocks, "
        f"device busy {busy:.3f} ms ({100 * busy / (1e3 * wall):.1f}%), idle "
        f"{1e3 * wall - busy:.3f} ms")
    for ms, count, name in rows[:15]:
        log(f"  {ms:9.3f} ms {count:5d}x  {name[:110]}")
    if not rows:
        log("  (the profiler recorded no device time)")

    # One warm block of the loop, its stages timed with CUDA events.
    dm = mv.display_photometry
    filt = np.ascontiguousarray(np.stack([f[::-1] for f in mv.F]), np.float32)
    raws = [mv._upload(vs.get_raw_block(s, 0, blk)) for s in ("test", "reference")]
    consts, luts = mv._band_tables(4)
    sens_corr = 10.0 ** (mv.sensitivity_correction / 20.0)
    for rep in range(2):  # the first is the warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        R = ingest.ingest_replicate(*raws, dm, filt)[0]
        ev[1].record()
        bands, L_bkg = mv.lpyr.decompose(R, raw_pairs=True, use_kernel=True)
        ev[2].record()
        shapes = [b[0].shape[-2:] for b in bands[:-1]]
        launches = []
        for sel in bm.band_groups(shapes, 1, 4, blk, gn=True):
            s0 = torch.cuda.Event(enable_timing=True)
            s0.record()
            bp.band_pooled([bands[bb][0] for bb in sel], [bands[bb][1] for bb in sel], luts[sel],
                           [1.0 if bb == 0 else 2.0 for bb in sel], consts)
            launches.append((sel, s0))
        ev[3].record()
        mv._baseband(bands[-1], L_bkg[-1], 4, sens_corr)
        ev[4].record()
        torch.cuda.synchronize()
        ends = [s for _, s in launches[1:]] + [ev[3]]
        per = [(sel, s.elapsed_time(e)) for (sel, s), e in zip(launches, ends)]
        del R, bands, L_bkg
    stage = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    log(f"phase 3: one warm {blk}-frame block (CUDA events): ingest {stage[0]:.3f} ms, "
        f"decomposition (reduce + bands) {stage[1]:.3f} ms, band_pooled {stage[2]:.3f} ms "
        f"({', '.join(f'{sel} {t:.3f}' for sel, t in per)}), baseband and pooling "
        f"{stage[3]:.3f} ms")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.blur import blur_adjoint_plain, blur_plain, gaussian_kernel1d
    from colorvideovdp_tpu_torch.ops.kernels import (_build, counted_wrappers, csf_lut, ingest,
                                                     masking_fused)
    from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp
    from colorvideovdp_tpu_torch.ops.kernels import blur as blr
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd

    # ---- phase 0 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"phase 0: card: {smi}")
    have = optional_imports()
    log("phase 0: optional modules: " + ", ".join(
        f"{k} {'imports' if v else 'absent'}" for k, v in have.items()))
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    H, W, N, fps = 2160, 3840, 32, 30.0
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != flags:
        raise AssertionError("constructing a metric changed the TF32 flags")
    seen = []
    mp = cvt.cvvdp(display_name="standard_4k", device="cuda", quiet=True)
    inner = mp._process_block

    def probe(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return inner(*a, **kw)

    mp._process_block = probe
    img = np.full((64, 64, 3), 128, np.uint8)
    mp.predict(img, img, dim_order="HWC")
    if seen != [(False, False)]:
        raise AssertionError(f"TF32 flags inside the metric call: {seen}")
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != flags:
        raise AssertionError("a metric call left the TF32 flags changed")
    log(f"phase 0: TF32 flags (cuDNN, matmul) {flags} unchanged by the metric, off inside it")
    del mp, probe, inner

    # ---- phase 1 ------------------------------------------------------------
    t0 = time.time()
    _build.library()
    log(f"phase 1: kernel build {time.time() - t0:.1f} s (nvcc {_build.last_build_seconds:.1f} s)")
    with open(f"{_build.BUILD_DIR}/nvcc.log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # ---- phase 2 ------------------------------------------------------------
    from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

    F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
    m.filter_len = len(F_taps[0])
    filt = np.stack([f[::-1] for f in F_taps])
    blk = m.estimate_block_N(H * W, N)
    dm = m.display_photometry
    # Seeded random frames at the first block's shapes: every one of the 8
    # output planes then carries signal (the clip's static, grey reference
    # has chroma and transient planes of pure rounding noise), so each plane
    # can be held to its own scale.
    gen = torch.Generator(device=dev).manual_seed(7)
    raws = [torch.randint(0, 256, (1, blk, 3, H, W), dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(2)]
    tails = [ingest.raw_to_met(dm, torch.randint(0, 256, (1, m.filter_len - 1, 3, H, W),
                                                 dtype=torch.uint8, device=dev,
                                                 generator=gen)).contiguous()
             for _ in range(2)]
    log(f"phase 2: shapes at blk={blk}, filter_len={m.filter_len}")
    rows = {}

    def record(name, err, abs_err, k_ms, p_ms, bnd, lib_ms=None, dev_ms=None):
        """A kernel's row: ``ms`` is the call time ``k_ms``; ``device_ms``,
        where measured (rows 9-12 and the adjoint), its device time."""
        check(name, err, TOL[name])
        b_ms, b_by = bnd
        log(f"  {name}: max abs error {abs_err:.3e}, kernel {k_ms:.4f} ms "
            f"({100 * b_ms / k_ms:.1f}% of the bound)"
            + ("" if dev_ms is None else
               f", device {dev_ms:.4f} ms ({100 * b_ms / dev_ms:.1f}% of the bound)")
            + f", plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), library "
            + ("none" if lib_ms is None else f"{lib_ms:.3f} ms"))
        rows[name] = dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms)
        if dev_ms is not None:
            rows[name]["device_ms"] = dev_ms

    args = (tails[0], tails[1], raws[0], raws[1], dm, filt)
    R_k, nt_k, _ = ingest.ingest(*args)
    R_p, nt_p, _ = ingest.ingest_plain(*args)
    err = max(rel_err_per(R_k, R_p, 1), rel_err_per(nt_k, nt_p, 1))
    # Colour (EOTF + 3x3, ~25 operations) per new source pixel; the temporal
    # FIR, fl multiply-adds per output element.
    b_ingest = bound(nbytes(*raws, *tails) + nbytes(R_k) + 2 * nbytes(nt_k),
                     25 * 2 * raws[0].numel() // 3 + 2 * m.filter_len * R_k.numel())
    record("ingest", err, max_abs(R_k, R_p), time_ms(lambda: ingest.ingest(*args)),
           time_ms(lambda: ingest.ingest_plain(*args)), b_ingest)
    del R_p, nt_p, nt_k
    # The code-value table route: uint8, uint16 and float16 frames against the
    # same samples as float32 (v / top correctly rounded, float16 widened)
    # through the per-sample path, bit for bit, and uint16 and float16 against
    # the plain version (these launches are not counted).
    src = {"uint8": raws,
           "uint16": [torch.randint(-32768, 32768, raws[0].shape, dtype=torch.int16, device=dev,
                                    generator=gen) for _ in range(2)],
           "float16": [torch.rand(raws[0].shape, device=dev, generator=gen).half()
                       for _ in range(2)]}

    def as_float32(r):
        if r.dtype == torch.float16:
            return r.float()
        top = 255.0 if r.dtype == torch.uint8 else 65535.0
        v = r if r.dtype == torch.uint8 else r.to(torch.int32) & 0xFFFF
        return (v.double() / top).float()  # within 1e-16 of v / top: its float32 rounding

    for name, rs in src.items():
        out_t = ingest.ingest(*tails, *rs, dm, filt)
        out_f = ingest.ingest(*tails, *[as_float32(r) for r in rs], dm, filt)
        check(f"ingest {name} table route vs float32 per-sample path",
              max(max_abs(a, b) for a, b in zip(out_t, out_f)), 0.0)
        del out_f
        if name != "uint8":
            out_p = ingest.ingest_plain(*tails, *rs, dm, filt)
            check(f"ingest {name} {tuple_str(rs[0].shape)} vs plain",
                  max(rel_err_per(a, b, 1) for a, b in zip(out_t, out_p)), TOL["ingest"])
            del out_p
        del out_t
    del src
    # Channel-last raws, as a 4K FHWC clip's block reaches the kernel: the
    # benchmark's uint16 23-frame block laid out (H, W, C) a frame, against
    # the plain version and bit for bit the planar launch of the same
    # values, timed in turns with it (these launches are not counted).
    planar = [torch.randint(-32768, 32768, (1, FHWC_BLK, 3, H, W), dtype=torch.int16,
                            device=dev, generator=gen) for _ in range(2)]
    cl = [r.permute(0, 1, 3, 4, 2).contiguous().permute(0, 1, 4, 2, 3) for r in planar]
    if not (ingest._is_channel_last(cl[0]) and not cl[0].is_contiguous()):
        raise AssertionError(f"not a channel-last layout: strides {cl[0].stride()}")
    out_cl = ingest.ingest(*tails, *cl, dm, filt)
    check(f"ingest channel-last {tuple_str(cl[0].shape)} vs the planar launch, bit for bit",
          max(max_abs(a, b) for a, b in zip(out_cl, ingest.ingest(*tails, *planar, dm, filt))),
          0.0)
    out_p = ingest.ingest_plain(*tails, *cl, dm, filt)
    err = max(rel_err_per(a, b, 1) for a, b in zip(out_cl, out_p))
    check(f"ingest channel-last {tuple_str(cl[0].shape)} vs plain", err, TOL["ingest"])
    del out_cl, out_p
    def launch(rs):
        ingest.ingest(*tails, *rs, dm, filt)  # device_ms keeps what this returns: nothing

    turns = {"planar": [], "channel_last": []}
    for order in ("planar", "channel_last", "channel_last", "planar"):
        rs = planar if order == "planar" else cl
        turns[order].append(device_ms(lambda: launch(rs), 10))
    rows["ingest"]["channel_last"] = dict(shape=tuple_str(cl[0].shape), dtype="uint16",
                                          max_rel_err=err, device_ms=turns["channel_last"],
                                          planar_device_ms=turns["planar"])
    log(f"  ingest {tuple_str(cl[0].shape)} uint16 device ms in turns: planar "
        f"{turns['planar'][0]:.3f}, channel-last {turns['channel_last'][0]:.3f}, "
        f"{turns['channel_last'][1]:.3f}, planar {turns['planar'][1]:.3f}")
    del tails, raws, args, planar, cl
    torch.cuda.empty_cache()

    # The reduce at every level of the 4K pyramid, each from the kernel's
    # previous level, bit for bit, timed beside its bound (5 taps vertically
    # over (H/2, W), then 5 over (H/2, W/2): 7.5 H W operations a plane).
    m._ensure_pyramids(W, H)
    x = R_k
    for lv in range(len(m.lpyr.pyr_shape) - 1):
        y = prd.pyramid_reduce(x)
        y_p = pyr.reduce_plain(x)
        check(f"pyramid_reduce level {lv} {tuple_str(x.shape)} vs plain, bit for bit",
              max_abs(y, y_p), 0.0)
        k_ms = time_ms(lambda: prd.pyramid_reduce(x))
        b_lv = bound(nbytes(x, y), 7.5 * x.numel())
        log(f"  pyramid_reduce level {lv}: kernel {k_ms:.4f} ms, bound {b_lv[0]:.4f} ms "
            f"({b_lv[1]}, {100 * b_lv[0] / k_ms:.1f}% of it)")
        if lv == 0:
            err = float((y - y_p).abs().max()) / max(1.0, float(y_p.abs().max()))
            record("pyramid_reduce", err, max_abs(y, y_p), k_ms,
                   time_ms(lambda: pyr.reduce_plain(R_k)), b_lv)
        x = y
        del y_p
    del x, y

    consts, luts = m._band_tables(4)
    bands, L_bkg = m.lpyr.decompose(R_k, raw_pairs=True, use_kernel=False)
    # The one-pass pooled kernel at 4K band 0 of this block and at the launch
    # that stacks the narrow bands: against its plain version, timed.
    groups_p = masking_fused.band_groups([b[0].shape[-2:] for b in bands[:-1]], 1, 4, blk,
                                         gn=True)
    occ = _build.library().cvvdp_band_pooled_occupancy((len(consts.taps) - 1) // 2, 4,
                                                       luts.shape[2])
    log(f"  band_pooled launches per block: {groups_p}; {occ} blocks of 256 threads an SM")

    def pooled_args(sel):
        return ([bands[bb][0] for bb in sel], [bands[bb][1] for bb in sel],
                luts[sel[0]:sel[-1] + 1].contiguous(), [1.0 if bb == 0 else 2.0 for bb in sel],
                consts)

    errs_p, abs_p, times_p = [], [], {}
    for note, sel in (("4K band 0", [0]), (f"4K bands {groups_p[-1]}", groups_p[-1])):
        a = pooled_args(sel)
        s_k, s_p = bp.band_pooled(*a), bp.band_pooled_plain(*a)
        q_k, q_p = ([masking_fused.pooled_norm(s[j], *gi.shape[-2:], m.beta)
                     for j, gi in enumerate(a[0])] for s in (s_k, s_p))
        errs_p.append(max(rel_err_per(x, y, 1) for x, y in zip(q_k, q_p)))
        abs_p.append(max(max_abs(x, y) for x, y in zip(q_k, q_p)))
        check(f"band_pooled {note}", errs_p[-1], TOL["band_pooled"])
        k_ms = time_ms(lambda: bp.band_pooled(*a))
        n_tiles = sum(-(-gi.shape[-2] // 32) * -(-gi.shape[-1] // 32) for gi in a[0]) * blk
        # Bytes: gi's 2C planes and gn's 2C quarter planes read once, the
        # tables, the C partial sums of each 32x32 tile and the sums written.
        # Operations: ~115 per pixel and channel, the halo recompute counted
        # once (contrast, LUT, the 2 x 13-tap blur, transducer and pooling
        # ~95, plus the expand of two planes).
        b_p = bound(nbytes(*a[0], *a[1], a[2]) + 4 * 4 * n_tiles + nbytes(s_k),
                    115 * sum(gi.numel() for gi in a[0]) // 2)
        times_p[note] = (k_ms, b_p)
        log(f"  band_pooled {note} {[tuple(gi.shape) for gi in a[0]]}: kernel {k_ms:.3f} ms, "
            f"bound {b_p[0]:.4f} ms ({b_p[1]}, {100 * b_p[0] / k_ms:.1f}% of it)")
        if note == "4K band 0":
            p0 = time_ms(lambda: bp.band_pooled_plain(*a))
        del a, s_k, s_p
        torch.cuda.empty_cache()
    k0, b0 = times_p["4K band 0"]
    record("band_pooled", max(errs_p), abs_p[0], k0, p0, b0)

    logL = L_bkg[-1].contiguous()  # the baseband's (1, 1, blk, 1, 1) log-luminance
    x0, x1 = m.csf.lut_range()
    lut_b = torch.as_tensor(np.stack([m.csf.logS_of_logL(0.1, m.omega[0 if cc < 3 else 1],
                                                         cc if cc < 3 else 0)
                                      for cc in range(4)]), device=dev)
    c_k = csf_lut.csf_lut(logL, lut_b, x0, x1)
    c_p = csf_lut.csf_lut_plain(logL, lut_b, x0, x1)
    check(f"csf_lut baseband {tuple(logL.shape)}",
          float(((c_k - c_p).abs() / c_p.abs()).max()), TOL["csf_lut"])
    del R_k, bands, L_bkg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The loss path's kernels at the shapes of phase 5 (B = 4, C = 3, FHD):
    # the CSF LUT over band 0's full log-luminance field (the recompute in the
    # band masking backward), its backward, and the phase-uncertainty blur
    # and its adjoint (``Blur``'s backward); then the ML trunk's 4K band 0
    # (C = 4, 8 frames) and the texture models' 33-tap blur. Each timed as
    # its device time (``tools/kernel_times.py`` ``device_ms``: the CUDA
    # kernels' time under the profiler, the host's work between launches
    # left out) and as one call (CUDA events around it).
    def shape_row(k_fn, p_fn, bnd, lib_fn=None):
        row = timing_row(k_fn, p_fn, lib_fn)
        row.update(bound_ms=bnd[0], bound_by=bnd[1], device_share=bnd[0] / row["device_ms"])
        return row

    def log_shapes(name, shapes):
        for key, r in shapes.items():
            log(f"  {name} {key}: device {r['device_ms']:.4f} ms, call {r['call_ms']:.4f} ms, "
                f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{100 * r['device_share']:.1f}% of the device time), library "
                + ("none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"))

    field = torch.empty((1, 1, 1080, 1920), device=dev).uniform_(x0 - 0.5, x1 + 0.5,
                                                                generator=gen)
    lut3 = lut_b[:3].contiguous()
    c_k = csf_lut.csf_lut(field, lut3, x0, x1)
    c_p = csf_lut.csf_lut_plain(field, lut3, x0, x1)
    check("csf_lut bit for bit", max_abs(c_k, c_p), 0.0)
    n = field.numel()
    record("csf_lut", float(((c_k - c_p).abs() / c_p.abs()).max()), max_abs(c_k, c_p),
           time_ms(lambda: csf_lut.csf_lut(field, lut3, x0, x1)),
           time_ms(lambda: csf_lut.csf_lut_plain(field, lut3, x0, x1)),
           bound(nbytes(field, c_k, lut3), n * lut_instr(3)),
           dev_ms=device_ms(lambda: csf_lut.csf_lut(field, lut3, x0, x1)))
    g = torch.randn((3,) + tuple(field.shape), device=dev, generator=gen)
    d_k = csf_lut.csf_lut_bwd(field, g, lut3, x0, x1)
    d_p = csf_lut.csf_lut_bwd_plain(field, g, lut3, x0, x1)
    check("csf_lut_bwd bit for bit", max_abs(d_k, d_p), 0.0)
    record("csf_lut_bwd", float((d_k - d_p).abs().max() / d_p.abs().max()), max_abs(d_k, d_p),
           time_ms(lambda: csf_lut.csf_lut_bwd(field, g, lut3, x0, x1)),
           time_ms(lambda: csf_lut.csf_lut_bwd_plain(field, g, lut3, x0, x1)),
           bound(nbytes(field, g, lut3, d_k), n * lut_instr(3, backward=True)),
           dev_ms=device_ms(lambda: csf_lut.csf_lut_bwd(field, g, lut3, x0, x1)))
    del field, g, c_k, c_p, d_k, d_p
    # The ML trunk's band-0 field at 4K (8 frames, C = 4) and the baseband.
    field = torch.empty((1, 1, 8, 2160, 3840), device=dev).uniform_(x0 - 0.5, x1 + 0.5,
                                                                   generator=gen)
    c_k = csf_lut.csf_lut(field, lut_b, x0, x1)
    check(f"csf_lut {tuple(field.shape)} C=4 bit for bit",
          max_abs(c_k, csf_lut.csf_lut_plain(field, lut_b, x0, x1)), 0.0)
    rows["csf_lut"]["shapes"] = {
        "(1,1,8,2160,3840) C=4": shape_row(
            lambda: csf_lut.csf_lut(field, lut_b, x0, x1),
            lambda: csf_lut.csf_lut_plain(field, lut_b, x0, x1),
            bound(nbytes(field, c_k, lut_b), field.numel() * lut_instr(4))),
        f"baseband {tuple_str(logL.shape)} C=4": shape_row(
            lambda: csf_lut.csf_lut(logL, lut_b, x0, x1),
            lambda: csf_lut.csf_lut_plain(logL, lut_b, x0, x1),
            bound(nbytes(logL, lut_b) + 4 * nbytes(logL), logL.numel() * lut_instr(4)))}
    log_shapes("csf_lut", rows["csf_lut"]["shapes"])
    del field, c_k
    torch.cuda.empty_cache()

    def blur_case(shape, n_taps, sigma):
        """The blur and its adjoint at one shape against their plain versions
        (the adjoint also against autograd of blur_plain), with the library
        yardstick: a depthwise n x n convolution with the outer-product taps
        and reflect padding (cuDNN, TF32 off)."""
        taps = gaussian_kernel1d(n_taps, sigma)
        xb = torch.rand(shape, device=dev, generator=gen)
        y_k, y_p = blr.blur(xb, taps), blur_plain(xb, taps)
        abs_f = max_abs(y_k, y_p)
        check(f"blur {shape} {n_taps} taps bit for bit", abs_f, 0.0)
        err_f = abs_f / float(y_p.abs().max())
        P = xb.numel() // (shape[-2] * shape[-1])
        conv = torch.nn.Conv2d(P, P, n_taps, groups=P, padding=n_taps // 2,
                               padding_mode="reflect", bias=False).to(dev)
        xc = xb.reshape(1, P, *shape[-2:])
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(np.outer(taps, taps), device=dev)
                              .expand(P, 1, n_taps, n_taps))
            log(f"  blur {shape} {n_taps} taps: library conv max abs difference "
                f"{max_abs(conv(xc).reshape(shape), y_p):.3e}")
            b = bound(nbytes(xb, y_k), blur_instr(n_taps) * xb.numel())
            fwd = shape_row(lambda: blr.blur(xb, taps), lambda: blur_plain(xb, taps), b,
                            lambda: conv(xc))
        del y_k, y_p, conv, xc
        gb = torch.randn(shape, device=dev, generator=gen)
        a_k = blr.blur_adjoint(gb, taps)
        check(f"blur_adjoint {shape} {n_taps} taps vs blur_adjoint_plain bit for bit",
              max_abs(a_k, blur_adjoint_plain(gb, taps)), 0.0)
        x0b = torch.zeros(shape, device=dev, requires_grad=True)
        (a_ref,) = torch.autograd.grad(blur_plain(x0b, taps), x0b, gb)
        err = float((a_k - a_ref).abs().max() / a_ref.abs().max())
        check(f"blur_adjoint {shape} {n_taps} taps vs autograd of blur_plain", err,
              TOL["blur_adjoint"])
        abs_err = max_abs(a_k, a_ref)
        del a_ref, x0b
        adj = shape_row(lambda: blr.blur_adjoint(gb, taps), lambda: blur_adjoint_plain(gb, taps),
                        bound(nbytes(gb, a_k), blur_instr(n_taps) * gb.numel()))

        def autograd_adjoint():
            with torch.enable_grad():
                x0a = torch.zeros(shape, device=dev, requires_grad=True)
                return torch.autograd.grad(blur_plain(x0a, taps), x0a, gb)[0]

        adj["autograd_ms"] = time_ms(autograd_adjoint)
        del xb, gb, a_k
        torch.cuda.empty_cache()
        return fwd, adj, (err_f, abs_f), (err, abs_err)

    blur_shapes, adj_shapes = {}, {}
    for shape, n_taps, sigma in (((12, 1080, 1920), 13, 3.0), ((3, 135, 241), 13, 3.0),
                                 ((1, 4, 8, 2160, 3840), 13, 3.0), ((3, 1080, 1920), 33, 8.0)):
        key = f"{tuple_str(shape)} {n_taps} taps"
        blur_shapes[key], adj_shapes[key], errs_f, errs_a = blur_case(shape, n_taps, sigma)
        if key == "(12,1080,1920) 13 taps":
            f, a = blur_shapes.pop(key), adj_shapes.pop(key)
            record("blur", *errs_f, f["call_ms"], f["plain_ms"], (f["bound_ms"], f["bound_by"]),
                   f["library_ms"], dev_ms=f["device_ms"])
            record("blur_adjoint", *errs_a, a["call_ms"], a["plain_ms"],
                   (a["bound_ms"], a["bound_by"]), None, dev_ms=a["device_ms"])
            rows["blur_adjoint"]["autograd_ms"] = a["autograd_ms"]
            log(f"  blur_adjoint (12,1080,1920): autograd of blur_plain {a['autograd_ms']:.3f} ms")
    rows["blur"]["shapes"], rows["blur_adjoint"]["shapes"] = blur_shapes, adj_shapes
    log_shapes("blur", blur_shapes)
    log_shapes("blur_adjoint", adj_shapes)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 3 ------------------------------------------------------------
    t0 = time.time()
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    log(f"phase 3: clip content made in {time.time() - t0:.1f} s")
    counters = counted_wrappers()
    results = {}
    for fused in (True, False):
        mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
        mv.enable_fused_kernels = fused
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.time()
        Q, stats = mv.predict(V_test, V_ref, dim_order="HWCF", frames_per_second=fps)
        jod = float(Q)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        results[fused] = (jod, launches, stats)
        log(f"phase 3: {'kernels' if fused else 'plain  '}: JOD {jod:.6f}, blk {stats['block_N_frames']}, "
            f"{N / dt:.2f} frames/s ({dt:.3f} s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}")
    jod_k, launches, stats_k = results[True]
    jod_p, _, _ = results[False]
    for k in ingest_modes("ingest_replicate", stats_k) + ("pyramid_reduce", "band_pooled",
                                                          "csf_lut"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    if not abs(jod_k - jod_p) <= 1e-3:
        raise AssertionError(f"JOD kernels {jod_k} vs plain {jod_p}")
    if not abs(jod_k - CLIP_JOD) <= 0.01:
        raise AssertionError(f"JOD {jod_k} vs reference {CLIP_JOD}")
    if not abs(jod_k - PORT_JOD) <= PORT_JOD_TOL:
        raise AssertionError(f"JOD {jod_k} vs the port's earlier {PORT_JOD}")
    log(f"phase 3: |JOD kernels - plain| = {abs(jod_k - jod_p):.2e}, "
        f"|JOD - {CLIP_JOD}| = {abs(jod_k - CLIP_JOD):.2e}, |JOD - {PORT_JOD}| = "
        f"{abs(jod_k - PORT_JOD):.2e}")
    first_block_padding(cvt, ingest, V_test, V_ref, fps, jod_k, stats_k)
    # The same clip as FHWC, the layout of the channel-last cells: its blocks
    # go to the card as they lie and the ingest kernel reads them
    # channel-last, with the HWCF run's launches and, bit for bit, its JOD
    # and Q_per_ch.
    V_fhwc = [np.ascontiguousarray(v.transpose(3, 0, 1, 2)) for v in (V_test, V_ref)]
    mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.empty_cache()  # the block length follows the free memory, as above
    torch.cuda.synchronize()
    t0 = time.time()
    Q, stats = mv.predict(*V_fhwc, dim_order="FHWC", frames_per_second=fps)
    jod_cl = float(Q)
    torch.cuda.synchronize()
    dt = time.time() - t0
    fhwc_launches = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 3: FHWC kernels: JOD {jod_cl:.6f}, blk {stats['block_N_frames']}, "
        f"{N / dt:.2f} frames/s ({dt:.3f} s), launches {fhwc_launches}")
    if fhwc_launches != launches:
        raise AssertionError(f"FHWC launches {fhwc_launches} vs HWCF {launches}")
    if not (jod_cl == jod_k and np.array_equal(stats["Q_per_ch"], stats_k["Q_per_ch"])):
        raise AssertionError(f"FHWC JOD {jod_cl} or Q_per_ch differ from HWCF's ({jod_k})")
    del V_fhwc
    # Where the end-to-end time goes: the host relayout of the input arrays
    # into frame-major blocks against the block loop (uploads included).
    for fused in (True, False):
        mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
        mv.enable_fused_kernels = fused
        t0 = time.time()
        vs = cvt.video_source_array(V_test, V_ref, fps, dim_order="HWCF",
                                    display_photometry=mv.display_photometry)
        for s in ("test", "reference"):
            vs.get_raw_block(s, 0, 1)
        t_host = time.time() - t0
        torch.cuda.synchronize()
        t0 = time.time()
        _, st = mv.predict_video_source(vs)
        torch.cuda.synchronize()
        t_loop = time.time() - t0
        log(f"phase 3: {'kernels' if fused else 'plain  '} split: host relayout {t_host:.3f} s, "
            f"block loop {t_loop:.3f} s = {N / t_loop:.2f} frames/s "
            f"({st['block_N_frames']}-frame blocks)")
        if fused:
            block_loop_split(cvt, vs, N, H * W, fps, SPLIT_BLK)
    # Phase 12's content: the clip's first FILE_FRAMES frames.
    V_files = (V_test[..., :FILE_FRAMES].copy(), V_ref[..., :FILE_FRAMES].copy())
    del V_test, V_ref, vs

    # ---- phase 4 ------------------------------------------------------------
    rng = np.random.RandomState(5)
    I_ref = (rng.rand(1080, 1920, 3) * 255).astype(np.uint8)
    I_test = np.clip(I_ref.astype(np.int16) + (rng.randn(1080, 1920, 3) * 6).astype(np.int16),
                     0, 255).astype(np.uint8)
    mi = cvt.cvvdp(display_name="standard_fhd", device="cuda", quiet=True)
    for fn in counters.values():
        fn.launches = 0
    Qi, _ = mi.predict(I_test, I_ref, dim_order="HWC")
    jod_i = float(Qi)
    img_launches = {k: fn.launches for k, fn in counters.items()}
    log(f"phase 4: image JOD {jod_i:.6f}, launches {img_launches}")
    if not math.isfinite(jod_i):
        raise AssertionError("image JOD is not finite")
    for k in ("pyramid_reduce", "band_pooled", "csf_lut"):
        if img_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the image path")

    del mi

    # ---- phase 5 ------------------------------------------------------------
    train_path = ("pyramid_reduce", "band_pooled", "csf_lut", "csf_lut_bwd", "blur", "blur_adjoint")
    Ht, Wt, Bt = 1080, 1920, 4
    rng = np.random.RandomState(11)
    ref_np = rng.rand(Bt, 3, 1, Ht, Wt).astype(np.float32)
    test_np = np.clip(ref_np + rng.randn(*ref_np.shape).astype(np.float32) * 0.1, 0, 1)
    ref_t, test_t = torch.from_numpy(ref_np).to(dev), torch.from_numpy(test_np).to(dev)
    del ref_np, test_np
    mt = cvt.cvvdp(display_name="standard_fhd", device="cuda", quiet=True)
    loss_fn = mt.get_loss_fn(Ht, Wt)

    # The reduce and band kernels against their plain versions at the
    # shapes this phase gives them: every pyramid level of the batch and
    # every band launch (these launches are not counted).
    with torch.no_grad():
        dmt = mt.display_photometry
        Rt = ingest.interleave_tr(dmt.source_2_target_colorspace(test_t, "DKLd65"),
                                  dmt.source_2_target_colorspace(ref_t, "DKLd65"))
        bands_t, _ = mt.lpyr.decompose(Rt, raw_pairs=True, use_kernel=False)
        err = 0.0
        for gi, g_next in bands_t[:-1]:
            err = max(err, float((prd.pyramid_reduce(gi) - g_next).abs().max())
                      / max(1.0, float(g_next.abs().max())))
        check(f"pyramid_reduce, {len(bands_t) - 1} levels from {tuple(Rt.shape)}", err,
              TOL["pyramid_reduce"])
        consts_t, luts_t = mt._band_tables(3)
        err = 0.0
        for sel in masking_fused.band_groups([b[0].shape[-2:] for b in bands_t[:-1]],
                                             Bt, 3, 1, gn=True):
            gis = [bands_t[bb][0] for bb in sel]
            gns = [bands_t[bb][1] for bb in sel]
            args = (gis, gns, luts_t[sel[0]:sel[-1] + 1],
                    [1.0 if bb == 0 else 2.0 for bb in sel], consts_t)
            sk, sp = bp.band_pooled(*args), bp.band_pooled_plain(*args)
            err = max(err, max(rel_err_per(masking_fused.pooled_norm(sk[j], *gi.shape[-2:],
                                                                     mt.beta),
                                           masking_fused.pooled_norm(sp[j], *gi.shape[-2:],
                                                                     mt.beta), 1)
                               for j, gi in enumerate(gis)))
        check(f"band_pooled, every band of {tuple(Rt.shape)}", err, TOL["band_pooled"])
        del Rt, bands_t, gis, gns, args, sk, sp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def loss_and_grad():
        x = test_t.clone().requires_grad_()
        v = loss_fn(x, ref_t)
        (gx,) = torch.autograd.grad(v, x)
        return v.detach(), gx

    train = {}
    for fused in (True, False):
        mt.enable_fused_kernels = fused
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        v, gx = loss_and_grad()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in counters.items()}
        step_ms = time_ms(loss_and_grad)
        peak = torch.cuda.max_memory_allocated() / 2**30
        train[fused] = (float(v), gx, counts)
        log(f"phase 5: {'kernels' if fused else 'plain  '}: loss {float(v):.6f}, "
            f"forward+backward {step_ms:.3f} ms per step (B={Bt}, {Ht}x{Wt}), peak memory "
            f"{peak:.2f} GiB, launches {counts}")
        if fused:
            # The blur's backward within the step (CUDA events around each
            # Blur.backward), and the step's device time by kernel.
            split = blur_backward_split(loss_and_grad)
            bwd_ms = split["blur_backward_ms"]
            log(f"phase 5: Blur.backward {bwd_ms:.3f} ms a step over "
                f"{split['blur_backward_calls']} calls ({100 * bwd_ms / step_ms:.1f}% of the "
                f"step); profiled step {split['profiled_wall_ms']:.3f} ms, device busy "
                f"{split['device_busy_ms']:.3f} ms")
            for ms, count, name in split["device_ms_by_kernel"][:10]:
                log(f"  {ms:9.3f} ms {count:5d}x  {name}")
    (v_k, g_k, train_launches), (v_p, g_p, _) = train[True], train[False]
    for k in train_path:
        if train_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the training path")
    if train_launches["blur_adjoint"] != train_launches["blur"]:
        raise AssertionError(f"the training step's blur backward did not take the adjoint kernel "
                             f"at every blur: {train_launches}")
    d_loss = abs(v_k - v_p)
    d_grad = float((g_k - g_p).abs().max() / g_p.abs().max())
    if not torch.isfinite(g_k).all() or not g_k.abs().max() > 0:
        raise AssertionError("training gradient is not finite and non-zero")
    log(f"phase 5: |loss kernels - plain| = {d_loss:.3e} (tolerance {LOSS_TOL:.0e}), "
        f"max |dgrad| / max |grad| = {d_grad:.3e} (tolerance {GRAD_TOL:.0e})")
    if not (d_loss <= LOSS_TOL and d_grad <= GRAD_TOL):
        raise AssertionError("training step: kernels disagree with the plain versions")
    del g_k, g_p
    mt.enable_fused_kernels = True
    x = test_t.clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=1e-3)
    losses = []
    for _ in range(3):
        opt.zero_grad()
        v = loss_fn(x, ref_t)
        v.backward()
        opt.step()
        losses.append(float(v.detach()))
    with torch.no_grad():
        losses.append(float(loss_fn(x, ref_t)))
    log(f"phase 5: loss before and after each of three Adam steps (lr 1e-3): {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError("three Adam steps did not lower the loss")

    del test_t, ref_t, x, opt, loss_fn, mt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    heat_launches = phase_heatmap(m, fps, rows, record, counters, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    config_launches = phase_configs(m, fps, rows, record, counters, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ml_launches = phase_ml(m, fps, record, counters, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    one_band_launches = phase_one_band(m, fps, counters, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    il_launches = phase_interleave(record, counters)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shard_launches = phase_sharded(m, fps, rows, record, jod_k, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="cvvdp_files_")
    try:
        file_launches, files = phase_files(*V_files, fps, counters, smi, tmp)
        del V_files
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cli_launches = phase_cli(files, fps, counters, smi, tmp, have)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    calib_launches = phase_calib(counters, smi)

    src = "colorvideovdp_tpu_torch/csrc/"
    kernels = {
        "ingest": ("ingest.cu", "colorvideovdp_tpu/ops/kernels/ingest.py:322"),
        "pyramid_reduce": ("pyramid_reduce.cu",
                           "colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:195"),
        "band_pooled": ("band_pooled.cu",
                        "colorvideovdp_tpu/ops/kernels/masking_fused.py:440"),
        "csf_lut": ("csf_lut.cu", "colorvideovdp_tpu/ops/kernels/csf_lut.py:114"),
        "csf_lut_bwd": ("csf_lut.cu", "colorvideovdp_tpu/ops/kernels/csf_lut.py:156"),
        "blur": ("blur.cu", "colorvideovdp_tpu/ops/kernels/blur_halo.py:209"),
        "blur_adjoint": ("blur.cu", "colorvideovdp_tpu/ops/kernels/blur_halo.py:209"),
        "ingest_replicate": ("ingest.cu", "colorvideovdp_tpu/ops/kernels/ingest.py:192"),
        "ingest_head": ("ingest.cu", "colorvideovdp_tpu/ops/kernels/ingest.py:192"),
        "band_pooled_d": ("band_pooled.cu", "colorvideovdp_tpu/ops/kernels/masking_fused.py:352"),
        "interleave": ("interleave.cu", "tools/interleave_bench.py:50"),
        "concat": ("interleave.cu", "tools/interleave_bench.py:77"),
        "deinterleave": ("interleave.cu", "tools/interleave_bench.py:109"),
        "pyramid_reduce_slab": ("pyramid_reduce.cu",
                                "colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:238"),
        "band_pooled_halo": ("band_pooled.cu",
                             "colorvideovdp_tpu/ops/kernels/masking_fused.py:352"),
        "band_pooled_d_halo": ("band_pooled.cu",
                               "colorvideovdp_tpu/ops/kernels/masking_fused.py:352"),
    }
    if set(kernels) != set(counters):
        raise AssertionError(f"the kernels line {sorted(kernels)} and the counted wrappers "
                             f"{sorted(counters)} differ")
    line = []
    for k, (f, rep) in kernels.items():
        by_path = {"score_4k_video": launches[k], "score_4k_fhwc_video": fhwc_launches[k],
                   "train_fhd_image": train_launches[k],
                   "heatmap_4k_video_720p_image": heat_launches[k],
                   **{p: c[k] for p, c in config_launches.items()},
                   **{p: c[k] for p, c in ml_launches.items()},
                   **{p: c[k] for p, c in one_band_launches.items()},
                   **{p: c[k] for p, c in il_launches.items()},
                   **{p: c[k] for p, c in shard_launches.items()},
                   **{p: c[k] for p, c in file_launches.items()},
                   **{p: c[k] for p, c in cli_launches.items()},
                   **{p: c[k] for p, c in calib_launches.items()}}
        if k in ("pyramid_reduce_slab", "band_pooled_halo"):
            n_main = shard_launches["sharded_4k_video"][k]
        elif k == "band_pooled_d_halo":
            n_main = shard_launches["sharded_hm_720p_image"][k]
        elif k in ("interleave", "concat", "deinterleave"):
            n_main = il_launches["interleave_bench"][k]
        elif k in ("ingest_replicate", "ingest_head"):
            n_main = sum(c[k] for c in ml_launches.values())
        elif k == "band_pooled":
            n_main = launches[k]
        else:
            n_main = (heat_launches if k == "band_pooled_d" else
                      train_launches if k in train_path else launches)[k]
        line.append({"name": k, "route": "cuda", "source": src + f, "replaces": rep,
                     "launches": n_main, "launches_by_path": by_path, **rows[k]})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
