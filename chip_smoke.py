"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it builds the kernels from ``csrc/`` itself.

Phase 0  card, power limit, torch and CUDA versions; constructing a metric
         must leave the TF32 flags as they were, and inside a metric call
         (``_process_block``) both must be off.
Phase 1  build the kernel library.
Phase 2  every kernel against its plain PyTorch version on the card, at the
         shapes the 4K main path gives it (the first block of the 4K clip),
         on seeded random frames, and the loss path's CSF LUT, its backward
         and the blur at the shapes of phase 5: the worst relative error of
         any channel against the stated tolerance, kernel and plain times
         (CUDA events, median of 5).
Phase 3  the 4K HDR clip (3840x2160, 32 frames, 30 fps, seed 7,
         standard_hdr_pq) through ``cvvdp.predict`` with the kernels, then
         with ``enable_fused_kernels = False``. Every kernel must have
         launched, the two JODs must agree within 1e-3 and the JOD must be
         within 0.01 of 7.8784, the value the reference metric gives. Then
         the host relayout of the input arrays and the block loop are timed
         apart.
Phase 4  a 1920x1080 sRGB image pair on standard_fhd (the image step, C = 3).
Phase 5  a training step at full width: ``get_loss_fn(1080, 1920)`` on
         standard_fhd with 4 seeded sRGB pairs (seed 11). First the reduce
         and band masking kernels against their plain versions on every
         pyramid level and band launch of that batch. Loss and gradient
         with the kernels, then with ``enable_fused_kernels = False``; every
         kernel of the loss path (reduce, band masking, CSF LUT forward and
         backward, blur) must have launched; then three Adam steps on a leaf
         copy of the test batch must lower the loss. Forward+backward ms per
         step (median of 5) both ways, and the peak memory.
Phase 6  the heatmap. First the D mode of the band kernel against its plain
         version at the shapes of the runs below: 4K band 0 at the block
         length, the launch that takes the smallest 4K bands together (C = 4),
         and band 0 and the 6-row band of a 1280x720 image (C = 3; the 6-row
         band takes no masking blur, the band_masking_d_noblur launch). Then
         ``predict`` with heatmap="raw" and "supra-threshold" on 12 frames of
         the phase-3 content (3840x2160, standard_hdr_pq; 32 frames cut to 12
         to fit the time limit) with ``gpu_mem`` set for 8-frame blocks, so
         that the clip runs as one full and one trailing partial block, and
         with heatmap="threshold" on the 1280x720 image (standard_4k). Each
         with the kernels, then plain: equal block lengths, heatmaps within
         1.1e-3 (one float16 quantum and a rounding), JODs within 1e-3, and
         the 4K JOD with a heatmap within 1e-4 of the pooled-only JOD.
Phase 7  the non-default configurations, each a copy of the default
         cvvdp_parameters.json with one or two keys changed, written to a
         temporary directory and passed as ``config_paths``. First the
         contrast-band mode of the band kernel against its plain version,
         pooled and D, at 4K band 0 (1, 8, 8, 2160, 3840) of the weber_g0_ref
         decomposition and at the launch that takes its smallest bands; the
         log-LMS mode of the ingest kernel at 8 frames of 4K; the blur kernel
         at the texture models' 33 taps on (3, 1080, 1920). Then ``predict``
         on 12 frames of the phase-3 content (BFCHW, 8-frame blocks) with
         contrast weber_g0_ref and with log, kernels then plain (JODs within
         1e-3; ingest, reduce, the contrast mode and the CSF LUT must have
         launched); a log-contrast "raw" heatmap of the 720p image of phase 6
         (the D mode on contrast bands); a FHD image with
         mult-transducer-texture (the generic chain: CSF LUT and 33-tap blur
         kernels); and a ``get_loss_fn(1080, 1920)`` step of 2 pairs with
         weber_g0_ref: loss within 1e-4, gradient within 1e-4 of max|g|.

Phase 8  the ColorVideoVDP-ML metrics. First the ingest kernel's first-block
         modes, "replicate" and "head", against their plain version
         (``ingest_first_plain``) and against tail mode fed the tails that
         ``cvvdp`` forms, at (1, 8, 3, 2160, 3840) uint8 on standard_hdr_pq.
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

Phase 9  the band mega-kernel route (``use_band_mega``). First the fused
         mode of the band kernel, pooled (``band_fused``) and D
         (``band_fused_d``), against its plain version and against the
         default raw-pair route fed the plain expand, at 4K band 0
         (1, 8, 8, 2160, 3840) and at an off-grid 1081x1921 band; its time
         beside the default route's (plain expand + ``band_masking``).
         Then ``predict`` on the phase-6 12-frame 4K content (BFCHW, 8-frame
         blocks) with ``use_band_mega``, pooled and with heatmap "raw",
         kernels then plain, against the default route: JODs within 1e-3
         (kernels vs plain) and 1e-4 (vs the default route), the heatmap
         within 1.1e-3; the fused mode must launch once per block (band 0,
         the one 4K band the gate admits). Then a B = 1
         ``get_loss_fn(2160, 3840)`` step on standard_4k with
         ``use_band_mega``: loss within 1e-4 and gradient within 1e-4 of
         max|g| against plain and against the default route.
Phase 10 the interleave micro-benchmark
         (``colorvideovdp_tpu_torch/tools/interleave_bench.py``) at its shape
         (48, 2160, 3840): interleave, concat and de-interleave bit for bit
         against their plain versions, then timed against their plain
         versions, the PyTorch calls that compute them, the copy floor and
         the bound.

Phase 11 multi-device scoring (``colorvideovdp_tpu_torch/parallel``). First
         the reduce kernel's slab mode (``pyramid_reduce_slab``, bit for bit)
         and the band kernel's halo mode (``band_masking_halo``, pooled sums
         within 1e-4 relative) against their plain versions at every launch
         shape the sharded run gives them, rank 0's and rank 1's: 16-frame
         blocks of 4K on a (1, 2) mesh, the slab reduce at levels 0-2
         (level 0 (128, 1096, 3840)) and the halo mode at bands 0-3 as
         ``band_groups`` packs them; timed at level 0 and the first halo
         launch, with their bounds; each launch's two ranks' halo sums against
         the whole bands'. Then the phase-3 clip (BFCHW, so no host relayout)
         through ``shard_video_fn`` on a (1, 2) mesh via ``run_ranks``: NCCL
         with one rank per card where there are two or more cards, else two
         gloo ranks sharing card 0, ``gpu_mem`` set for the same 16-frame
         blocks (each rank's must be 16 frames). The JOD must be within 0.01
         of 7.8784 and within 1e-4 of phase 3's, on every rank, and both new
         modes, ingest (replicate and tail), reduce, band masking and the CSF
         LUT must have launched on every rank. Each rank's set-up (groups,
         metric, kernel library, one collective per group) is timed apart
         from its block loop, and each block is timed.

Every kernel's row also carries its bound: the least time the card could
take for the same work, the larger of the bytes it must move (each input
read once, each output written once) over the HBM rate and its float32
operations (a transcendental counts as one) over the non-tensor float32
peak, both from the published H100 SXM figures at 700 W.

Any failure raises (non-zero exit). The last line of standard output is a
JSON object naming the device; the line before it is the card's name and
power limit, and the one before that lists the kernels.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

CLIP_JOD = 7.8784  # the reference metric's JOD for the 4K HDR clip
TOL = {"ingest": 1e-5, "pyramid_reduce": 1e-6, "band_masking": 1e-4, "csf_lut": 1e-5,
       "csf_lut_bwd": 1e-5, "blur": 1e-5, "band_masking_d": 1e-5, "band_masking_d_noblur": 1e-5,
       "band_masking_contrast": 1e-4, "band_masking_contrast_d": 1e-5,
       "ingest_replicate": 1e-5, "ingest_head": 1e-5, "band_fused": 1e-4, "band_fused_d": 1e-5,
       "interleave": 0.0, "concat": 0.0, "deinterleave": 0.0,
       "pyramid_reduce_slab": 0.0, "band_masking_halo": 1e-4}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
# Training step bounds (phase 5): kernels against plain on the card.
LOSS_TOL, GRAD_TOL = 1e-4, 1e-4
# Heatmap bounds (phase 6): float16 heatmaps kernels against plain, and the
# JOD with a heatmap against the pooled-only JOD.
HEATMAP_TOL, HEATMAP_JOD_TOL = 1.1e-3, 1e-4
# ML metrics (phase 8): kernels against plain.
ML_JOD_TOL = 1e-3
# The mega-kernel route (phase 9): JOD against the default route.
MEGA_JOD_TOL = 1e-4
# Multi-device scoring (phase 11): JOD against single-device scoring.
SHARD_JOD_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def clip_content(H, W, N, rng):
    """Synthetic HDR content (H, W, 3, N) uint8: a gradient plus noise."""
    from colorvideovdp_tpu_torch.tools.clips import hdr_clip

    return hdr_clip(H, W, N, rng)


def time_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_err_per(a, b, dim):
    """The worst relative error over the slices along ``dim`` (channels),
    each held to its own scale so that a small channel cannot hide."""
    a, b = a.movedim(dim, 0).flatten(1), b.movedim(dim, 0).flatten(1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1e-30)).max())


def max_abs(a, b):
    return float((a - b).abs().max())


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def check(name, err, tol):
    log(f"  {name}: max error {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


# The kernels the heatmap path launches (phase 6).
HEAT_PATH = ("ingest", "pyramid_reduce", "csf_lut", "band_masking_d", "band_masking_d_noblur")


def phase_heatmap(m, fps, rows, record, counters, gen):
    """Phase 6; returns the kernels' launch counts of the heatmap run."""
    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.kernels import ingest, masking_fused
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
    from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

    dev = torch.device("cuda")
    H, W, N, blk = 2160, 3840, 12, 8
    Hi, Wi = 720, 1280
    t_phase = time.time()
    # gpu_mem for 8-frame blocks under the port's block model (estimate_block_N:
    # a = 1.6e9, b = 16, c = 320 bytes per pixel).
    pix = H * W
    gpu_mem = (1.6e9 + pix * (m.filter_len - 1) * 16 + pix * 336 * (blk + 0.5)) / 1e9
    probe = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                      gpu_mem=gpu_mem)
    probe.filter_len = m.filter_len
    if probe.estimate_block_N(pix, N) != blk:
        raise AssertionError(f"gpu_mem {gpu_mem} does not give {blk}-frame blocks")

    # The D mode against its plain version (these launches are not counted).
    def hold_d(name, fn, args, shape_note):
        D_k = fn(*args)
        D_p = masking_fused.band_masking_d_plain(*args)
        err = max(rel_err_per(a, b, 1) for a, b in zip(D_k, D_p))
        abs_err = max(max_abs(a, b) for a, b in zip(D_k, D_p))
        check(f"{name} {shape_note}", err, TOL[name])
        return D_k, err, abs_err

    dm = m.display_photometry
    F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
    filt = np.stack([f[::-1] for f in F_taps])
    raws = [torch.randint(0, 256, (1, blk, 3, H, W), dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(2)]
    tails = [ingest.raw_to_met(dm, r[:, :1]).expand(-1, -1, m.filter_len - 1, -1, -1)
             .contiguous() for r in raws]
    R = ingest.ingest(tails[0], tails[1], raws[0], raws[1], dm, filt)[0]
    del raws, tails
    m._ensure_pyramids(W, H)
    consts, luts = m._band_tables(4)
    E0 = pyr.gausspyr_expand(prd.pyramid_reduce(R), (H, W))
    band0 = ([R], [E0], luts[0:1], [1.0], consts)
    D_k, err_wide, abs_wide = hold_d("band_masking_d", masking_fused.band_masking_d, band0,
                                     f"4K band 0 {tuple(R.shape)}")
    k_wide = time_ms(lambda: masking_fused.band_masking_d(*band0))
    p_wide = time_ms(lambda: masking_fused.band_masking_d_plain(*band0))
    # Per pixel and channel about 90 operations: contrast + LUT ~20, the
    # 2 x 13-tap blur 52, the transducer ~18.
    b_wide = bound(nbytes(R, E0, luts[0:1]) + nbytes(*D_k), 90 * R.numel() // 2)
    del D_k, E0, band0
    bands, _ = m.lpyr.decompose(R, raw_pairs=True, use_kernel=False)
    shapes = [b[0].shape[-2:] for b in bands[:-1]]
    blurs = [consts.params.blurs(int(h), int(w)) for h, w in shapes]
    groups = masking_fused.band_groups(shapes, 1, 4, blk, blurs)
    log(f"phase 6: band_masking_d launches per 4K block: {groups}")
    stacked = groups[-1]
    gis = [bands[bb][0] for bb in stacked]
    Es = [pyr.gausspyr_expand(bands[bb][1], gi.shape[-2:]) for bb, gi in zip(stacked, gis)]
    stack = (gis, Es, luts[stacked[0]:stacked[-1] + 1], [2.0] * len(stacked), consts)
    _, err_stack, _ = hold_d("band_masking_d", masking_fused.band_masking_d, stack,
                             f"4K bands {stacked} {[tuple(g.shape[-2:]) for g in gis]}")
    b_stack = bound(nbytes(*gis, *Es, stack[2]) + nbytes(*gis) // 2,
                    90 * sum(g.numel() for g in gis) // 2)
    log(f"  band_masking_d 4K stacked launch: kernel "
        f"{time_ms(lambda: masking_fused.band_masking_d(*stack)):.3f} ms, plain "
        f"{time_ms(lambda: masking_fused.band_masking_d_plain(*stack)):.3f} ms, "
        f"bound {b_stack[0]:.4f} ms ({b_stack[1]})")
    del R, bands, gis, Es, stack

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

    def band_args(bb):
        gi = bands_i[bb][0]
        return ([gi], [pyr.gausspyr_expand(bands_i[bb][1], gi.shape[-2:])],
                luts_i[bb:bb + 1], [1.0 if bb == 0 else 2.0], consts_i)

    a0 = band_args(0)
    _, err_i0, _ = hold_d("band_masking_d", masking_fused.band_masking_d, a0,
                          f"720p band 0 {tuple(a0[0][0].shape)}")
    record("band_masking_d", max(err_wide, err_stack, err_i0), abs_wide, k_wide, p_wide,
           b_wide)
    an = band_args(noblur[0])
    D_n, err_n, abs_n = hold_d("band_masking_d_noblur", masking_fused.band_masking_d_noblur,
                               an, f"720p band {noblur[0]} {tuple(an[0][0].shape)}")
    # The same ~90 operations less the blur's 52.
    record("band_masking_d_noblur", err_n, abs_n,
           time_ms(lambda: masking_fused.band_masking_d_noblur(*an)),
           time_ms(lambda: masking_fused.band_masking_d_plain(*an)),
           bound(nbytes(*an[0], *an[1], an[2]) + nbytes(*D_n), 38 * an[0][0].numel() // 2))
    del Ri, bands_i, a0, an, D_n
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


def phase_configs(m, fps, record, counters, gen):
    """Phase 7; returns the kernels' launch counts per path."""
    import shutil
    import tempfile

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d
    from colorvideovdp_tpu_torch.ops.kernels import blur as blr
    from colorvideovdp_tpu_torch.ops.kernels import ingest, masking_fused
    from colorvideovdp_tpu_torch.ops.pyramid import LaplacianPyramid
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
        gpu_mem = (1.6e9 + pix * (m.filter_len - 1) * 16 + pix * 336 * (blk + 0.5)) / 1e9
        launches = {}

        # The contrast-band mode against its plain version at the 4K shapes of
        # the weber_g0_ref decomposition (these launches are not counted).
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
        del out_k, out_p, args, log_tails
        tails = [ingest.raw_to_met(dm, r[:, :1]).expand(-1, -1, fl - 1, -1, -1).contiguous()
                 for r in raws]
        R = ingest.ingest(*tails, *raws, dm, filt)[0]
        del raws, tails
        mg._ensure_pyramids(W, H)
        consts, luts = mg._band_tables(4)
        bands, L_bkg = mg.lpyr.decompose(R, raw_pairs=False, use_kernel=False)
        del R

        def contrast_args(sel):
            return ([LaplacianPyramid.get_band(bands, bb) for bb in sel],
                    [L_bkg[bb] for bb in sel], luts[sel[0]:sel[-1] + 1], consts)

        def hold(sel):
            a = contrast_args(sel)
            ones = [1.0] * len(sel)
            s_k = masking_fused.band_masking_contrast(*a)
            s_p = masking_fused.band_masking_plain(*a[:3], ones, consts, True)
            q_k, q_p = ([masking_fused.pooled_norm(s[j], *x.shape[-2:], mg.beta)
                         for j, x in enumerate(a[0])] for s in (s_k, s_p))
            err_s = max(rel_err_per(x, y, 1) for x, y in zip(q_k, q_p))
            D_k = masking_fused.band_masking_contrast_d(*a)
            D_p = masking_fused.band_masking_d_plain(*a[:3], ones, consts, True)
            err_d = max(rel_err_per(x, y, 1) for x, y in zip(D_k, D_p))
            abs_s = max(max_abs(x, y) for x, y in zip(q_k, q_p))
            abs_d = max(max_abs(x, y) for x, y in zip(D_k, D_p))
            note = f"bands {sel} {[tuple(x.shape[-2:]) for x in a[0]]}"
            check(f"band_masking_contrast {note}", err_s, TOL["band_masking_contrast"])
            check(f"band_masking_contrast_d {note}", err_d, TOL["band_masking_contrast_d"])
            return a, D_k, err_s, err_d, abs_s, abs_d

        shapes = [b.shape[-2:] for b in bands[:-1]]
        groups = masking_fused.band_groups(shapes, 1, 4, blk, contrast=True)
        log(f"phase 7: contrast-band launches per 4K block: {groups}")
        a_s, _, err_ss, err_ds, _, _ = hold(groups[-1])
        n_s = sum(x.numel() for x in a_s[0]) // 2
        b_s = bound(nbytes(*a_s[0], *a_s[1], a_s[2]) + 4 * 4 * blk * len(a_s[0]), 90 * n_s)
        ones = [1.0] * len(a_s[0])
        log(f"  band_masking_contrast smallest-bands launch: kernel "
            f"{time_ms(lambda: masking_fused.band_masking_contrast(*a_s)):.3f} ms, plain "
            f"{time_ms(lambda: masking_fused.band_masking_plain(*a_s[:3], ones, consts, True)):.3f}"
            f" ms, bound {b_s[0]:.4f} ms ({b_s[1]})")
        del a_s
        a0, D0, err_s0, err_d0, abs_s0, abs_d0 = hold([0])
        # Per pixel and channel about 90 operations: contrast + LUT ~16, the
        # 2 x 13-tap blur 52, transducer and pooling ~22.
        n0 = a0[0][0].numel() // 2
        record("band_masking_contrast", max(err_s0, err_ss), abs_s0,
               time_ms(lambda: masking_fused.band_masking_contrast(*a0)),
               time_ms(lambda: masking_fused.band_masking_plain(*a0[:3], [1.0], consts, True)),
               bound(nbytes(*a0[0], *a0[1], a0[2]) + 4 * 4 * blk, 90 * n0))
        record("band_masking_contrast_d", max(err_d0, err_ds), abs_d0,
               time_ms(lambda: masking_fused.band_masking_contrast_d(*a0)),
               time_ms(lambda: masking_fused.band_masking_d_plain(*a0[:3], [1.0], consts, True)),
               bound(nbytes(*a0[0], *a0[1], a0[2]) + nbytes(*D0), 90 * n0))
        del a0, D0, bands, L_bkg
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        # The texture models' blur: 33 taps, radius 16.
        taps33 = gaussian_kernel1d(33, 8.0)
        xb = torch.rand((3, 1080, 1920), device=dev, generator=gen)
        y_k, y_p = blr.blur(xb, taps33), blur_plain(xb, taps33)
        check("blur 33 taps (3, 1080, 1920)", float((y_k - y_p).abs().max() / y_p.abs().max()),
              TOL["blur"])
        b33 = bound(nbytes(xb, y_k), 132 * xb.numel())
        k33 = time_ms(lambda: blr.blur(xb, taps33))
        log(f"  blur 33 taps (3, 1080, 1920): max abs error {max_abs(y_k, y_p):.3e}, kernel "
            f"{k33:.3f} ms, plain {time_ms(lambda: blur_plain(xb, taps33)):.3f} ms, bound "
            f"{b33[0]:.4f} ms ({b33[1]}, {100 * b33[0] / k33:.1f}% of it)")
        del xb, y_k, y_p

        # predict with the two contrasts on the contrast-band route.
        V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
        V_test, V_ref = (np.ascontiguousarray(v.transpose(3, 2, 0, 1)[None])
                         for v in (V_test, V_ref))
        contrast_path = ("ingest", "pyramid_reduce", "band_masking_contrast", "csf_lut")
        for name in ("weber_g0_ref", "log"):
            jods = {}
            for fused in (True, False):
                mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                               gpu_mem=gpu_mem, config_paths=cfg[name])
                mv.enable_fused_kernels = fused
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                for fn in counters.values():
                    fn.launches = 0
                t0 = time.time()
                Q, st = mv.predict(V_test, V_ref, dim_order="BFCHW", frames_per_second=fps)
                jods[fused] = float(Q)
                torch.cuda.synchronize()
                dt = time.time() - t0
                counts = {k: fn.launches for k, fn in counters.items()}
                if fused:
                    launches[f"{name}_4k_video"] = counts
                log(f"phase 7: {name} {'kernels' if fused else 'plain  '}: JOD {jods[fused]:.6f}, "
                    f"blk {st['block_N_frames']}, {dt:.3f} s, launches "
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
        if launches["log_heatmap_720p_image"]["band_masking_contrast_d"] <= 0:
            raise AssertionError("band_masking_contrast_d was not launched on the heatmap path")

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
        if launches["train_fhd_weber_g0_ref"]["band_masking_contrast"] <= 0:
            raise AssertionError("band_masking_contrast was not launched on the training path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 7: {time.time() - t_phase:.1f} s")
    return launches


def seeded_ml_weights(seed):
    """Weights with every key and shape of the published checkpoints
    (``tools/cvvdp_ml_manifest.json``, both ML families): Linear weights
    uniform in +-1/sqrt(fan_in) (non-negative in the MLPs' last layers, so
    that the saliency head's two ReLU outputs respond), biases uniform in
    +-0.3, LayerNorm gains near 1, the class token standard normal."""
    with open("tools/cvvdp_ml_manifest.json") as f:
        manifest = json.load(f)
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
    # mode on the tails cvvdp forms (these launches are not counted).
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
    gpu_mem = (1.6e9 + pix * (fl - 1) * 16 + pix * 336 * (blk + 0.5)) / 1e9
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


def phase_mega(m, fps, record, counters, gen):
    """Phase 9; returns the kernels' launch counts per path."""
    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.kernels import band_fused as bf
    from colorvideovdp_tpu_torch.ops.kernels import ingest, masking_fused
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
    from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

    dev = torch.device("cuda")
    H, W, N, blk = 2160, 3840, 12, 8
    t_phase = time.time()
    launches = {}

    # The fused mode against its plain version and against the default
    # raw-pair route fed the plain expand (these launches are not counted):
    # 4K band 0 of an 8-frame block, and an off-grid band called directly.
    dm = m.display_photometry
    F_taps, _ = get_temporal_filters(fps, m.sigma_tf, m.beta_tf, m.temp_filter)
    filt = np.stack([f[::-1] for f in F_taps])
    raws = [torch.randint(0, 256, (1, blk, 3, H, W), dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(2)]
    tails = [ingest.raw_to_met(dm, r[:, :1]).expand(-1, -1, m.filter_len - 1, -1, -1)
             .contiguous() for r in raws]
    gi = ingest.ingest(tails[0], tails[1], raws[0], raws[1], dm, filt)[0]
    del raws, tails
    m._ensure_pyramids(W, H)
    consts, luts = m._band_tables(4)
    cases = [("4K band 0", gi, prd.pyramid_reduce(gi), luts[0], 1.0)]
    g_off = torch.rand((1, 8, 2, 1081, 1921), device=dev, generator=gen) * 40 + 10
    cases.append(("off-grid", g_off, prd.pyramid_reduce(g_off), luts[1], 2.0))
    errs = {"band_fused": [0.0, 0.0], "band_fused_d": [0.0, 0.0]}
    for note, g, gn, lut, mul in cases:
        E = pyr.gausspyr_expand(gn, g.shape[-2:])
        args = (g, gn, lut, mul, consts)
        s_k = bf.band_fused(*args)
        s_r = masking_fused.band_masking([g], [E], lut[None], [mul], consts)[0]
        s_p = bf.band_fused_plain(*args)
        h, w = g.shape[-2:]
        q_k, q_r, q_p = (masking_fused.pooled_norm(x, h, w, m.beta) for x in (s_k, s_r, s_p))
        D_k = bf.band_fused_d(*args)
        D_r = masking_fused.band_masking_d([g], [E], lut[None], [mul], consts)[0]
        D_p = bf.band_fused_d_plain(*args)
        d_route = (max_abs(q_k, q_r), max_abs(D_k, D_r))
        log(f"  mega {note} {tuple(g.shape)}: |fused - default route fed plain E| pooled "
            f"{d_route[0]:.3e}, D {d_route[1]:.3e} (expected 0)")
        check(f"band_fused {note} vs the default route", max(d_route), 0.0)
        err_s, err_d = rel_err_per(q_k, q_p, 1), rel_err_per(D_k, D_p, 1)
        check(f"band_fused {note}", err_s, TOL["band_fused"])
        check(f"band_fused_d {note}", err_d, TOL["band_fused_d"])
        for key, e, a in (("band_fused", err_s, max_abs(q_k, q_p)),
                          ("band_fused_d", err_d, max_abs(D_k, D_p))):
            errs[key] = [max(errs[key][0], e), max(errs[key][1], a)]
        if note == "4K band 0":
            args0, E0, D0 = args, E, D_k
        del E, s_k, s_r, s_p, D_k, D_r, D_p
    del cases, g_off
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    g, gn, lut = args0[0], args0[1], args0[2]
    # Bytes: the 2C planes of gi and the 2C quarter planes of gn read once,
    # C pooled floats (or the C planes of D) written. Operations per pixel
    # and channel about 115: the default route's ~95 plus the expand of two
    # planes (~10 per sample each).
    n_ops = 115 * g.numel() // 2
    b_s = bound(nbytes(g, gn, lut) + 4 * 4 * blk, n_ops)
    b_d = bound(nbytes(g, gn, lut, D0), n_ops)
    del D0
    route_s = time_ms(lambda: masking_fused.band_masking(
        [g], [pyr.gausspyr_expand(gn, (H, W))], lut[None], [1.0], consts))
    route_d = time_ms(lambda: masking_fused.band_masking_d(
        [g], [pyr.gausspyr_expand(gn, (H, W))], lut[None], [1.0], consts))
    k_s = time_ms(lambda: bf.band_fused(*args0))
    k_d = time_ms(lambda: bf.band_fused_d(*args0))
    expand_ms = time_ms(lambda: pyr.gausspyr_expand(gn, (H, W)))
    log(f"phase 9: 4K band 0 {tuple(g.shape)}: fused pooled {k_s:.3f} ms, D {k_d:.3f} ms; "
        f"default route (plain expand {expand_ms:.3f} ms + band_masking) pooled "
        f"{route_s:.3f} ms, D {route_d:.3f} ms")
    record("band_fused", *errs["band_fused"], k_s, time_ms(lambda: bf.band_fused_plain(*args0)),
           b_s)
    record("band_fused_d", *errs["band_fused_d"], k_d,
           time_ms(lambda: bf.band_fused_d_plain(*args0)), b_d)
    del args0, E0, g, gn, gi
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # predict with the mega route, pooled and with a raw heatmap, against
    # plain and against the default route.
    pix = H * W
    gpu_mem = (1.6e9 + pix * (m.filter_len - 1) * 16 + pix * 336 * (blk + 0.5)) / 1e9
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    V_test, V_ref = (np.ascontiguousarray(v.transpose(3, 2, 0, 1)[None]) for v in (V_test, V_ref))
    res = {}
    for hm in (None, "raw"):
        for mega, fused in ((True, True), (True, False), (False, True)):
            mv = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                           heatmap=hm, gpu_mem=gpu_mem)
            mv.use_band_mega, mv.enable_fused_kernels = mega, fused
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.time()
            Q, st = mv.predict(V_test, V_ref, dim_order="BFCHW", frames_per_second=fps)
            jod = float(Q)
            torch.cuda.synchronize()
            dt = time.time() - t0
            counts = {k: fn.launches for k, fn in counters.items()}
            path = f"mega_{'heatmap_' if hm else ''}4k_video"
            if mega and fused:
                launches[path] = counts
            res[(hm, mega, fused)] = (jod, st.get("heatmap"), st["block_N_frames"])
            log(f"phase 9: {'mega   ' if mega else 'default'} {'kernels' if fused else 'plain  '}"
                f" heatmap {hm}: JOD {jod:.6f}, blk {st['block_N_frames']}, {dt:.3f} s, peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
                f"{ {k: v for k, v in counts.items() if v} }")
        (jk, hk, bk), (jp, hp, _), (jd, hd, _) = (res[(hm, True, True)], res[(hm, True, False)],
                                                   res[(hm, False, True)])
        key = "band_fused_d" if hm else "band_fused"
        n_blocks = -(-N // bk)
        log(f"phase 9: heatmap {hm}: |JOD mega kernels - plain| {abs(jk - jp):.2e}, "
            f"|JOD mega - default route| {abs(jk - jd):.2e} (tolerance {MEGA_JOD_TOL:.0e}), "
            f"{key} launches {launches[path][key]} for {n_blocks} blocks")
        if not (math.isfinite(jk) and abs(jk - jp) <= 1e-3 and abs(jk - jd) <= MEGA_JOD_TOL):
            raise AssertionError(f"mega route heatmap {hm}: JODs {jk}, {jp}, {jd} disagree")
        if launches[path][key] != n_blocks:
            raise AssertionError(f"{key} launched {launches[path][key]} times for {n_blocks} blocks")
        if hm:
            d_hm = max(float(np.abs(hk.astype(np.float32) - h2.astype(np.float32)).max())
                       for h2 in (hp, hd))
            log(f"phase 9: mega heatmap max |kernels - plain or default route| {d_hm:.3e} "
                f"(tolerance {HEATMAP_TOL:.1e})")
            if not d_hm <= HEATMAP_TOL:
                raise AssertionError("mega route heatmap disagrees")
    del V_test, V_ref, res
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # A 4K training step with the mega route.
    rng = np.random.RandomState(11)
    ref_np = rng.rand(1, 3, 1, H, W).astype(np.float32)
    test_np = np.clip(ref_np + rng.randn(*ref_np.shape).astype(np.float32) * 0.1, 0, 1)
    ref_t, test_t = torch.from_numpy(ref_np).to(dev), torch.from_numpy(test_np).to(dev)
    del ref_np, test_np
    out = {}
    for mega, fused in ((True, True), (True, False), (False, True)):
        mt = cvt.cvvdp(display_name="standard_4k", device="cuda", quiet=True)
        mt.use_band_mega, mt.enable_fused_kernels = mega, fused
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
        out[(mega, fused)] = (float(v.detach()), gx)
        if mega and fused:
            launches["mega_train_4k_image"] = {k: fn.launches for k, fn in counters.items()}
        log(f"phase 9: 4K training step {'mega   ' if mega else 'default'} "
            f"{'kernels' if fused else 'plain  '}: loss {float(v.detach()):.6f}, {dt:.3f} s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del loss_fn, mt, x, v
    (vk, gk) = out[(True, True)]
    if not (torch.isfinite(gk).all() and gk.abs().max() > 0):
        raise AssertionError("mega training gradient is not finite and non-zero")
    for key, name in (((True, False), "plain"), ((False, True), "the default route")):
        d_loss = abs(vk - out[key][0])
        d_grad = float((gk - out[key][1]).abs().max() / out[key][1].abs().max())
        log(f"phase 9: mega training step vs {name}: |dloss| {d_loss:.3e}, max |dgrad| / max "
            f"|grad| {d_grad:.3e} (tolerances {LOSS_TOL:.0e}, {GRAD_TOL:.0e})")
        if not (d_loss <= LOSS_TOL and d_grad <= GRAD_TOL):
            raise AssertionError(f"mega training step disagrees with {name}")
    # Once in the forward, once in the checkpointed block's recompute.
    if launches["mega_train_4k_image"]["band_fused"] != 2:
        raise AssertionError(f"band_fused launched {launches['mega_train_4k_image']['band_fused']}"
                             " times on the training step, not 2")
    log(f"phase 9: {time.time() - t_phase:.1f} s")
    return launches


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
              "band_masking", "band_masking_halo", "csf_lut")
# Frames per block of the sharded run; phase 11 holds the kernels at its shapes.
SHARD_BLOCK = 16


def phase_sharded(m, fps, record, jod_single, gen):
    """Phase 11; returns the launch counts of the sharded run, summed over
    the ranks."""
    import os
    import shutil
    import tempfile
    from types import SimpleNamespace

    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd
    from colorvideovdp_tpu_torch.parallel import run_ranks
    from colorvideovdp_tpu_torch.parallel import sharding as sh

    t_phase = time.time()
    H, W, N, blk, n_sp = 2160, 3840, 32, SHARD_BLOCK, 2
    r = bm.HALO_ROWS
    dev = torch.device("cuda")

    def slab(x, s, edge):
        """Rank s's slab of x with 8 rows of each neighbour, and at a global
        edge zeros (the reduce) or the exclude-edge reflection (the band)."""
        h_loc = x.shape[-2] // n_sp
        lo, hi = s * h_loc, (s + 1) * h_loc
        z = torch.zeros_like(x[..., :r, :])
        above = x[..., lo - r:lo, :] if s > 0 else (z if edge == "zero"
                                                     else x[..., 1:r + 1, :].flip(-2))
        below = x[..., hi:hi + r, :] if s < n_sp - 1 else (z if edge == "zero"
                                                           else x[..., -r - 1:-1, :].flip(-2))
        return torch.cat([above, x[..., lo:hi, :], below], dim=-2).contiguous()

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
        [(shapes[bb][0] // n_sp + 2 * r, shapes[bb][1]) for bb in halo], 1, 4, blk)]
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

    # The halo mode at every launch it takes, C = 4; per group, the two
    # ranks' sums against the whole bands' pooled mode.
    consts, luts = m._band_tables(4)
    errs, abs_errs = [], []
    for g, sel in enumerate(groups):
        gis = [torch.rand((1, 8, blk) + tuple(shapes[bb]), device=dev, generator=gen) * 20 + 30
               for bb in sel]
        Es = [gi + torch.randn(gi.shape, device=dev, generator=gen) for gi in gis]
        muls = [1.0 if bb == 0 else 2.0 for bb in sel]
        whole = bm.band_masking(gis, Es, luts[sel], muls, consts)
        total = 0
        for s in range(n_sp):
            args = ([slab(gi, s, "reflect") for gi in gis], [slab(E, s, "reflect") for E in Es],
                    luts[sel], muls, consts, [shapes[bb][0] // n_sp for bb in sel])
            s_k, s_p = bm.band_masking_halo(*args), bm.band_masking_halo_plain(*args)
            errs.append(rel_err_per(s_k, s_p, 2))
            abs_errs.append(max_abs(s_k, s_p))
            total = total + s_k
            log(f"  band_masking_halo bands {sel} rank {s} "
                f"{[tuple(x.shape) for x in args[0]]}: error {errs[-1]:.3e}")
            if g == 0 and s == 0:
                k_ms = time_ms(lambda: bm.band_masking_halo(*args))
                p_ms = time_ms(lambda: bm.band_masking_halo_plain(*args))
                # As band_masking's bound (phase 2) on the slabs: gi and E read once.
                b_halo = bound(2 * nbytes(*args[0]) + nbytes(luts[sel], s_k),
                               sum(95 * x.numel() // 2 for x in args[0]))
        check(f"band_masking_halo bands {sel}: the ranks' sums against the whole bands",
              rel_err_per(total, whole, 2), TOL["band_masking_halo"])
        del gis, Es, args, s_k, s_p, whole, total
    record("band_masking_halo", max(errs), max(abs_errs), k_ms, p_ms, b_halo)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The 4K clip through shard_video_fn on a (1, 2) mesh.
    t0 = time.time()
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    tmp = tempfile.mkdtemp(prefix="cvvdp_phase11_")
    paths = [os.path.join(tmp, f"{k}.npy") for k in ("test", "reference")]
    for p, V in zip(paths, (V_test, V_ref)):
        np.save(p, np.ascontiguousarray(V.transpose(3, 2, 0, 1)[None]))  # (1, F, 3, H, W)
    del V_test, V_ref
    log(f"phase 11: BFCHW clip written in {time.time() - t0:.1f} s")
    n_cards = torch.cuda.device_count()
    share = 1 if n_cards >= n_sp else n_sp
    gpu_mem = m.block_gpu_mem(H // n_sp * W, blk, fps, share)
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
            f"{rr['block_loop_s']:.3f} s (blocks {[round(t, 3) for t in rr['block_s']]} s), "
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
    log(f"phase 11: {time.time() - t_phase:.1f} s")
    return {k: sum(rr["launches"][k] for rr in res) for k in res[0]["launches"]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d
    from colorvideovdp_tpu_torch.ops.kernels import (_build, counted_wrappers, csf_lut, ingest,
                                                     masking_fused)
    from colorvideovdp_tpu_torch.ops.kernels import blur as blr
    from colorvideovdp_tpu_torch.ops.kernels import pyramid_reduce as prd

    # ---- phase 0 ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(f"phase 0: card: {smi}")
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

    def record(name, err, abs_err, k_ms, p_ms, bnd, lib_ms=None):
        check(name, err, TOL[name])
        b_ms, b_by = bnd
        log(f"  {name}: max abs error {abs_err:.3e}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}, {100 * b_ms / k_ms:.1f}% of it), library "
            + ("none" if lib_ms is None else f"{lib_ms:.3f} ms"))
        rows[name] = dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms)

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
    del R_p, nt_p, nt_k, tails, raws, args

    y_k = prd.pyramid_reduce(R_k)
    y_p = pyr.reduce_plain(R_k)
    err = float((y_k - y_p).abs().max()) / max(1.0, float(y_p.abs().max()))
    # 5 taps vertically over (H/2, W), then 5 over (H/2, W/2): 7.5 H W per plane.
    record("pyramid_reduce", err, max_abs(y_k, y_p), time_ms(lambda: prd.pyramid_reduce(R_k)),
           time_ms(lambda: pyr.reduce_plain(R_k)),
           bound(nbytes(R_k, y_k), 7.5 * R_k.numel()))
    del y_p

    m._ensure_pyramids(W, H)
    consts, luts = m._band_tables(4)
    bands, L_bkg = m.lpyr.decompose(R_k, raw_pairs=True, use_kernel=False)
    groups = masking_fused.band_groups([b[0].shape[-2:] for b in bands[:-1]], 1, 4, blk)
    log(f"  band_masking launches per block: {groups}")
    E0 = pyr.gausspyr_expand(y_k, (H, W))
    band0 = ([R_k], [E0], luts[0:1], [1.0], consts)
    s_k = masking_fused.pooled_norm(masking_fused.band_masking(*band0), H, W, m.beta)
    s_p = masking_fused.pooled_norm(masking_fused.band_masking_plain(*band0), H, W, m.beta)
    err_wide = rel_err_per(s_k, s_p, 2)  # (band, B, C, F)
    abs_wide = max_abs(s_k, s_p)
    k_wide = time_ms(lambda: masking_fused.band_masking(*band0))
    p_wide = time_ms(lambda: masking_fused.band_masking_plain(*band0))
    del E0, y_k, band0
    stacked = groups[-1]  # the launch that takes the smallest bands together
    gis = [bands[bb][0] for bb in stacked]
    Es = [pyr.gausspyr_expand(bands[bb][1], gi.shape[-2:]) for bb, gi in zip(stacked, gis)]
    stack = (gis, Es, luts[stacked[0]:stacked[-1] + 1], [2.0] * len(stacked), consts)
    sk = masking_fused.band_masking(*stack)
    sp = masking_fused.band_masking_plain(*stack)
    err_narrow = max(rel_err_per(masking_fused.pooled_norm(sk[j], *gi.shape[-2:], m.beta),
                                 masking_fused.pooled_norm(sp[j], *gi.shape[-2:], m.beta), 1)
                     for j, gi in enumerate(gis))
    b_stack = bound(nbytes(*gis, *Es, stack[2]) + 4 * 4 * blk * len(gis),
                    95 * sum(g.numel() for g in gis) // 2)
    log(f"  band_masking stacked launch: bands {[tuple(g.shape[-2:]) for g in gis]}, "
        f"error {err_narrow:.3e}, kernel {time_ms(lambda: masking_fused.band_masking(*stack)):.3f} ms, "
        f"plain {time_ms(lambda: masking_fused.band_masking_plain(*stack)):.3f} ms, "
        f"bound {b_stack[0]:.4f} ms ({b_stack[1]})")
    log(f"  band_masking band 0 {tuple(R_k.shape)}: error {err_wide:.3e}")
    # Per pixel and channel about 95 operations: contrast + LUT ~20, the
    # 2 x 13-tap blur 52, transducer and pooling ~23.
    record("band_masking", max(err_wide, err_narrow), abs_wide, k_wide, p_wide,
           bound(2 * nbytes(R_k) + nbytes(luts[0:1]) + 4 * 4 * blk,
                 95 * R_k.numel() // 2))

    logL = L_bkg[-1].contiguous()  # the baseband's (1, 1, blk, 1, 1) log-luminance
    x0, x1 = m.csf.lut_range()
    lut_b = torch.as_tensor(np.stack([m.csf.logS_of_logL(0.1, m.omega[0 if cc < 3 else 1],
                                                         cc if cc < 3 else 0)
                                      for cc in range(4)]), device=dev)
    c_k = csf_lut.csf_lut(logL, lut_b, x0, x1)
    c_p = csf_lut.csf_lut_plain(logL, lut_b, x0, x1)
    check(f"csf_lut baseband {tuple(logL.shape)}",
          float(((c_k - c_p).abs() / c_p.abs()).max()), TOL["csf_lut"])
    log(f"  csf_lut baseband: kernel "
        f"{time_ms(lambda: csf_lut.csf_lut(logL, lut_b, x0, x1)):.3f} ms, plain "
        f"{time_ms(lambda: csf_lut.csf_lut_plain(logL, lut_b, x0, x1)):.3f} ms")
    del R_k, bands, L_bkg, gis, Es, stack
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The loss path's kernels at the shapes of phase 5 (B = 4, C = 3, FHD):
    # the CSF LUT over band 0's full log-luminance field (the recompute in the
    # band masking backward), its backward, and the phase-uncertainty blur.
    field = torch.empty((1, 1, 1080, 1920), device=dev).uniform_(x0 - 0.5, x1 + 0.5,
                                                                generator=gen)
    lut3 = lut_b[:3].contiguous()
    c_k = csf_lut.csf_lut(field, lut3, x0, x1)
    c_p = csf_lut.csf_lut_plain(field, lut3, x0, x1)
    n = field.numel()
    record("csf_lut", float(((c_k - c_p).abs() / c_p.abs()).max()), max_abs(c_k, c_p),
           time_ms(lambda: csf_lut.csf_lut(field, lut3, x0, x1)),
           time_ms(lambda: csf_lut.csf_lut_plain(field, lut3, x0, x1)),
           bound(nbytes(field, c_k, lut3), n * (4 + 5 * 3)))
    g = torch.randn((3,) + tuple(field.shape), device=dev, generator=gen)
    d_k = csf_lut.csf_lut_bwd(field, g, lut3, x0, x1)
    d_p = csf_lut.csf_lut_bwd_plain(field, g, lut3, x0, x1)
    record("csf_lut_bwd", float((d_k - d_p).abs().max() / d_p.abs().max()), max_abs(d_k, d_p),
           time_ms(lambda: csf_lut.csf_lut_bwd(field, g, lut3, x0, x1)),
           time_ms(lambda: csf_lut.csf_lut_bwd_plain(field, g, lut3, x0, x1)),
           bound(nbytes(field, g, lut3, d_k), n * (6 + 10 * 3)))
    del field, g, c_k, c_p, d_k, d_p
    taps = gaussian_kernel1d(13, 3.0)
    for shape in ((3, 135, 241), (12, 1080, 1920)):
        xb = torch.rand(shape, device=dev, generator=gen)
        y_k, y_p = blr.blur(xb, taps), blur_plain(xb, taps)
        err = float((y_k - y_p).abs().max() / y_p.abs().max())
        # The library yardstick: a depthwise 13x13 convolution with the
        # outer-product taps and reflect padding (cuDNN, TF32 off).
        conv = torch.nn.Conv2d(shape[0], shape[0], 13, groups=shape[0], padding=6,
                               padding_mode="reflect", bias=False).to(dev)
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(np.outer(taps, taps), device=dev)
                              .expand(shape[0], 1, 13, 13))
            y_l = conv(xb[None])[0]
            lib_ms = time_ms(lambda: conv(xb[None]))
        log(f"  blur {shape}: library conv max abs difference {max_abs(y_l, y_p):.3e}")
        k_ms = time_ms(lambda: blr.blur(xb, taps))
        p_ms = time_ms(lambda: blur_plain(xb, taps))
        b = bound(nbytes(xb, y_k), 52 * xb.numel())
        if shape[0] == 12:
            record("blur", err, max_abs(y_k, y_p), k_ms, p_ms, b, lib_ms)
        else:
            check(f"blur {shape}", err, TOL["blur"])
            log(f"  blur {shape}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
                f"bound {b[0]:.4f} ms, library {lib_ms:.3f} ms")
        del xb, y_k, y_p, y_l, conv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 3 ------------------------------------------------------------
    t0 = time.time()
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    log(f"phase 3: clip content made in {time.time() - t0:.1f} s")
    counters = counted_wrappers()
    score_path = ("ingest", "pyramid_reduce", "band_masking", "csf_lut")
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
        results[fused] = (jod, launches)
        log(f"phase 3: {'kernels' if fused else 'plain  '}: JOD {jod:.6f}, blk {stats['block_N_frames']}, "
            f"{N / dt:.2f} frames/s ({dt:.3f} s), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}")
    jod_k, launches = results[True]
    jod_p, _ = results[False]
    for k in score_path:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    if not abs(jod_k - jod_p) <= 1e-3:
        raise AssertionError(f"JOD kernels {jod_k} vs plain {jod_p}")
    if not abs(jod_k - CLIP_JOD) <= 0.01:
        raise AssertionError(f"JOD {jod_k} vs reference {CLIP_JOD}")
    log(f"phase 3: |JOD kernels - plain| = {abs(jod_k - jod_p):.2e}, "
        f"|JOD - {CLIP_JOD}| = {abs(jod_k - CLIP_JOD):.2e}")
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
        mv.predict_video_source(vs)
        torch.cuda.synchronize()
        t_loop = time.time() - t0
        log(f"phase 3: {'kernels' if fused else 'plain  '} split: host relayout {t_host:.3f} s, "
            f"block loop {t_loop:.3f} s = {N / t_loop:.2f} frames/s")
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
    for k in ("pyramid_reduce", "band_masking", "csf_lut"):
        if img_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the image path")

    del mi

    # ---- phase 5 ------------------------------------------------------------
    train_path = ("pyramid_reduce", "band_masking", "csf_lut", "csf_lut_bwd", "blur")
    Ht, Wt, Bt = 1080, 1920, 4
    rng = np.random.RandomState(11)
    ref_np = rng.rand(Bt, 3, 1, Ht, Wt).astype(np.float32)
    test_np = np.clip(ref_np + rng.randn(*ref_np.shape).astype(np.float32) * 0.1, 0, 1)
    ref_t, test_t = torch.from_numpy(ref_np).to(dev), torch.from_numpy(test_np).to(dev)
    del ref_np, test_np
    mt = cvt.cvvdp(display_name="standard_fhd", device="cuda", quiet=True)
    loss_fn = mt.get_loss_fn(Ht, Wt)

    # The reduce and band masking kernels against their plain versions at
    # the shapes this phase gives them: every pyramid level of the batch and
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
                                             Bt, 3, 1):
            gis = [bands_t[bb][0] for bb in sel]
            Es = [pyr.gausspyr_expand(bands_t[bb][1], gi.shape[-2:])
                  for bb, gi in zip(sel, gis)]
            args = (gis, Es, luts_t[sel[0]:sel[-1] + 1],
                    [1.0 if bb == 0 else 2.0 for bb in sel], consts_t)
            sk, sp = masking_fused.band_masking(*args), masking_fused.band_masking_plain(*args)
            err = max(err, max(rel_err_per(masking_fused.pooled_norm(sk[j], *gi.shape[-2:],
                                                                     mt.beta),
                                           masking_fused.pooled_norm(sp[j], *gi.shape[-2:],
                                                                     mt.beta), 1)
                               for j, gi in enumerate(gis)))
        check(f"band_masking, every band of {tuple(Rt.shape)}", err, TOL["band_masking"])
        del Rt, bands_t, gis, Es, args, sk, sp
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
    (v_k, g_k, train_launches), (v_p, g_p, _) = train[True], train[False]
    for k in train_path:
        if train_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the training path")
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
    config_launches = phase_configs(m, fps, record, counters, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ml_launches = phase_ml(m, fps, record, counters, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mega_launches = phase_mega(m, fps, record, counters, gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    il_launches = phase_interleave(record, counters)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    shard_launches = phase_sharded(m, fps, record, jod_k, gen)

    src = "colorvideovdp_tpu_torch/csrc/"
    kernels = {
        "ingest": ("ingest.cu", "colorvideovdp_tpu/ops/kernels/ingest.py:322"),
        "pyramid_reduce": ("pyramid_reduce.cu",
                           "colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:195"),
        "band_masking": ("band_masking.cu",
                         "colorvideovdp_tpu/ops/kernels/masking_fused.py:440"),
        "csf_lut": ("csf_lut.cu", "colorvideovdp_tpu/ops/kernels/csf_lut.py:114"),
        "csf_lut_bwd": ("csf_lut.cu", "colorvideovdp_tpu/ops/kernels/csf_lut.py:156"),
        "blur": ("blur.cu", "colorvideovdp_tpu/ops/kernels/blur_halo.py:209"),
        "band_masking_d": ("band_masking.cu",
                           "colorvideovdp_tpu/ops/kernels/masking_fused.py:352"),
        "band_masking_d_noblur": ("band_masking.cu",
                                  "colorvideovdp_tpu/ops/kernels/masking_fused.py:463"),
        "band_masking_contrast": ("band_masking.cu",
                                  "colorvideovdp_tpu/ops/kernels/masking_fused.py:403"),
        "band_masking_contrast_d": ("band_masking.cu",
                                    "colorvideovdp_tpu/ops/kernels/masking_fused.py:403"),
        "ingest_replicate": ("ingest.cu", "colorvideovdp_tpu/ops/kernels/ingest.py:192"),
        "ingest_head": ("ingest.cu", "colorvideovdp_tpu/ops/kernels/ingest.py:192"),
        "band_fused": ("band_masking.cu", "colorvideovdp_tpu/ops/kernels/band_fused.py:320"),
        "band_fused_d": ("band_masking.cu", "colorvideovdp_tpu/ops/kernels/band_fused.py:320"),
        "interleave": ("interleave.cu", "tools/interleave_bench.py:50"),
        "concat": ("interleave.cu", "tools/interleave_bench.py:77"),
        "deinterleave": ("interleave.cu", "tools/interleave_bench.py:109"),
        "pyramid_reduce_slab": ("pyramid_reduce.cu",
                                "colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:238"),
        "band_masking_halo": ("band_masking.cu",
                              "colorvideovdp_tpu/ops/kernels/masking_fused.py:352"),
    }
    if set(kernels) != set(counters):
        raise AssertionError(f"the kernels line {sorted(kernels)} and the counted wrappers "
                             f"{sorted(counters)} differ")
    line = []
    for k, (f, rep) in kernels.items():
        by_path = {"score_4k_video": launches[k], "train_fhd_image": train_launches[k],
                   "heatmap_4k_video_720p_image": heat_launches[k],
                   **{p: c[k] for p, c in config_launches.items()},
                   **{p: c[k] for p, c in ml_launches.items()},
                   **{p: c[k] for p, c in mega_launches.items()},
                   **{p: c[k] for p, c in il_launches.items()},
                   "sharded_4k_video": shard_launches[k]}
        if k in ("pyramid_reduce_slab", "band_masking_halo"):
            n_main = shard_launches[k]
        elif k in ("interleave", "concat", "deinterleave"):
            n_main = il_launches["interleave_bench"][k]
        elif k == "band_fused":
            n_main = mega_launches["mega_4k_video"][k]
        elif k == "band_fused_d":
            n_main = mega_launches["mega_heatmap_4k_video"][k]
        elif k in ("ingest_replicate", "ingest_head"):
            n_main = sum(c[k] for c in ml_launches.values())
        elif k == "band_masking_contrast":
            n_main = (config_launches["weber_g0_ref_4k_video"][k]
                      + config_launches["log_4k_video"][k])
        elif k == "band_masking_contrast_d":
            n_main = config_launches["log_heatmap_720p_image"][k]
        else:
            n_main = (heat_launches if k.startswith("band_masking_d") else
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
