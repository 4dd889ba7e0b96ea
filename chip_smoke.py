"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it builds the kernels from ``csrc/`` itself.

Phase 0  card, power limit, torch and CUDA versions; TF32 must be off.
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
       "csf_lut_bwd": 1e-5, "blur": 1e-5, "band_masking_d": 1e-5, "band_masking_d_noblur": 1e-5}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same source
# Training step bounds (phase 5): kernels against plain on the card.
LOSS_TOL, GRAD_TOL = 1e-4, 1e-4
# Heatmap bounds (phase 6): float16 heatmaps kernels against plain, and the
# JOD with a heatmap against the pooled-only JOD.
HEATMAP_TOL, HEATMAP_JOD_TOL = 1.1e-3, 1e-4


def log(*args):
    print(*args, flush=True)


def clip_content(H, W, N, rng):
    """Synthetic HDR content: a PQ-encoded gradient plus noise, uint8."""
    base = np.linspace(0.1, 0.7, W, dtype=np.float32)[None, :, None]
    ref = (np.broadcast_to(base, (H, W, 3)) * 255).astype(np.uint8)
    V_ref = np.repeat(ref[:, :, :, None], N, axis=3)
    noise = (rng.randn(H, W, 3, N) * 8).astype(np.int16)
    V_test = np.clip(V_ref.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return V_test, V_ref


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d
    from colorvideovdp_tpu_torch.ops.kernels import _build, csf_lut, ingest, masking_fused
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
    m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    log("phase 0: TF32 off for cuDNN and matmul")

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
    counters = {"ingest": ingest.ingest, "pyramid_reduce": prd.pyramid_reduce,
                "band_masking": masking_fused.band_masking, "csf_lut": csf_lut.csf_lut,
                "csf_lut_bwd": csf_lut.csf_lut_bwd, "blur": blr.blur,
                "band_masking_d": masking_fused.band_masking_d,
                "band_masking_d_noblur": masking_fused.band_masking_d_noblur}
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
    }
    line = []
    for k, (f, rep) in kernels.items():
        by_path = {"score_4k_video": launches[k], "train_fhd_image": train_launches[k],
                   "heatmap_4k_video_720p_image": heat_launches[k]}
        main = (heat_launches if k.startswith("band_masking_d") else
                train_launches if k in train_path else launches)
        line.append({"name": k, "route": "cuda", "source": src + f, "replaces": rep,
                     "launches": main[k], "launches_by_path": by_path, **rows[k]})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
