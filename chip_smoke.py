"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc``; it builds the kernels from ``csrc/`` itself.

Phase 0  card, power limit, torch and CUDA versions; TF32 must be off.
Phase 1  build the kernel library.
Phase 2  every kernel against its plain PyTorch version on the card, at the
         shapes the 4K main path gives it (the first block of the 4K clip),
         on seeded random frames: the worst relative error of any channel
         against the stated tolerance, kernel and plain times (CUDA events,
         median of 5).
Phase 3  the 4K HDR clip (3840x2160, 32 frames, 30 fps, seed 7,
         standard_hdr_pq) through ``cvvdp.predict`` with the kernels, then
         with ``enable_fused_kernels = False``. Every kernel must have
         launched, the two JODs must agree within 1e-3 and the JOD must be
         within 0.01 of 7.8784, the value the reference metric gives. Then
         the host relayout of the input arrays and the block loop are timed
         apart.
Phase 4  a 1920x1080 sRGB image pair on standard_fhd (the image step, C = 3).

Any failure raises (non-zero exit). The last line of standard output is a
JSON object naming the device; the line before it lists the kernels.
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
TOL = {"ingest": 1e-5, "pyramid_reduce": 1e-6, "band_masking": 1e-4, "csf_lut": 1e-5}


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


def check(name, err, tol):
    log(f"  {name}: max error {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops import pyramid as pyr
    from colorvideovdp_tpu_torch.ops.kernels import _build, csf_lut, ingest, masking_fused
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

    def record(name, err, abs_err, k_ms, p_ms):
        check(name, err, TOL[name])
        log(f"  {name}: max abs error {abs_err:.3e}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        rows[name] = (abs_err, k_ms, p_ms)

    args = (tails[0], tails[1], raws[0], raws[1], dm, filt)
    R_k, nt_k, _ = ingest.ingest(*args)
    R_p, nt_p, _ = ingest.ingest_plain(*args)
    err = max(rel_err_per(R_k, R_p, 1), rel_err_per(nt_k, nt_p, 1))
    record("ingest", err, max_abs(R_k, R_p), time_ms(lambda: ingest.ingest(*args)),
           time_ms(lambda: ingest.ingest_plain(*args)))
    del R_p, nt_p, nt_k, tails, raws

    y_k = prd.pyramid_reduce(R_k)
    y_p = pyr.reduce_plain(R_k)
    err = float((y_k - y_p).abs().max()) / max(1.0, float(y_p.abs().max()))
    record("pyramid_reduce", err, max_abs(y_k, y_p), time_ms(lambda: prd.pyramid_reduce(R_k)),
           time_ms(lambda: pyr.reduce_plain(R_k)))
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
    log(f"  band_masking stacked launch: bands {[tuple(g.shape[-2:]) for g in gis]}, "
        f"error {err_narrow:.3e}, kernel {time_ms(lambda: masking_fused.band_masking(*stack)):.3f} ms, "
        f"plain {time_ms(lambda: masking_fused.band_masking_plain(*stack)):.3f} ms")
    log(f"  band_masking band 0 {tuple(R_k.shape)}: error {err_wide:.3e}")
    record("band_masking", max(err_wide, err_narrow), abs_wide, k_wide, p_wide)

    logL = L_bkg[-1].contiguous()  # the baseband's (1, 1, blk, 1, 1) log-luminance
    x0, x1 = m.csf.lut_range()
    lut_b = torch.as_tensor(np.stack([m.csf.logS_of_logL(0.1, m.omega[0 if cc < 3 else 1],
                                                         cc if cc < 3 else 0)
                                      for cc in range(4)]), device=dev)
    c_k = csf_lut.csf_lut(logL, lut_b, x0, x1)
    c_p = csf_lut.csf_lut_plain(logL, lut_b, x0, x1)
    record("csf_lut", float(((c_k - c_p).abs() / c_p.abs()).max()), max_abs(c_k, c_p),
           time_ms(lambda: csf_lut.csf_lut(logL, lut_b, x0, x1)),
           time_ms(lambda: csf_lut.csf_lut_plain(logL, lut_b, x0, x1)))
    del R_k, bands, L_bkg, gis, Es, stack
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- phase 3 ------------------------------------------------------------
    t0 = time.time()
    V_test, V_ref = clip_content(H, W, N, np.random.RandomState(7))
    log(f"phase 3: clip content made in {time.time() - t0:.1f} s")
    counters = {"ingest": ingest.ingest, "pyramid_reduce": prd.pyramid_reduce,
                "band_masking": masking_fused.band_masking, "csf_lut": csf_lut.csf_lut}
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
    for k, v in launches.items():
        if v <= 0:
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

    src = "colorvideovdp_tpu_torch/csrc/"
    replaces = {
        "ingest": "colorvideovdp_tpu/ops/kernels/ingest.py:322",
        "pyramid_reduce": "colorvideovdp_tpu/ops/kernels/pyramid_reduce.py:195",
        "band_masking": "colorvideovdp_tpu/ops/kernels/masking_fused.py:440",
        "csf_lut": "colorvideovdp_tpu/ops/kernels/csf_lut.py:134",
    }
    kernels = [{"name": k, "route": "cuda", "source": src + k + ".cu",
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": rows[k][0], "ms": rows[k][1], "plain_ms": rows[k][2]}
               for k in ("ingest", "pyramid_reduce", "band_masking", "csf_lut")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
