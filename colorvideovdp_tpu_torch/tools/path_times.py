"""Time the port's 4K scoring path on the card.

    python3 colorvideovdp_tpu_torch/tools/path_times.py [--reps N] [--block-frames B]
        [--contrast CODING] [--frames F]

Run as a script with ``PYTHONPATH`` naming a checkout's root, it measures that
checkout's package: two checkouts compared in one call on one card take turns
(A, B, B, A). It uses only the package's public entry points and
``ops.kernels.counted_wrappers()``. It scores the 4K HDR clip of
``chip_smoke.py`` phase 3 (3840x2160, 32 frames, 30 fps, ``tools/clips.py``
content of seed 7, ``standard_hdr_pq``; ``--frames`` repeats it to that
length) through ``cvvdp.predict`` as (1, F, 3, H, W) "BFCHW" arrays, so no
host relayout is timed, in blocks of ``--block-frames`` (``gpu_mem`` from
``cvvdp.block_gpu_mem``, each run from an emptied allocator cache) or, with
0, in the blocks the metric chooses itself (the allocator's cache held from
run to run, as in a service that scores clip after clip), and reports
the wall time of each warm run, the JOD, the kernels' launches, the peak
device memory of the timed runs, and from ``torch.profiler``
(``profile_device``, which ``chip_smoke.py`` also uses) the device time of
one warm run by kernel and the device's busy share. ``--contrast`` scores
with that contrast coding: a copy of the default parameter file with
``contrast`` changed (``utils.config.write_parameters``), written to a
temporary directory and removed after.

Prints one JSON line. Needs a CUDA card; it exits with an error without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def profile_device(fn):
    """One call of fn under ``torch.profiler``: ([(device ms, launches, kernel
    name)] by device time, largest first; the device's busy ms; wall s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if getattr(evt, "device_type", None) == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows), wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--block-frames", type=int, default=27)
    ap.add_argument("--contrast", default=None)
    ap.add_argument("--frames", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("path_times: CUDA is not available")

    import shutil
    import tempfile

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.kernels import counted_wrappers
    from colorvideovdp_tpu_torch.tools.clips import hdr_clip
    from colorvideovdp_tpu_torch.utils.config import write_parameters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"package": os.path.dirname(os.path.abspath(cvt.__file__)), "card": smi,
           "contrast": args.contrast}
    counters = counted_wrappers()
    tmp = tempfile.mkdtemp(prefix="path_times_")
    try:
        cfg = write_parameters(tmp, contrast=args.contrast) if args.contrast else None
        out["clip_4k"] = _clip_times(args, cvt, counters, hdr_clip, cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


def _clip_times(args, cvt, counters, hdr_clip, cfg):
    """The timed runs of the 4K clip (BFCHW, fixed blocks) with the
    configuration at ``cfg`` (None: the default)."""
    H, W, N, fps = 2160, 3840, args.frames, 30.0
    V_test, V_ref = hdr_clip(H, W, 32, np.random.RandomState(7))
    V_test, V_ref = (np.ascontiguousarray(np.concatenate([v] * -(-N // 32), axis=3)[..., :N]
                                          .transpose(3, 2, 0, 1)[None]) for v in (V_test, V_ref))
    pinned = args.block_frames > 0
    gpu_mem = None
    if pinned:
        probe = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                          config_paths=cfg)
        gpu_mem = probe.block_gpu_mem(H * W, args.block_frames, fps)
        del probe

    def score():
        m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True, gpu_mem=gpu_mem,
                      config_paths=cfg)
        Q, st = m.predict(V_test, V_ref, dim_order="BFCHW", frames_per_second=fps)
        return float(Q), st["block_N_frames"]

    score()  # warm-up: the kernel build, the allocator, the libraries
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.reps):
        if pinned:
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.time()
        jod, blk = score()
        torch.cuda.synchronize()
        times.append(round(time.time() - t0, 4))
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if pinned:
        torch.cuda.empty_cache()
    rows, busy, wall = profile_device(score)
    top = {name[:100]: [round(ms, 3), count] for ms, count, name in rows[:12]}
    return {"jod": jod, "frames": N, "block_frames": blk, "padded_frames": -(-N // blk) * blk - N,
            "seconds": times, "launches": launches,
            "peak_gib": round(peak, 3), "profiled_seconds": round(wall, 4),
            "device_busy_ms": round(busy, 3), "device_ms_by_kernel": top}


if __name__ == "__main__":
    sys.exit(main())
