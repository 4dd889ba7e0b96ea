"""Sharded scoring check: the 4K HDR clip scored on one card and on a (batch,
space) mesh of ranks, JODs compared.

    python -m colorvideovdp_tpu_torch.tools.shard_check --ranks 4 [--batch 2]
        [--frames 16] [--block-frames 8] [--size 2160x3840] [--cpu]

The content is ``clips.hdr_clip`` (``chip_smoke.py``'s clip: a gradient plus
noise, uint8, standard_hdr_pq, 30 fps), one pair per batch group (seeds 7, 8,
...), in the BFCHW layout so that no host relayout is timed. It is scored
twice on card 0 (``cvvdp.predict``, cold then warm), then through
``run_ranks`` with ``sharding.score_rank``: NCCL with one rank per card when
there are enough cards, else gloo ranks sharing them. ``gpu_mem`` is set for
``--block-frames`` frame blocks on each rank. Prints the card(s), the
backend, each rank's JODs, set-up and block loop time and peak memory
against single-device, then a JSON line; exits 1 if any rank's JOD is more
than 1e-4 from single-device or its blocks are not ``--block-frames``
long. ``--cpu`` rehearses on the CPU (gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

JOD_TOL = 1e-4


def main(argv=None) -> int:
    from ..metrics.cvvdp import cvvdp
    from ..parallel import run_ranks
    from ..parallel.sharding import score_rank
    from .clips import hdr_clip

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None, help="batch groups (default n // 4)")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--block-frames", type=int, default=8)
    ap.add_argument("--size", default="2160x3840", help="HxW")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("shard_check: CUDA is not available (use --cpu to rehearse)")
    H, W = (int(v) for v in args.size.split("x"))
    n_b = args.batch or max(1, args.ranks // 4)
    n_sp = args.ranks // n_b
    fps = 30.0
    # (B, N, 3, H, W): one clip per batch group, seeds 7, 8, ...
    pairs = [hdr_clip(H, W, args.frames, np.random.RandomState(7 + i)) for i in range(n_b)]
    test, ref = (np.stack([np.ascontiguousarray(p[k].transpose(3, 2, 0, 1)) for p in pairs])
                 for k in (0, 1))
    del pairs
    cards = torch.cuda.device_count() if device == "cuda" else 0
    names = [torch.cuda.get_device_name(i) for i in range(cards)]
    print(f"shard_check: {args.ranks} ranks, mesh ({n_b}, {n_sp}), {n_b} pair(s) of "
          f"{args.frames} frames {H}x{W}; cards {names or 'none (CPU)'}", flush=True)

    m = cvvdp(display_name="standard_hdr_pq", device=device, quiet=True)
    t0 = time.time()
    Q1, stats = m.predict(test, ref, dim_order="BFCHW", frames_per_second=fps)
    if device == "cuda":
        torch.cuda.synchronize()
    single_s = time.time() - t0
    single = np.asarray(Q1.cpu(), np.float64).reshape(-1)
    print(f"shard_check: single-device JOD {single.tolist()}, blk {stats['block_N_frames']}, "
          f"{single_s:.3f} s", flush=True)
    t0 = time.time()
    m.predict(test, ref, dim_order="BFCHW", frames_per_second=fps)
    if device == "cuda":
        torch.cuda.synchronize()
    warm_s = time.time() - t0
    print(f"shard_check: single-device again (warm) {warm_s:.3f} s", flush=True)

    if device == "cuda":
        torch.cuda.empty_cache()

    # The ranks that share a device divide its memory (the host: all of them).
    share = args.ranks if device == "cpu" else (1 if cards >= args.ranks
                                                else -(-args.ranks // cards))
    gpu_mem = m.block_gpu_mem((H // n_sp) * W, args.block_frames, fps, share)
    del m, Q1
    tmp = tempfile.mkdtemp(prefix="cvvdp_shard_check_")
    try:
        paths = [os.path.join(tmp, f"{k}.npy") for k in ("test", "reference")]
        np.save(paths[0], test)
        np.save(paths[1], ref)
        del test, ref
        spec = dict(test=paths[0], reference=paths[1], dim_order="BFCHW", fps=fps,
                    display_name="standard_hdr_pq", batch=n_b, gpu_mem=gpu_mem)
        t0 = time.time()
        res = run_ranks(score_rank, args.ranks, (spec,), device=device, timeout_s=600)
        wall = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst, blocks_ok = 0.0, True
    for r in res:
        blocks_ok &= r["block_N"] == min(args.block_frames, args.frames)
        jod = np.asarray(r["jod"], np.float64).reshape(-1)
        worst = max(worst, float(np.abs(jod - single).max()))
        print(f"shard_check: rank {r['rank']} (b {r['b']}, s {r['s']}) on {r['device']}: JOD "
              f"{jod.tolist()}, blk {r['block_N']}, set-up {r['setup_s']:.3f} s, block loop "
              f"{r['block_loop_s']:.3f} s, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB, route {r['route']}, launches {r['launches']}",
              flush=True)
    ok = worst <= JOD_TOL and blocks_ok
    print(json.dumps({"ranks": args.ranks, "mesh": [n_b, n_sp], "frames": args.frames,
                      "size": [H, W], "single_jod": single.tolist(), "single_s": single_s,
                      "single_warm_s": warm_s,
                      "max_abs_djod": worst, "wall_s": wall, "ok": ok,
                      "setup_s": [r["setup_s"] for r in res],
                      "block_loop_s": [r["block_loop_s"] for r in res],
                      "peak_gib": [r["peak_bytes"] / 2**30 for r in res]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
