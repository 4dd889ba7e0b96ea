"""Measure the device memory of a block on the pooled route, and fit the block
model to it.

    python3 -m colorvideovdp_tpu_torch.tools.block_memory [--blocks 1,2,4,8,16,24,32]
        [--sources fchw,fhwc,yuv420,frames] [--contrasts weber_g1,...] [--frames 32]
        [--size 4k]

For each contrast coding, source and block length it scores a clip
(``--size``: 4k 3840x2160 or fhd 1920x1080; ``--frames`` frames at 30 fps,
``standard_hdr_pq``) in blocks of that length, from an emptied allocator, and
reads the peaks of ``torch.cuda.max_memory_allocated()`` and
``max_memory_reserved()`` over what was allocated and reserved before the
call; a block the card cannot hold is recorded as out of memory and left out
of the fit. Sources: uint16 arrays as FCHW and as FHWC through ``predict``
(what the benchmark's 4K cells send), the FCHW array as float32 (``fchw32``,
twice the raw bytes), a packed 10-bit 4:2:0 BT.2020 ``.yuv`` pair written to a
temporary directory (``video_source_file``, unpacked on the card by
``unpack_raw_block``), and the FCHW array read frame by frame (a source
without ``get_raw_block``). The block length is forced on the metric, so the
model under test does not choose it.

Per coding it fits the block model of ``cvvdp.estimate_block_N``, total = a +
pix (N + fl - 1) b + pix N c bytes, to the largest peak over the raw-block
sources at each block length (``fit``), and to the per-frame source's apart
(``fit_per_frame``: that route keeps the reference metric's model). b = 48 is
the tails' bytes a pixel-frame: both sides' 3 float32 channels, the old and
the new tails alive across the ingest. c comes from the least-squares slope,
then a is the least intercept that lies on or above every such peak.
``suggested`` adds the margin that ``cvvdp.pooled_mem_model`` carries for the
caching allocator's rounding (b + c 6% over the slope) and rounds a up to
0.1 GB.

Prints one JSON line: the card, each run's peaks (bytes), wall seconds and
JOD, and each coding's fit. Needs a CUDA card; it exits with an error without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SIZES = {"4k": (2160, 3840), "fhd": (1080, 1920)}
FPS = 30.0
MEM_B = 48  # the tails' bytes a pixel-frame: 2 sides x 3 channels x float32 x 2
MARGIN = 1.06


def clip_u16(H: int, W: int, N: int, rng: np.random.RandomState):
    """(test, reference) (N, 3, H, W) uint16: a horizontal gradient as the
    reference, plus seeded noise for the test."""
    base = (np.linspace(0.1, 0.7, W) * 65535).astype(np.int32)
    ref = np.ascontiguousarray(np.broadcast_to(base.astype(np.uint16), (N, 3, H, W)))
    test = np.empty_like(ref)
    for i in range(N):
        test[i] = np.clip(base + rng.randint(-2048, 2049, (3, H, W)), 0, 65535)
    return test, ref


def write_yuv420(dirname: str, tag: str, H: int, W: int, N: int,
                 rng: np.random.RandomState) -> str:
    """A 10-bit 4:2:0 BT.2020 limited-range .yuv file of N seeded frames,
    named by ``create_yuv_fname``. Returns its path."""
    from colorvideovdp_tpu_torch.io.yuv import create_yuv_fname

    name = os.path.join(dirname, create_yuv_fname(tag, dict(
        width=W, height=H, fps=int(FPS), bit_depth=10, chroma_ss="420", color_space="2020")))
    with open(name, "wb") as f:
        for _ in range(N):
            rng.randint(64, 941, H * W + H * W // 2).astype("<u2").tofile(f)
    return name


def peak_bytes(run):
    """(peak bytes allocated by run() over what was allocated before, the
    same of the bytes reserved, wall s, its result)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base, base_res = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base,
            torch.cuda.max_memory_reserved() - base_res, time.time() - t0, out)


def fit(peaks: dict, pix: int, fl: int) -> dict:
    """The block model's (a, c) for b = ``MEM_B`` from {block: peak bytes}:
    c from the least-squares slope, a the least intercept on or above every
    peak; ``suggested`` with the margin."""
    N = np.array(sorted(peaks), np.float64)
    P = np.array([peaks[n] for n in sorted(peaks)], np.float64)
    slope = float(np.polyfit(N, P, 1)[0]) if len(N) > 1 else float(P[0] / N[0])
    c = slope / pix - MEM_B
    a = float(np.max(P - pix * (N + fl - 1) * MEM_B - pix * N * c))
    return {"bytes_per_pixel_frame": round(slope / pix, 2), "a": round(a), "b": MEM_B,
            "c": round(c, 2), "suggested": [math.ceil(a / 1e8) * 1e8, MEM_B,
                                            math.ceil(slope / pix * MARGIN) - MEM_B]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", default="1,2,4,8,16,24,32")
    ap.add_argument("--sources", default="fchw,fhwc,yuv420,frames")
    ap.add_argument("--contrasts", default="weber_g1")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", choices=sorted(SIZES), default="4k")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("block_memory: CUDA is not available")

    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.tools.clips import FrameByFrame
    from colorvideovdp_tpu_torch.io.video_source import video_source_array
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file
    from colorvideovdp_tpu_torch.utils.config import write_parameters

    blocks = [int(b) for b in args.blocks.split(",")]
    sources = args.sources.split(",")
    N = args.frames
    H, W = SIZES[args.size]
    pix = H * W
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"card": smi, "height": H, "width": W, "frames": N, "fps": FPS, "runs": [],
           "fit": {}, "fit_per_frame": {}}
    rng = np.random.RandomState(7)
    test, ref = clip_u16(H, W, N, rng)
    tmp = tempfile.mkdtemp(prefix="block_memory_")
    try:
        yuv = ([write_yuv420(tmp, tag, H, W, N, rng) for tag in ("test", "ref")]
               if "yuv420" in sources else None)

        def source(kind):
            if kind == "yuv420":
                return video_source_file(*yuv, display_photometry="standard_hdr_pq")
            if kind == "fhwc":
                t, r, order = test.transpose(0, 2, 3, 1), ref.transpose(0, 2, 3, 1), "FHWC"
                t, r = np.ascontiguousarray(t), np.ascontiguousarray(r)
            elif kind == "fchw32":
                t, r = (v.astype(np.float32) / 65535 for v in (test, ref))
                order = "FCHW"
            else:
                t, r, order = test, ref, "FCHW"
            vs = video_source_array(t, r, FPS, dim_order=order,
                                    display_photometry="standard_hdr_pq")
            return FrameByFrame(vs) if kind == "frames" else vs

        for contrast in args.contrasts.split(","):
            cfg = (write_parameters(os.path.join(tmp, contrast), contrast=contrast)
                   if contrast != "weber_g1" else None)
            m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True,
                          config_paths=cfg)
            if m.contrast != contrast:
                raise SystemExit(f"block_memory: the metric reads contrast {m.contrast}")
            fl = None
            largest, per_frame = {}, {}
            for kind in sources:
                vs = source(kind)
                # Warm-up: the kernel build, the LUTs and pyramids at this size.
                m.estimate_block_N = lambda pix_cnt, n, **kw: 1
                m.predict_video_source(vs)
                fl = m.filter_len
                for blk in blocks:
                    m.estimate_block_N = lambda pix_cnt, n, blk=blk, **kw: min(blk, n)
                    run = {"contrast": contrast, "source": kind, "block": blk}
                    out["runs"].append(run)
                    try:
                        peak, res, secs, (Q, st) = peak_bytes(
                            lambda: m.predict_video_source(vs))
                    except torch.cuda.OutOfMemoryError:
                        run["oom"] = True
                        continue
                    if st["block_N_frames"] != min(blk, N):
                        raise AssertionError(f"block {st['block_N_frames']}, asked {blk}")
                    run.update(peak_bytes=int(peak), peak_reserved_bytes=int(res),
                               seconds=round(secs, 3), jod=float(Q))
                    peaks = per_frame if kind == "frames" else largest
                    peaks[blk] = max(peaks.get(blk, 0), int(peak))
                del vs
            for key, peaks in (("fit", largest), ("fit_per_frame", per_frame)):
                if peaks:
                    out[key][contrast] = dict(fit(peaks, pix, fl), filter_len=fl,
                                              largest_peak_bytes=peaks)
            del m
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
