"""Closed-loop scoring of video clips with a supra-threshold heatmap.

The content and the requests are ``score_clips``': pools of ``pool_frames``
seeded frames a side, made on the device and held on the host as
``layout``, and request i scores ``clip_frames`` frames from a seeded
offset, one client. The metric is ``cvvdp`` with ``heatmap=
"supra-threshold"``, built with its defaults; a request returns its JOD,
``stats["Q_per_ch"]`` and the float16 map ``stats["heatmap"]`` on the
host. A program that gives no map fails at set-up, before the content is
made.

The maps are kept only for ``kept_maps`` requests drawn from the seed among
the first ``kept_among`` (a 12-frame 4K map is 597 MB). The comparison:
those requests are scored again by the plain reference (``perfbench/
reference/heatmap_ref.py``) in float32, its tone map over the program's
block length: the JOD gap (``jod_gap``), the largest ``Q_per_ch`` gap over
the reference's largest entry (``q_rel_gap``) and the largest absolute
difference of the maps (``hm_gap``), each the largest over the requests.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import content
from perfbench.reference.heatmap_ref import HeatmapReference
from perfbench.traffic.score_clips import Traffic as ClipTraffic
from perfbench.traffic.scoring import _finite

HEATMAP = "supra-threshold"
SEED_KEEP = 5


class PortHeatmapScorer:
    """The measured program: the port's ``cvvdp`` with a heatmap. It first
    scores a small image on the CPU, which builds no kernel, so that a
    program without the map fails in seconds."""

    def __init__(self, display, device):
        import colorvideovdp_tpu_torch as cvt

        img = np.random.default_rng(0).integers(0, 65536, (64, 64, 3), dtype=np.uint16)
        self.metric = cvt.cvvdp(display_name=display, device="cpu", heatmap=HEATMAP)
        self.predict(img, img[::-1].copy(), "HWC", 0.0)
        self.metric = cvt.cvvdp(display_name=display, device=device, heatmap=HEATMAP)

    def predict(self, test, ref, dim_order, fps):
        Q, st = self.metric.predict(test, ref, dim_order=dim_order, frames_per_second=fps)
        if "heatmap" not in st:
            raise RuntimeError("the program gives no stats['heatmap']")
        return float(Q), st["Q_per_ch"], int(st["block_N_frames"]), st["heatmap"]


class ReferenceHeatmapScorer:
    """The control: the reference in the program's place, in bfloat16."""

    def __init__(self, display, device):
        self.ref = HeatmapReference(display, device=device, dtype=torch.bfloat16)

    def predict(self, test, ref, dim_order, fps):
        n = test.shape[dim_order.upper().index("F")]
        jod, Q, hm = self.ref.score(test, ref, dim_order, fps)
        return jod, Q, n, hm


class Traffic(ClipTraffic):
    def __init__(self, cell, seed, device, program=None):
        super().__init__(cell, seed, device, program)
        mix = cell.mix
        self.keep = {int(k) for k in content.host_rng(self.seed, SEED_KEEP).choice(
            int(mix["kept_among"]), size=int(mix["kept_maps"]), replace=False)}

    def setup(self):
        if self.program_name in (None, "port"):
            self.program = PortHeatmapScorer(self.display, self.dev)
            warm = int(self.cell.mix.get("warmup_requests", 1))
        elif self.program_name == "control":
            self.program, warm = ReferenceHeatmapScorer(self.display, self.dev), 0
        else:
            raise ValueError(f"unknown program {self.program_name!r}")
        self.make_content()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        for i in range(warm):
            test, ref = self.pairs(i, stream=1)
            self.program.predict(test, ref, self.layout, self.fps)

    def request(self, i, trace=False):
        test, ref = self.pairs(i)
        t0 = time.perf_counter()
        with record_function("perfbench.predict"):
            jod, Q, blk, hm = self.program.predict(test, ref, self.layout, self.fps)
        latency = time.perf_counter() - t0
        rec = {"i": i, "latency": latency, "jod": jod, "Q": Q, "blk": blk,
               "frames": self.frames, "computed": -(-self.frames // blk) * blk}
        if i in self.keep:
            rec["hm"] = hm
        return rec

    def check(self, records):
        kept = [r for r in records if "hm" in r]
        ref = HeatmapReference(self.display, device=self.dev)
        gaps = dict.fromkeys(("jod_gap", "q_rel_gap", "hm_gap"),
                             0.0 if len(kept) == len(self.keep) else float("inf"))
        for rec in kept:
            test, r = self.pairs(rec["i"])
            jod, Q, hm = ref.score(test, r, self.layout, self.fps, tone_frames=rec["blk"])
            got = {"jod_gap": abs(rec["jod"] - jod),
                   "q_rel_gap": float(np.abs(rec["Q"] - Q).max() / np.abs(Q).max()),
                   "hm_gap": float(np.abs(rec["hm"].astype(np.float32)
                                          - hm.astype(np.float32)).max())}
            for k, v in got.items():
                gaps[k] = max(gaps[k], _finite(v))
            del hm
        lim = self.cell.mix["limits"]
        return {k: {"value": v, "limit": lim[k]} for k, v in gaps.items()}
