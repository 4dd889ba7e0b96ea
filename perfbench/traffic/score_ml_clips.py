"""Closed-loop scoring of video clips with ColorVideoVDP-ML-Transformer.

The content and the requests are ``score_clips``': pools of ``pool_frames``
seeded frames a side, made on the device and held on the host as
``layout``, and request i scores ``clip_frames`` frames from a seeded
offset, one client. The metric is the configuration's ``metric`` at its
``dim``, built with random weights and then given the head's weights drawn
from the run's seed (``cvvdp_ml_ref.seeded_weights``, with the
configuration's ``weights.reg_head_bias``) through the public
``load_weights``; the reference gets the same arrays. The record keeps the
JOD and ``stats["delta_per_band"]``, each band's head output. A program
without that output fails at set-up, before the content is made.

The comparison: requests drawn from the seed are scored again by the plain
reference (``perfbench/reference/cvvdp_ml_ref.py``) in float32, TF32 off:
the largest JOD gap (``jod_gap``) and the largest gap of a band's delta
over the request's largest reference delta (``delta_rel_gap``). A request
whose reference delta is 0 in any band makes ``delta_rel_gap`` infinite: a
head whose ReLU reads 0 compares nothing of the trunk.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import content
from perfbench.reference.cvvdp_ml_ref import CVVDPMLReference, seeded_weights
from perfbench.traffic.score_clips import Traffic as ClipTraffic
from perfbench.traffic.scoring import SEED_CHECK, _finite


class PortMLScorer:
    """The measured program: the port's ML metric with the given weights.
    It first scores a small image on the CPU, which builds no kernel, so
    that a program without per-band deltas fails in seconds."""

    def __init__(self, cfg, flat, device):
        import colorvideovdp_tpu_torch as cvt

        def metric(dev):
            m = getattr(cvt, cfg["metric"])(display_name=cfg["display"], device=dev,
                                            random_init=True, dim=int(cfg["dim"]))
            m.load_weights(flat)
            return m

        img = np.random.default_rng(0).integers(0, 65536, (64, 64, 3), dtype=np.uint16)
        self.metric = metric("cpu")
        self.predict(img, img[::-1].copy(), "HWC", 0.0)
        self.metric = metric(device)

    def predict(self, test, ref, dim_order, fps):
        Q, st = self.metric.predict(test, ref, dim_order=dim_order, frames_per_second=fps)
        if "delta_per_band" not in st:
            raise RuntimeError("the program gives no stats['delta_per_band']")
        return float(Q), st["delta_per_band"][0], int(st["block_N_frames"])


class ReferenceMLScorer:
    """The control: the reference in the program's place, in bfloat16."""

    def __init__(self, cfg, flat, device):
        self.ref = CVVDPMLReference(cfg["display"], flat, device=device, dtype=torch.bfloat16,
                                    heads=int(cfg["heads"]))

    def predict(self, test, ref, dim_order, fps):
        jod, d = self.ref.score(test, ref, dim_order, fps)
        return jod, d, test.shape[dim_order.upper().index("F")]


class Traffic(ClipTraffic):
    def __init__(self, cell, seed, device, program=None):
        super().__init__(cell, seed, device, program)
        cfg = cell.config
        self.flat = seeded_weights(self.seed, int(cfg["in_channels"]), int(cfg["dim"]),
                                   int(cfg["depth"]), float(cfg["weights"]["reg_head_bias"]))

    def setup(self):
        if self.program_name in (None, "port"):
            self.program = PortMLScorer(self.cell.config, self.flat, self.dev)
            warm = int(self.cell.mix.get("warmup_requests", 1))
        elif self.program_name == "control":
            self.program, warm = ReferenceMLScorer(self.cell.config, self.flat, self.dev), 0
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
            jod, delta, blk = self.program.predict(test, ref, self.layout, self.fps)
        latency = time.perf_counter() - t0
        return {"i": i, "latency": latency, "jod": jod, "delta": np.asarray(delta),
                "blk": blk, "frames": self.frames, "computed": -(-self.frames // blk) * blk}

    def check(self, records):
        mix, cfg = self.cell.mix, self.cell.config
        n = min(int(mix["check_requests"]), len(records))
        pick = content.host_rng(self.seed, SEED_CHECK).choice(len(records), size=n, replace=False)
        ref = CVVDPMLReference(cfg["display"], self.flat, device=self.dev, heads=int(cfg["heads"]))
        jod_gap = d_gap = 0.0 if n else float("inf")
        for k in sorted(pick):
            rec = records[k]
            test, r = self.pairs(rec["i"])
            jod, d = ref.score(test, r, self.layout, self.fps)
            jod_gap = max(jod_gap, _finite(abs(rec["jod"] - jod)))
            scale = float(np.abs(d).max())
            gap = float(np.abs(rec["delta"] - d).max()) / scale if np.all(d != 0) else np.inf
            d_gap = max(d_gap, _finite(gap))
        lim = mix["limits"]
        return {"jod_gap": {"value": jod_gap, "limit": lim["jod_gap"]},
                "delta_rel_gap": {"value": d_gap, "limit": lim["delta_rel_gap"]}}
