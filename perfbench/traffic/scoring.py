"""What the scoring kinds share: the program a request calls, the request
loop's record, and the comparison with the plain reference.

A request is one ``predict`` of a test/reference pair of host arrays, timed
from the call to its JOD as a Python float. The record keeps the JOD,
``stats["Q_per_ch"]`` and the block length the metric chose. After the
window, requests drawn from the seed are scored again by the reference in
float32 (TF32 off) and compared: the largest JOD gap (``jod_gap``) and the
largest gap in ``Q_per_ch`` relative to the reference's largest entry of that
request (``q_rel_gap``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import content, work
from perfbench.reference.cvvdp_ref import CVVDPReference, Display

SEED_CHECK = 4


class PortScorer:
    """The measured program: ``cvvdp`` of the port, built once with its
    defaults (so it picks its own block length)."""

    def __init__(self, display, device):
        import colorvideovdp_tpu_torch as cvt

        self.metric = cvt.cvvdp(display_name=display, device=device)

    def predict(self, test, ref, dim_order, fps):
        Q, st = self.metric.predict(test, ref, dim_order=dim_order, frames_per_second=fps)
        return float(Q), st["Q_per_ch"], int(st["block_N_frames"])


class ReferenceScorer:
    """The control: the reference in the program's place, in bfloat16."""

    def __init__(self, display, device):
        self.ref = CVVDPReference(display, device=device, dtype=torch.bfloat16)

    def predict(self, test, ref, dim_order, fps):
        jod, Q = self.ref.score(test, ref, dim_order, fps)
        n = test.shape[dim_order.upper().index("F")] if "F" in dim_order.upper() else 1
        return jod, Q, n


def _finite(x: float) -> float:
    """A gap, or infinity where it is not a number (a NaN fails no max)."""
    return x if math.isfinite(x) else math.inf


def make_scorer(program, display, device):
    """The program a request calls: the port (None or "port"), or the
    control ("control", the reference in bfloat16)."""
    if program in (None, "port"):
        return PortScorer(display, device)
    if program == "control":
        return ReferenceScorer(display, device)
    raise ValueError(f"unknown program {program!r}")


class ScoringTraffic:
    """Base of the scoring kinds: a subclass builds ``self.pairs(i)`` ->
    (test, ref) host arrays of request i and sets ``layout``, ``fps`` and
    ``frames``."""

    layout = "FCHW"
    fps = 0.0
    frames = 1

    def __init__(self, cell, seed, device, program=None):
        self.cell, self.seed, self.dev, self.program_name = cell, int(seed), device, program
        cfg = cell.config
        self.display = cfg["display"]
        self.W, self.H = cfg["resolution"]
        self.dtype = np.dtype(cfg["content_dtype"])
        self.program = None

    def make_content(self):
        raise NotImplementedError

    def pairs(self, i, stream=0):
        raise NotImplementedError

    def setup(self):
        self.make_content()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        self.program = make_scorer(self.program_name, self.display, self.dev)
        warm = int(self.cell.mix.get("warmup_requests", 1)) if isinstance(
            self.program, PortScorer) else 0
        for i in range(warm):
            test, ref = self.pairs(i, stream=1)
            self.program.predict(test, ref, self.layout, self.fps)

    def request(self, i, trace=False):
        test, ref = self.pairs(i)
        t0 = time.perf_counter()
        with record_function("perfbench.predict"):
            jod, Q, blk = self.program.predict(test, ref, self.layout, self.fps)
        latency = time.perf_counter() - t0
        return {"i": i, "latency": latency, "jod": jod, "Q": Q, "blk": blk,
                "frames": self.frames,
                "computed": -(-self.frames // blk) * blk}

    def shape(self, frames) -> work.Shape:
        """The work of one request of ``frames`` frames (``perfbench/work``)."""
        video = self.frames > 1
        disp = Display(self.display)
        return work.Shape(B=1, F=frames, H=self.H, W=self.W, channels=4 if video else 3,
                          fl=int(math.ceil(0.125 * self.fps)) * 2 + 1 if video else 0,
                          sample_bytes=self.dtype.itemsize, eotf=disp.eotf, ppd=disp.ppd)

    def release(self):
        self.program = None

    def check(self, records):
        """The comparison of sampled requests with the float32 reference."""
        mix = self.cell.mix
        n = min(int(mix["check_requests"]), len(records))
        pick = content.host_rng(self.seed, SEED_CHECK).choice(len(records), size=n, replace=False)
        ref = CVVDPReference(self.display, device=self.dev)
        jod_gap = q_gap = 0.0 if n else float("inf")
        for k in sorted(pick):
            rec = records[k]
            test, r = self.pairs(rec["i"])
            jod, Q = ref.score(test, r, self.layout, self.fps)
            jod_gap = max(jod_gap, _finite(abs(rec["jod"] - jod)))
            q_gap = max(q_gap, _finite(float(np.abs(rec["Q"] - Q).max() / np.abs(Q).max())))
        lim = mix["limits"]
        return {"jod_gap": {"value": jod_gap, "limit": lim["jod_gap"]},
                "q_rel_gap": {"value": q_gap, "limit": lim["q_rel_gap"]}}
