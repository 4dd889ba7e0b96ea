"""Closed-loop scoring of single images held in host memory.

At set-up: ``references`` seeded scenes (a frame each) and ``variants``
seeded distortions of each, quantised to the configuration's
``content_dtype`` as (H, W, 3) host arrays. Request i scores a seeded pick
of a reference and one of its variants with ``dim_order="HWC"``. One
client: the next request starts when the last one's JOD is read.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import content
from perfbench.traffic.scoring import ScoringTraffic


class Traffic(ScoringTraffic):
    layout = "HWC"

    def make_content(self):
        mix = self.cell.mix
        n_ref, n_var = int(mix["references"]), int(mix["variants"])
        self.refs = np.empty((n_ref, self.H, self.W, 3), self.dtype)
        self.tests = np.empty((n_ref, n_var, self.H, self.W, 3), self.dtype)
        g = content.generator(self.seed, 0, self.dev)
        for k in range(n_ref):
            ref = content.Scene(g, self.H, self.W, self.dev).frames(0, 1)
            self.refs[k] = content.to_host(
                content.quantise(ref, self.dtype)[0].permute(1, 2, 0), self.dtype)
            tests = content.distort(g, ref.expand(n_var, -1, -1, -1).contiguous())
            self.tests[k] = content.to_host(
                content.quantise(tests, self.dtype).permute(0, 2, 3, 1), self.dtype)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def pairs(self, i, stream=0):
        k, v = np.random.default_rng([self.seed, 100 + stream, i]).integers(
            0, self.tests.shape[:2])
        return self.tests[k, v], self.refs[k]

    def end_to_end(self, records, window, peak):
        lat = np.array([r["latency"] for r in records])
        return {"frames_per_s": len(records) / window,
                "image_p95_ms": float(np.percentile(lat, 95)) * 1e3}
