"""Closed-loop scoring of video clips held in host memory.

The content is made once at set-up: a pool of ``pool_frames`` frames of one
seeded scene per side, the test side distorted frame by frame (``content``),
quantised to the configuration's ``content_dtype`` and copied to host arrays
laid out as ``layout`` ("FCHW" or "FHWC"). Request i scores the
``clip_frames`` frames from a seeded offset of both pools, views of them, so
the request hands ``predict`` what a decoder would. One client: the next
request starts when the last one's JOD is read.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import content
from perfbench.traffic.scoring import ScoringTraffic

CHUNK = 8  # frames made on the device at a time


class Traffic(ScoringTraffic):
    def make_content(self):
        mix = self.cell.mix
        self.layout = mix["layout"]
        self.fps = float(self.cell.config["fps"])
        self.frames = int(mix["clip_frames"])
        P = int(mix["pool_frames"])
        shape = (P, 3, self.H, self.W) if self.layout == "FCHW" else (P, self.H, self.W, 3)
        self.pool = {s: np.empty(shape, self.dtype) for s in ("test", "ref")}
        g = content.generator(self.seed, 0, self.dev)
        scene = content.Scene(g, self.H, self.W, self.dev)
        for f0 in range(0, P, CHUNK):
            n = min(CHUNK, P - f0)
            ref = scene.frames(f0, n)
            for side, x in (("ref", ref), ("test", content.distort(g, ref))):
                q = content.quantise(x, self.dtype)
                if self.layout == "FHWC":
                    q = q.permute(0, 2, 3, 1).contiguous()
                self.pool[side][f0:f0 + n] = content.to_host(q, self.dtype)
            del ref, x, q
        del scene, g
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def pairs(self, i, stream=0):
        P = self.pool["ref"].shape[0]
        off = int(np.random.default_rng([self.seed, 100 + stream, i]).integers(
            0, P - self.frames + 1))
        return (self.pool["test"][off:off + self.frames],
                self.pool["ref"][off:off + self.frames])

    def end_to_end(self, records, window, peak):
        return {"frames_per_s": sum(r["frames"] for r in records) / window}
