"""Synthetic test content shared by ``chip_smoke.py`` and the tools."""

from __future__ import annotations

import numpy as np


def hdr_clip(H: int, W: int, N: int, rng: np.random.RandomState):
    """(test, reference) (H, W, 3, N) uint8 for standard_hdr_pq: a horizontal
    gradient as the reference, plus seeded noise for the test."""
    base = np.linspace(0.1, 0.7, W, dtype=np.float32)[None, :, None]
    ref = (np.broadcast_to(base, (H, W, 3)) * 255).astype(np.uint8)
    V_ref = np.repeat(ref[:, :, :, None], N, axis=3)
    noise = (rng.randn(H, W, 3, N) * 8).astype(np.int16)
    V_test = np.clip(V_ref.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return V_test, V_ref


class FrameByFrame:
    """A source with its raw-block methods hidden, so that the metric reads it
    through ``get_test_frame``."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        if name in ("get_raw_block", "get_raw_frame_list", "unpack_raw_block"):
            raise AttributeError(name)
        return getattr(self.inner, name)
