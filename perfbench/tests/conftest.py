"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
cells are cut to a few pixels and frames, so that the harness runs whole on
the CPU in a second or two a cell."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_RES = {"cvvdp-hdr-pq-4k": [128, 72], "cvvdp-sdr-fhd": [96, 64]}
TINY_MIX = {"clips-fchw": {"clip_frames": 10, "pool_frames": 14, "check_requests": 2},
            "clips-fhwc": {"clip_frames": 10, "pool_frames": 14, "check_requests": 2},
            "images-hwc": {"references": 3, "variants": 2, "check_requests": 4},
            "loss-b4": {"batch": 2, "check_steps": 1, "min_steps_per_s": 1,
                        "window_floor_s": 1}}


def make_tiny_root(dest: str) -> str:
    """A checkout-like directory: BENCHMARK.json and perfbench/, with every
    configuration and mix of the real benchmark shrunk."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(dest, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    base = os.path.join(dest, "perfbench")
    for name, res in TINY_RES.items():
        path = os.path.join(base, "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["resolution"] = res
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name, over in TINY_MIX.items():
        path = os.path.join(base, "traffic", f"{name}.json")
        with open(path) as f:
            mix = json.load(f)
        mix.update(over)
        with open(path, "w") as f:
            json.dump(mix, f)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))
