"""The frozen reference against the port's plain path on the CPU, and its
isolation.

The reference (``perfbench/reference/cvvdp_ref.py``) must compute what the
port computes with its kernels off: the JOD and ``Q_per_ch`` of videos and
images on both configurations' displays, and the loss and its gradient. On
the CPU both run the same float32 arithmetic, so the tolerances are a few
ulps of the values compared.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.reference.cvvdp_ref import CVVDPReference
from perfbench.tests.conftest import ROOT

BLOCKER = r'''
import importlib.abc, sys
BLOCK = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
exec(sys.argv[3])
held = sorted({m.split(".")[0] for m in sys.modules} & BLOCK)
assert not held, held
print("ISOLATED")
'''


def _port(display):
    import colorvideovdp_tpu_torch as cvt

    return cvt.cvvdp(display_name=display, device="cpu")


def _video(seed, F=10, H=72, W=128):
    rng = np.random.RandomState(seed)
    ref = rng.rand(F, 3, H, W) * 0.5 + 0.2
    test = np.clip(ref + rng.randn(F, 3, H, W) * 0.02, 0, 1)
    return [np.round(a * 65535).astype(np.uint16) for a in (test, ref)]


@pytest.mark.parametrize("layout", ["FCHW", "FHWC"])
def test_video_matches_port(layout):
    test, ref = _video(1)
    Q, st = _port("standard_hdr_pq").predict(test, ref, dim_order="FCHW", frames_per_second=30)
    if layout == "FHWC":
        test, ref = (np.ascontiguousarray(a.transpose(0, 2, 3, 1)) for a in (test, ref))
    # Blocks of 3 frames: the temporal tails cross three block edges.
    r = CVVDPReference("standard_hdr_pq", block_pixels=72 * 128 * 8 * 3)
    jod, Qr = r.score(test, ref, layout, 30.0)
    assert Qr.shape == st["Q_per_ch"].shape
    assert abs(jod - float(Q)) <= 1e-5
    assert np.abs(Qr - st["Q_per_ch"]).max() <= 1e-5 * np.abs(Qr).max()


@pytest.mark.parametrize("display", ["standard_fhd", "standard_hdr_pq"])
def test_image_matches_port(display):
    rng = np.random.RandomState(2)
    ref = (rng.rand(64, 96, 3) * 200 + 20).astype(np.uint8)
    test = np.clip(ref + rng.randn(64, 96, 3) * 6, 0, 255).astype(np.uint8)
    Q, st = _port(display).predict(test, ref, dim_order="HWC")
    jod, Qr = CVVDPReference(display).score(test, ref, "HWC")
    assert abs(jod - float(Q)) <= 1e-5
    assert np.abs(Qr - st["Q_per_ch"]).max() <= 1e-5 * np.abs(Qr).max()


def test_loss_and_gradient_match_port():
    torch.manual_seed(3)
    ref = torch.rand(2, 3, 1, 64, 96) * 0.6 + 0.2
    test = (ref + torch.randn(ref.shape) * 0.03).clamp(0, 1)
    t = test.clone().requires_grad_(True)
    v = _port("standard_fhd").get_loss_fn(64, 96)(t, ref)
    v.backward()
    r = CVVDPReference("standard_fhd")
    L, g = r.loss_grad(test, ref)
    assert abs(L - float(v.detach())) <= 1e-5
    assert (t.grad - g).abs().max() <= 1e-5 * g.abs().max()
    # The whole-batch loss the control uses is the same function.
    assert abs(float(r.loss(test, ref)) - L) <= 1e-5


def test_bfloat16_departs_from_float32():
    """The control's precision moves the numbers the comparison holds."""
    test, ref = _video(4, F=6)
    j32, q32 = CVVDPReference("standard_hdr_pq").score(test, ref, "FCHW", 30.0)
    j16, q16 = CVVDPReference("standard_hdr_pq", dtype=torch.bfloat16).score(
        test, ref, "FCHW", 30.0)
    assert abs(j16 - j32) > 1e-2
    assert np.abs(q16 - q32).max() > 1e-2 * np.abs(q32).max()


@pytest.mark.parametrize("config", ["cvvdp-hdr-pq-4k", "cvvdp-sdr-fhd"])
def test_config_display_matches_data(config):
    """A configuration's display entry is the reference's copy and the entry
    the port reads (the JAX package's data file, read as JSON)."""
    with open(os.path.join(ROOT, "perfbench", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    for path in (os.path.join(ROOT, "perfbench", "reference", "data", "display_models.json"),
                 os.path.join(ROOT, "colorvideovdp_tpu", "vvdp_data", "display_models.json")):
        with open(path) as f:
            assert json.load(f)[cfg["display"]] == cfg["display_model"]
    assert cfg["resolution"] == cfg["display_model"]["resolution"]


def test_reference_data_is_a_copy():
    for name in ("cvvdp_parameters.json", "color_spaces.json", "csf_lut_weber_fixed_size.json"):
        with open(os.path.join(ROOT, "perfbench", "reference", "data", name)) as f:
            mine = json.load(f)
        with open(os.path.join(ROOT, "colorvideovdp_tpu", "vvdp_data", name)) as f:
            assert json.load(f) == mine


def _isolated(block, code):
    res = subprocess.run([sys.executable, "-c", BLOCKER, ",".join(block), ROOT, code],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ISOLATED" in res.stdout, res.stderr[-3000:]


def test_reference_imports_nothing_of_the_program():
    blocked = ["jax", "jaxlib", "optax", "flax", "colorvideovdp_tpu", "colorvideovdp_tpu_torch"]
    _isolated(blocked, """
import numpy as np, torch
from perfbench.reference.cvvdp_ref import CVVDPReference
r = CVVDPReference("standard_fhd")
a = (np.random.RandomState(0).rand(32, 48, 3) * 255).astype(np.uint8)
r.score(a, a[::-1].copy(), "HWC")
r.loss_grad(torch.rand(1, 3, 1, 32, 48), torch.rand(1, 3, 1, 32, 48))
""")


def test_harness_imports_no_jax(tmp_path):
    """A whole run of a scoring cell and of the loss cell on the CPU with JAX,
    its libraries and the JAX package blocked (whole top-level names: the
    port's own name begins with the JAX package's)."""
    from perfbench.tests.conftest import make_tiny_root

    root = make_tiny_root(str(tmp_path))
    _isolated(["jax", "jaxlib", "optax", "flax", "colorvideovdp_tpu"], f"""
import time
from perfbench import harness, readings, run
import glob, runpy
for path in glob.glob({root!r} + "/perfbench/layer_metrics/*.py"):
    runpy.run_path(path)
for cell in ("hdr4k-fchw", "fhd-loss-b4"):
    c = harness.load_cell(cell, {root!r})
    harness.run_cell(c, 7, 0.5, True, "cpu", time.perf_counter())
""")
