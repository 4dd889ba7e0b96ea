"""The port against the benchmark's plain references (CPU): its
``cvvdp_ml_transformer`` against ``perfbench/reference/cvvdp_ml_ref.py``
and its supra-threshold heatmap against ``perfbench/reference/
heatmap_ref.py``, at 64x96 on ``standard_hdr_pq``, on a 10-frame clip in
4-frame blocks and on one image; the head's weights under the benchmark
cell's rule (``seeded_weights`` with its configuration's ``reg_head_bias``);
and the references' isolation from the program and from JAX.

Tolerances: on the CPU the port's plain path and the reference run the same
float32 arithmetic in other orders (the port's contrast bands against the
reference's per-band expand, the masking chain's products, the head's
fused linear layers against ``matmul`` + bias), so the JOD and each band's
delta agree to a few float32 steps of their size: 1e-5 absolute on a JOD
near 7 (about 16 steps) and 1e-5 of the largest delta (about 80 steps of
~0.4). The float16 heatmap moves by one float16 step where a value lies on
a rounding boundary: 2^-11 = 4.9e-4 in [0.5, 1), so 1e-3 allows two.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import colorvideovdp_tpu_torch as ct
from perfbench.reference.cvvdp_ml_ref import CVVDPMLReference, seeded_weights
from perfbench.reference.heatmap_ref import HeatmapReference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISPLAY, H, W, N, BLK, FPS = "standard_hdr_pq", 64, 96, 10, 4, 30.0
with open(os.path.join(REPO, "perfbench", "configs", "cvvdp-ml-transformer-hdr-pq-4k.json")) as f:
    CELL = json.load(f)
REG_BIAS = CELL["weights"]["reg_head_bias"]


def _clip(seed, F=N, noise=0.02):
    rng = np.random.RandomState(seed)
    ref = rng.rand(F, 3, H, W) * 0.5 + 0.2
    test = np.clip(ref + rng.randn(F, 3, H, W) * noise, 0, 1)
    return [np.round(a * 65535).astype(np.uint16) for a in (test, ref)]


def _image(seed):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(H, W, 3) * 200 + 20).astype(np.uint8)
    test = np.clip(ref + rng.randn(H, W, 3) * 6, 0, 255).astype(np.uint8)
    return test, ref


def _ml(flat, blk=BLK):
    m = ct.cvvdp_ml_transformer(display_name=DISPLAY, device="cpu", random_init=True,
                                dim=CELL["dim"])
    m.load_weights(flat)
    m.gpu_mem = m.block_gpu_mem(H * W, blk, FPS)
    return m


def _score(m, case, seed):
    if case == "video":
        test, ref = _clip(seed)
        Q, st = m.predict(test, ref, dim_order="FCHW", frames_per_second=FPS)
        return (test, ref, "FCHW"), float(Q), st
    test, ref = _image(seed)
    Q, st = m.predict(test, ref, dim_order="HWC")
    return (test, ref, "HWC"), float(Q), st


@pytest.mark.parametrize("case", ["video", "image"])
def test_ml_transformer_matches_reference(case):
    flat = seeded_weights(5, CELL["in_channels"], CELL["dim"], CELL["depth"], REG_BIAS)
    (test, ref, order), Q, st = _score(_ml(flat), case, 3)
    if case == "video":
        assert st["block_N_frames"] == BLK
    # The reference in 3-frame blocks: its block edges differ from the port's.
    r = CVVDPMLReference(DISPLAY, flat, heads=CELL["heads"], block_pixels=H * W * 8 * 3)
    jod, d = r.score(test, ref, order, FPS)
    got = st["delta_per_band"]
    assert got.shape == (1, d.shape[0]) and got.dtype == np.float32
    assert np.all(d > 0)
    assert abs(Q - jod) <= 1e-5
    assert np.abs(got[0] - d).max() <= 1e-5 * np.abs(d).max()
    # The JOD is 10 less the deltas.
    assert abs(10.0 - float(got.sum()) - Q) <= 1e-5


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 2 ** 31 + 5])
def test_every_band_delta_is_positive_under_the_cell_rule(seed):
    """With the cell's ``reg_head`` bias no band's ReLU reads 0; with a zero
    bias the head reads 0 in every band for most seeds (why the bias)."""
    flat = seeded_weights(seed, CELL["in_channels"], CELL["dim"], CELL["depth"], REG_BIAS)
    _, Q, st = _score(_ml(flat), "video", seed)
    assert np.all(st["delta_per_band"] > 0), st["delta_per_band"]
    assert Q < 10.0


def test_zero_bias_leaves_the_trunk_unread():
    zero = [bool(np.all(_score(_ml(seeded_weights(s, reg_bias=0.0)), "video", s)[2]
                        ["delta_per_band"] == 0)) for s in (1, 2, 3)]
    assert any(zero), zero


def test_ml_reference_bfloat16_departs():
    """The control's precision moves the compared numbers."""
    flat = seeded_weights(6, reg_bias=REG_BIAS)
    test, ref = _clip(6, F=6)
    j32, d32 = CVVDPMLReference(DISPLAY, flat).score(test, ref, "FCHW", FPS)
    j16, d16 = CVVDPMLReference(DISPLAY, flat, dtype=torch.bfloat16).score(test, ref, "FCHW", FPS)
    assert abs(j16 - j32) > 1e-3
    assert np.abs(d16 - d32).max() > 1e-3 * np.abs(d32).max()


@pytest.mark.parametrize("case", ["video", "image"])
def test_heatmap_matches_reference(case):
    m = ct.cvvdp(display_name=DISPLAY, device="cpu", heatmap="supra-threshold")
    m.gpu_mem = m.block_gpu_mem(H * W, BLK, FPS)
    (test, ref, order), Q, st = _score(m, case, 4)
    r = HeatmapReference(DISPLAY, block_pixels=H * W * 8 * 3)
    jod, Qr, hm = r.score(test, ref, order, FPS, tone_frames=st["block_N_frames"])
    assert hm.dtype == np.float16 and hm.shape == st["heatmap"].shape
    assert abs(Q - jod) <= 1e-5
    assert np.abs(Qr - st["Q_per_ch"]).max() <= 1e-5 * np.abs(Qr).max()
    assert np.abs(hm.astype(np.float32) - st["heatmap"].astype(np.float32)).max() <= 1e-3
    # The map is not flat: the comparison sees the colours.
    assert np.ptp(hm.astype(np.float32)) > 0.1


def test_heatmap_reference_bfloat16_departs():
    test, ref = _clip(7, F=5, noise=0.05)
    _, _, h32 = HeatmapReference(DISPLAY).score(test, ref, "FCHW", FPS)
    _, _, h16 = HeatmapReference(DISPLAY, dtype=torch.bfloat16).score(test, ref, "FCHW", FPS)
    assert np.abs(h16.astype(np.float32) - h32.astype(np.float32)).max() > 1e-2


_ISOLATED = r"""
import importlib.abc, sys
BLOCK = {"jax", "jaxlib", "optax", "flax", "colorvideovdp_tpu", "colorvideovdp_tpu_torch"}
for m in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[m]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import numpy as np
from perfbench.reference.cvvdp_ml_ref import CVVDPMLReference, seeded_weights
from perfbench.reference.heatmap_ref import HeatmapReference
rng = np.random.RandomState(0)
a = (rng.rand(4, 3, 32, 48) * 60000).astype(np.uint16)
b = a[:, :, ::-1].copy()
CVVDPMLReference("standard_hdr_pq", seeded_weights(1, reg_bias=3.0)).score(a, b, "FCHW", 30.0)
HeatmapReference("standard_hdr_pq").score(a, b, "FCHW", 30.0)
held = sorted({m.split(".")[0] for m in sys.modules} & BLOCK)
assert not held, held
print("ISOLATED")
"""


def test_references_import_neither_jax_nor_the_program():
    res = subprocess.run([sys.executable, "-c", _ISOLATED, REPO], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "ISOLATED" in res.stdout, res.stderr[-3000:]
