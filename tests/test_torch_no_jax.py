"""The PyTorch port runs with jax made unimportable, and no file of it
imports jax or the JAX package."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "colorvideovdp_tpu_torch")

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
import numpy as np
import colorvideovdp_tpu_torch as ct
rng = np.random.RandomState(0)
ref = (rng.rand(16, 128, 3, 3) * 255).astype(np.uint8)
test = np.clip(ref.astype(np.int16) + 9, 0, 255).astype(np.uint8)
Q, _ = ct.cvvdp(display_name="standard_4k", device="cpu").predict(
    test, ref, dim_order="HWCF", frames_per_second=30)
assert np.isfinite(float(Q)), float(Q)
_, st = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap="supra-threshold").predict(
    test[..., 0], ref[..., 0], dim_order="HWC")
assert st["heatmap"].shape == (1, 3, 1, 16, 128)
Q_ml, _ = ct.cvvdp_ml_transformer(display_name="standard_4k", device="cpu",
                                  random_init=True).predict(
    test, ref, dim_order="HWCF", frames_per_second=30)
assert np.isfinite(float(Q_ml)), float(Q_ml)
assert not any(m == "jax" or m.startswith("jax.") or m.startswith("colorvideovdp_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
print("JOD", float(Q), float(Q_ml))
"""


def test_port_scores_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "JOD" in res.stdout


def test_no_jax_imports_in_port_sources():
    # "colorvideovdp_tpu" followed by "_torch" is no word boundary.
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|colorvideovdp_tpu)\b", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert not offenders, offenders
