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
from colorvideovdp_tpu_torch.ops.kernels import band_fused
from colorvideovdp_tpu_torch.tools import interleave_bench
seen = []
fused_sums = band_fused.band_fused_sums
band_fused.band_fused_sums = lambda *a: seen.append(a[0].shape) or fused_sums(*a)
m = ct.cvvdp(display_name="standard_4k", device="cpu")
m.use_band_mega = m.force_fused = True
ref2 = (rng.rand(48, 256, 3) * 255).astype(np.uint8)
Q_mega, _ = m.predict(np.clip(ref2.astype(np.int16) + 9, 0, 255).astype(np.uint8), ref2,
                      dim_order="HWC")
assert np.isfinite(float(Q_mega)) and len(seen) == 1, (float(Q_mega), seen)
assert interleave_bench.main(["--cpu-check"]) == 0
import torch
from colorvideovdp_tpu_torch.ops.kernels import band_pooled, ingest
pooled = []
band_pooled_sums = band_pooled.band_pooled_sums
band_pooled.band_pooled_sums = lambda *a: pooled.append(len(a[0])) or band_pooled_sums(*a)
Q_pooled, _ = ct.cvvdp(display_name="standard_4k", device="cpu").predict(
    test[..., 0], ref[..., 0], dim_order="HWC")
assert np.isfinite(float(Q_pooled)) and pooled, (float(Q_pooled), pooled)
dm = ct.vvdp_display_photometry.load("standard_hdr_pq")
table = ingest.eotf_table_plain(dm, torch.uint8)
raw = torch.from_numpy(np.ascontiguousarray(ref.transpose(3, 2, 0, 1)[None]))  # (1, F, 3, H, W)
assert torch.equal(ingest.eotf_from_table(dm, table, raw),
                   dm.forward(ingest.raw_to_float(raw).transpose(1, 2)))
from colorvideovdp_tpu_torch.tools import shard_check
assert shard_check.main(["--cpu", "--ranks", "2", "--size", "48x256", "--frames", "3",
                         "--block-frames", "2"]) == 0
import os
import tempfile
with tempfile.TemporaryDirectory() as d:
    names = []
    for tag in ("t", "r"):
        name = f"{d}/{tag}_48x32p24_420_10b_2020.yuv"
        with open(name, "wb") as f:
            f.write((rng.rand(3 * 48 * 32 * 3 // 2) * 1023).astype("<u2").tobytes())
        names.append(name)
    vs = ct.video_source_file(*names, display_photometry="standard_hdr_pq")
    Q_yuv, st_yuv = ct.cvvdp(display_name="standard_hdr_pq", device="cpu").predict_video_source(vs)
    psnr, _ = ct.psnr_rgb(display_name="standard_hdr_pq", device="cpu").predict_video_source(vs)
    from colorvideovdp_tpu_torch import cli
    cli.run_on_args(cli.parse_args(["-t", names[0], "-r", names[1], "--display",
                                    "standard_hdr_pq", "--device", "cpu", "-q",
                                    "--dump-channels", "difference", "-o", d]))
    dumped = sorted(os.listdir(d))
assert np.isfinite(float(Q_yuv)) and st_yuv["N_frames"] == 3, float(Q_yuv)
assert np.isfinite(float(psnr)), float(psnr)
assert any(f.startswith("diff.") for f in dumped), dumped
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
