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
import importlib.abc
import sys


# jax, jaxlib and optax import as if they were not installed (a None in
# sys.modules would also stop them, but scipy's array-API check then reads
# the None as a module).
class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "optax"):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None


for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "optax")]:
    del sys.modules[m]
sys.meta_path.insert(0, NoJax())
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
import json
from colorvideovdp_tpu_torch.calibration import data, extract_features, train
from colorvideovdp_tpu_torch.tools import convert_ml_ckpt
assert convert_ml_ckpt.validate(ct.cvvdp_ml_saliency(
    display_name="standard_4k", device="cpu", random_init=True).ml_weights()) == "cvvdp_ml_saliency"
with tempfile.TemporaryDirectory() as d:
    lines = ["test,reference,jod"]
    for i in range(4):
        split = "train" if i < 2 else "test"
        os.makedirs(f"{d}/features/{split}", exist_ok=True)
        qpc = (rng.rand(1, 4, 1 + 4 * (i % 2), 6) ** 2 * 0.8 + 0.01).tolist()
        fmap = {"rho_band": [30.0, 15.0, 7.5, 3.75, 1.875, 0.1]}
        fmap.update({f"t{c}_b{b}": [[f[c][t][b] for t in range(len(f[c]))] for f in qpc]
                     for c in range(4) for b in range(6)})
        with open(f"{d}/features/{split}/t{i}_fmap.json", "w") as f:
            json.dump(fmap, f)
        lines.append(f"t{i}.png,r{i // 2}.png,{9 - i}")
    with open(f"{d}/q.csv", "w") as f:
        f.write("\n".join(lines) + "\n")
    os.chdir(d)
    fit = train.main(["q.csv", "-e", "2", "-b", "2", "--train-ratio", "50", "--device", "cpu",
                      "--seed", "1", "--save", "best-rmse"])
    with open(fit["config"]) as f:
        fitted = json.load(f)
assert len(fit["epoch_s"]) == 2 and np.isfinite(fitted["jod_a"]), fitted
assert not any(m == "jax" or m.startswith("jax.") or m.startswith("colorvideovdp_tpu.")
               or m in ("optax", "calibration") or m.startswith("calibration.")
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
    # "colorvideovdp_tpu" followed by "_torch" is no word boundary; the
    # port's own calibration package is imported under its package name.
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|optax|colorvideovdp_tpu|calibration)\b",
                     re.M)
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in sources:
        with open(path) as fh:
            if pat.search(fh.read()):
                offenders.append(path)
    assert not offenders, offenders
    assert len(sources) > 40
