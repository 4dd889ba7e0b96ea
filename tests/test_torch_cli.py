"""The port's CLI against the JAX package's on the CPU, on seeded PNG, .yuv
and mp4 pairs: the CSV, the feature files, the heatmap, quiet output, frame
ranges, the display list, errors, the REPL and the console entry point.

Tolerances: CSV values within 1e-4 (JOD, dB, SSIM); features (per-band
pooled values) within 1e-4 of each value on SDR content, and within 5e-4
in the bands under 8 pixels wide (a few dozen samples through the masking's
powers: 1.7e-4 seen) and on PQ content, whose float32 EOTF is
ill-conditioned near the peak (ingest is held at 1e-4 there: 1.9e-4 seen);
heatmap PNGs within 1 code value (float16 maps within 1.1e-3)."""

import csv
import io
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from colorvideovdp_tpu import cli as cli_j  # noqa: E402
from colorvideovdp_tpu_torch import cli as cli_t  # noqa: E402

import _torch_media as media  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV_TOL = 1e-4
FEATURE_RTOL, FEATURE_RTOL_NARROW = 1e-4, 5e-4
AUX = ["-m", "cvvdp", "psnr-rgb", "pu-psnr-y", "ssim-metric"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_media")
    out = {"dir": d, "png": media.write_png_pair(str(d)),
           "yuv": media.write_yuv_pair(str(d))}
    from colorvideovdp_tpu_torch.io import ffcodec

    if ffcodec.enabled():
        test, ref = media.content(64, 96, 5, seed=3)
        out["mp4"] = [media.write_mp4(d / "t24.mp4", test[..., :4], 24),
                      media.write_mp4(d / "r30.mp4", ref, 30)]
    return out


CASES = {
    "image": ("png", ["--display", "standard_fhd", "--heatmap", "supra-threshold",
                      "--features", *AUX]),
    "yuv": ("yuv", ["--display", "standard_hdr_pq", "--features", "-m", "cvvdp", "pu-psnr-y"]),
    "temp_resample": ("mp4", ["--display", "standard_4k", "--temp-resample", "--features"]),
}


def _run(cli, files, case, tag, extra=()):
    kind, args = CASES[case]
    if kind not in files:
        pytest.skip("the native codec core is not built")
    out = files["dir"] / f"{case}_{tag}"
    res = str(out) + ".csv"
    t, r = files[kind]
    cli.run_on_args(cli.parse_args(["-t", t, "-r", r, "--result", res, "-o", str(out),
                                    *args, *extra]))
    with open(res) as f:
        rows = list(csv.reader(f))
    return out, rows


@pytest.fixture(scope="module")
def jax_runs(files):
    """One JAX CLI run per case (or None where its input cannot be made)."""
    return {case: (_run(cli_j, files, case, "jax") if CASES[case][0] in files else None)
            for case in CASES}


def _feature_rtol(key, fmap, pq):
    """The tolerance of feature ``t<c>_b<b>``: 1e-4, or 5e-4 on PQ content
    and where band b is under 8 pixels wide."""
    if not (key.startswith("t") and "_b" in key):
        return FEATURE_RTOL
    narrow = -(-fmap["width"] // 2 ** int(key.split("_b")[1])) < 8
    return FEATURE_RTOL_NARROW if pq or narrow else FEATURE_RTOL


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(files, jax_runs, case):
    if jax_runs[case] is None:
        pytest.skip("the native codec core is not built")
    out_j, rows_j = jax_runs[case]
    out_t, rows_t = _run(cli_t, files, case, "torch", ["--device", "cpu"])
    assert rows_t[0] == rows_j[0]  # the header: test, reference, short names
    assert len(rows_t) == len(rows_j) == 2 and rows_t[1][:2] == rows_j[1][:2]
    vals_t, vals_j = (np.array([float(v) for v in r[1][2:]]) for r in (rows_t, rows_j))
    assert np.all(np.isfinite(vals_t))
    np.testing.assert_allclose(vals_t, vals_j, rtol=0, atol=CSV_TOL)
    stem = os.path.splitext(os.path.basename(files[CASES[case][0]][0]))[0]
    with open(out_t / f"{stem}_fmap.json") as f:
        fm_t = json.load(f)
    with open(out_j / f"{stem}_fmap.json") as f:
        fm_j = json.load(f)
    assert sorted(fm_t) == sorted(fm_j)
    for k, v in fm_j.items():
        if isinstance(v, str):
            assert fm_t[k] == v
        else:
            np.testing.assert_allclose(fm_t[k], v, rtol=_feature_rtol(k, fm_j, case == "yuv"),
                                       atol=0, err_msg=k)
    if case == "image":
        from PIL import Image

        hm_t, hm_j = (np.asarray(Image.open(o / f"{stem}_heatmap.png"), np.int16)
                      for o in (out_t, out_j))
        assert hm_t.shape == hm_j.shape == (64, 96, 3)
        assert int(np.abs(hm_t - hm_j).max()) <= 1


def test_quiet_distogram_and_frame_range(files, tmp_path, capsys):
    """-q prints bare values, the image case's CSV values to 4 decimals; the
    distogram is written; --frames 0:2:4 scores frames 0, 2 and 4 of a PNG
    sequence, as the metric does on those frames."""
    import colorvideovdp_tpu_torch as ct

    t, r = files["png"]
    capsys.readouterr()
    cli_t.run_on_args(cli_t.parse_args(["-t", t, "-r", r, "--display", "standard_fhd",
                                        "--device", "cpu", "-q", *AUX]))
    vals = [float(v) for v in capsys.readouterr().out.split()]
    res = str(tmp_path / "q.csv")
    cli_t.run_on_args(cli_t.parse_args(["-t", t, "-r", r, "--display", "standard_fhd",
                                        "--device", "cpu", "--result", res, "--distogram",
                                        "-o", str(tmp_path)]))
    with open(res) as f:
        jod = float(list(csv.reader(f))[1][2])
    assert len(vals) == 4 and vals[0] == round(jod, 4)
    assert os.path.getsize(tmp_path / "test_distogram.png") > 0

    (tp, rp), test, ref = media.write_png_sequences(str(tmp_path))
    res = str(tmp_path / "frames.csv")
    cli_t.run_on_args(cli_t.parse_args(["-t", tp, "-r", rp, "--display", "standard_fhd",
                                        "--device", "cpu", "--fps", "30", "--frames", "0:2:4",
                                        "--result", res]))
    with open(res) as f:
        q_cli = float(list(csv.reader(f))[1][2])
    q_api, _ = ct.cvvdp(display_name="standard_fhd", device="cpu", temp_padding="symmetric",
                        ).predict(test[..., ::2], ref[..., ::2], dim_order="HWCF",
                                  frames_per_second=30)
    assert abs(q_cli - float(q_api)) <= CSV_TOL


def test_display_list_matches_jax(caplog):
    names = {}
    for tag, cli in (("jax", cli_j), ("torch", cli_t)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            cli.run_on_args(cli.parse_args(["--display", "?"]))
        names[tag] = [m.getMessage() for m in caplog.records
                      if m.getMessage().startswith("Photometric display model")]
    assert len(names["torch"]) > 5 and names["torch"] == names["jax"]


def test_missing_file_is_logged_without_a_traceback(tmp_path, caplog, capsys):
    caplog.clear()
    cli_t.main(["-t", str(tmp_path / "nope.png"), "-r", str(tmp_path / "nope2.png"),
                "--display", "standard_fhd", "--device", "cpu"])
    errors = [m.getMessage() for m in caplog.records if m.levelno >= logging.ERROR]
    assert any("nope.png" in e for e in errors), errors
    assert "Traceback" not in capsys.readouterr().err


def test_device_defaults_to_the_card(files):
    """Without --device the metrics are built for the card; on a machine
    without one that fails instead of moving to the CPU."""
    import torch

    assert cli_t.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    t, r = files["png"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_t.run_on_args(cli_t.parse_args(["-t", t, "-r", r, "-q"]))


def test_repl_reads_argument_lines(files, monkeypatch, capsys):
    t, r = files["png"]
    lines = [f"-t {t} -r {r} --display standard_fhd --device cpu -q",
             f"-t {t} -r {r} --display standard_fhd --device cpu -q -m psnr-rgb"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    capsys.readouterr()
    cli_t.main(["-i"])
    vals = [float(v) for v in capsys.readouterr().out.split()]
    assert len(vals) == 2 and 0 < vals[0] <= 10 and 10 < vals[1] < 60


def test_console_entry_point_in_a_subprocess(files, capsys):
    t, r = files["png"]
    args = ["-t", t, "-r", r, "--display", "standard_fhd", "--device", "cpu", "-q"]
    res = subprocess.run([sys.executable, "-m", "colorvideovdp_tpu_torch.cli", *args],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    capsys.readouterr()
    cli_t.run_on_args(cli_t.parse_args(args))
    assert res.stdout.split() == capsys.readouterr().out.split()
