"""The port's clip-list runner against the JAX package's ``tools/run_cluster.py``
(CPU): two workers over a seeded list (per-row displays, a missing file),
``--resume`` and ``--merge``; the worker spec and device under torchrun;
``--merge`` without torch.

Tolerances: the merged rows equal the JAX runner's except Q_JOD, within
1e-4; the missing file's row reads "error" in both."""

import csv
import os
import subprocess
import sys

import pytest

pytest.importorskip("jax")

import run_cluster as rc_j  # noqa: E402  (tools/ is on the path: tests/conftest.py)

from colorvideovdp_tpu_torch.tools import run_cluster as rc_t  # noqa: E402

import _torch_media as media  # noqa: E402

JOD_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def clip_list(tmp_path_factory):
    d = tmp_path_factory.mktemp("cluster_media")
    rows = []
    for i in range(3):
        t, r = media.write_png_pair(str(d), H=48, W=64, seed=10 + i, tag=f"_{i}")
        rows.append([t, r, "standard_4k" if i == 1 else "", f"clip{i}"])
    rows.insert(2, [str(d / "missing.png"), rows[0][1], "", "missing"])
    path = str(d / "clips.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["test", "reference", "display", "tag"])
        w.writerows(rows)
    return path


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _run_workers(main, clip_list, result, extra=()):
    common = ["--list", clip_list, "--result", result, "--display", "standard_fhd", *extra]
    for k in ("0/2", "1/2"):
        main(common + ["--worker", k])
    shard0 = result[:-4] + ".shard000of002.csv"
    before = _read(shard0)
    main(common + ["--worker", "0/2", "--resume"])  # every row done: nothing added
    assert _read(shard0) == before
    main(["--merge", "--result", result, "--nshards", "2"])
    return _read(result)


def test_two_workers_resume_and_merge_match_jax(clip_list, tmp_path):
    rows_j = _run_workers(rc_j.main, clip_list, str(tmp_path / "jax.csv"))
    rows_t = _run_workers(rc_t.main, clip_list, str(tmp_path / "torch.csv"), ["--device", "cpu"])
    assert [r["tag"] for r in rows_t] == ["clip0", "missing", "clip1", "clip2"]
    assert len(rows_t) == len(rows_j)
    for a, b in zip(rows_t, rows_j):
        assert {k: v for k, v in a.items() if k != "Q_JOD"} == \
            {k: v for k, v in b.items() if k != "Q_JOD"}
        if b["tag"] == "missing":
            assert a["Q_JOD"] == b["Q_JOD"] == "error"
        else:
            assert 0 < float(a["Q_JOD"]) <= 10
            assert abs(float(a["Q_JOD"]) - float(b["Q_JOD"])) <= JOD_TOL


def test_worker_spec_and_device_under_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    args = rc_t.parse_args(["--result", "x.csv"])
    assert rc_t._worker_spec(args) == (0, 1) and rc_t._device(args) == "cuda"
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert rc_t._worker_spec(args) == (3, 4) and rc_t._device(args) == "cuda:1"
    assert rc_t._worker_spec(rc_t.parse_args(["--result", "x.csv", "--worker", "1/2"])) == (1, 2)
    assert rc_t._device(rc_t.parse_args(["--result", "x.csv", "--device", "cpu"])) == "cpu"


def test_merge_runs_without_torch(tmp_path):
    for k in range(2):
        with open(tmp_path / f"s.shard00{k}of002.csv", "w") as f:
            f.write(f"test,reference,metric,Q_JOD\nt{k},r{k},cvvdp,{k + 5}\n")
    script = ("import runpy, sys; sys.modules['torch'] = None; "
              f"sys.argv = ['run_cluster', '--merge', '--result', {str(tmp_path / 's.csv')!r}]; "
              "runpy.run_path('colorvideovdp_tpu_torch/tools/run_cluster.py', "
              "run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert [r["Q_JOD"] for r in _read(tmp_path / "s.csv")] == ["5", "6"]
