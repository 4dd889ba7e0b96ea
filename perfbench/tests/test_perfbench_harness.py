"""The harness on the CPU: the contract's names and limits, cells found by
name from files alone, the shape of the result line, a run without a card,
and the comparison failing on a broken program and on the control.

The runs use copies of the benchmark shrunk to a few pixels
(``conftest.make_tiny_root``); the harness is driven past its look for a
card (``harness.run_cell`` on the CPU, where the port takes its plain path).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "traffic", f"{w['traffic']}.json"))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert os.path.isfile(harness.reader_path(ROOT, m["name"]))
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    assert len(json.dumps(b)) < 64 * 1024


def test_traffic_kinds_exist():
    for w in _bench()["workloads"]:
        kind = harness.load_cell(w["name"]).mix["kind"]
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "traffic", f"{kind}.py"))


def test_cell_added_as_files_is_found(tiny_root):
    """A configuration, a mix, a cell, a per-layer metric and a stage pattern
    added as new files and entries only: the harness finds and runs them."""
    base = os.path.join(tiny_root, "perfbench")
    with open(os.path.join(base, "configs", "cvvdp-sdr-fhd.json")) as f:
        cfg = json.load(f)
    cfg["resolution"] = [80, 48]
    with open(os.path.join(base, "configs", "tiny-new.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(base, "traffic", "images-new.json"), "w") as f:
        json.dump({"kind": "score_images", "references": 2, "variants": 2, "check_requests": 2,
                   "limits": {"jod_gap": 1e-3, "q_rel_gap": 1e-3}}, f)
    with open(os.path.join(base, "layer_metrics", "requests_n.new.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.records)\n")
    os.makedirs(os.path.join(base, "stages", "newstage"))
    with open(os.path.join(base, "stages", "newstage", "x.json"), "w") as f:
        json.dump({"patterns": ["^no_such_kernel$"]}, f)
    b = _bench(tiny_root)
    b["configs"].append({"name": "tiny-new", "source": "https://example.org/new",
                         "file": "perfbench/configs/tiny-new.json", "reduced": [],
                         "why": "a new deployment"})
    b["workloads"].append({"name": "new-images", "config": "tiny-new", "traffic": "images-new",
                           "chips": 1, "why": "a new cell"})
    b["per_layer"].append({"name": "requests_n.new", "unit": "requests", "better": "higher",
                           "source": "program_counter", "layer": "API", "moves": "frames_per_s",
                           "workloads": ["new-images"]})
    # A metric of a family whose reader is there: no file of its own.
    b["per_layer"].append({"name": "pipeline_roofline_pct.new", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "kernels",
                           "moves": "frames_per_s", "workloads": ["new-images"]})
    for m in b["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("new-images")
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    cell = harness.load_cell("new-images", tiny_root)
    assert cell.config["resolution"] == [80, 48] and cell.mix["references"] == 2
    assert "newstage" in cell.stages and "band" in cell.stages
    res = harness.run_cell(cell, 11, 0.3, True, "cpu", time.perf_counter())
    assert res["metrics"]["requests_n.new"]["value"] == res["attempted"]
    assert res["metrics"]["pipeline_roofline_pct.new"]["value"] > 0
    res = harness.run_cell(cell, 11, 0.3, False, "cpu", time.perf_counter())
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"} and res["correct"]


@pytest.mark.parametrize("cell", ["hdr4k-fchw", "hdr4k-fhwc", "fhd-images", "fhd-loss-b4"])
def test_result_line(tiny_root, cell):
    """Every cell of the benchmark, shrunk: a sound run is correct, reports
    its end-to-end metrics (traced: its per-layer ones) and the result's
    keys are the contract's, the compared numbers last."""
    c = harness.load_cell(cell, tiny_root)
    for trace in (False, True):
        res = harness.run_cell(c, 2 ** 31 + 99, 1.0, trace, "cpu", time.perf_counter())
        keys = list(res)
        assert keys[:5] == KEYS and keys[-1] == "checks"
        assert set(keys) == set(KEYS) | {"checks"} | ({"breakdown", "stages"} if trace else set())
        assert res["correct"], res["checks"]
        assert res["failed"] == 0 and res["attempted"] >= 1
        want = c.per_layer if trace else c.end_to_end
        got = set(res["metrics"])
        assert got <= {m["name"] for m in want}
        if not trace:
            assert got == {m["name"] for m in want}
        for chk in res["checks"].values():
            assert set(chk) == {"value", "limit"}
        json.dumps(res, allow_nan=False)


def test_no_card_no_result():
    """Without a card the run fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", "fhd-images", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_benchmark_files_alone_fail(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/ (no program) gives
    no result."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(tmp_path, "perfbench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "fhd-images",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and "{" not in res.stdout


def _alter_jod(monkeypatch):
    from colorvideovdp_tpu_torch.metrics.cvvdp import cvvdp

    orig = cvvdp.do_pooling_and_jods
    monkeypatch.setattr(cvvdp, "do_pooling_and_jods",
                        lambda self, Q: orig(self, Q) - 0.05)


def _alter_band(monkeypatch):
    from colorvideovdp_tpu_torch.metrics import cvvdp as mod

    orig = mod.bm.pooled_norm
    monkeypatch.setattr(mod.bm, "pooled_norm", lambda sums, h, w, beta: orig(sums, h, w, beta)
                        * 1.01)


def _half_batch(monkeypatch):
    from colorvideovdp_tpu_torch.metrics.cvvdp import cvvdp

    orig = cvvdp.get_loss_fn

    def get_loss_fn(self, *a, **k):
        fn = orig(self, *a, **k)
        return lambda test, ref: fn(test[: test.shape[0] // 2], ref[: ref.shape[0] // 2])

    monkeypatch.setattr(cvvdp, "get_loss_fn", get_loss_fn)


def _unchanged(monkeypatch):
    """The step computes the loss but moves nothing: no gradient reaches the
    test batch."""
    from colorvideovdp_tpu_torch.metrics.cvvdp import cvvdp

    orig = cvvdp.get_loss_fn

    def get_loss_fn(self, *a, **k):
        fn = orig(self, *a, **k)

        def step(test, ref):
            with torch.no_grad():
                v = fn(test, ref)
            return v + 0.0 * test.sum()
        return step

    monkeypatch.setattr(cvvdp, "get_loss_fn", get_loss_fn)


@pytest.mark.parametrize("cell, fault", [
    ("hdr4k-fchw", _alter_jod), ("fhd-images", _alter_jod), ("hdr4k-fhwc", _alter_band),
    ("fhd-loss-b4", _half_batch), ("fhd-loss-b4", _unchanged)])
def test_broken_program_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = harness.run_cell(harness.load_cell(cell, tiny_root), 5, 0.5, False, "cpu",
                           time.perf_counter())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cell", ["hdr4k-fchw", "fhd-images", "fhd-loss-b4"])
def test_control_is_not_correct(tiny_root, cell, device):
    """The reference in bfloat16 in the program's place fails the
    comparison."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run_cell(harness.load_cell(cell, tiny_root), 6, 0.5, False, device,
                           time.perf_counter(), program="control")
    assert not res["correct"], res["checks"]
