"""The ML and heatmap cells on the CPU: both kinds run a shrunk cell end
to end through ``harness.run_cell``, the control fails each comparison, a
program without the output a kind needs fails at set-up, the ML work counts
of a small shape match a hand count, and the new readers read None where
their spans or configuration are absent."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from types import SimpleNamespace

import pytest

from perfbench import harness, program_spans, work
from perfbench.reference.cvvdp_ref import Display
from perfbench.tests.conftest import ROOT, make_tiny_root
from perfbench.work import ml

CELLS = ["hdr4k-ml-transformer", "hdr4k-heatmap"]
TINY_RES = {"cvvdp-ml-transformer-hdr-pq-4k": [96, 64]}
TINY_MIX = {"ml-clips-fchw": {"clip_frames": 10, "pool_frames": 14},
            "clips-fchw-heatmap": {"clip_frames": 10, "pool_frames": 14, "kept_maps": 1,
                                   "kept_among": 1}}


def _edit(path, over):
    with open(path) as f:
        d = json.load(f)
    d.update(over)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture
def tiny(tmp_path):
    root = make_tiny_root(str(tmp_path))
    base = os.path.join(root, "perfbench")
    for name, res in TINY_RES.items():
        _edit(os.path.join(base, "configs", f"{name}.json"), {"resolution": res})
    for name, over in TINY_MIX.items():
        _edit(os.path.join(base, "traffic", f"{name}.json"), over)
    return root


@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_runs_end_to_end(tiny, cell):
    c = harness.load_cell(cell, tiny)
    for trace in (False, True):
        res = harness.run_cell(c, 2 ** 31 + 99, 1.5, trace, "cpu", time.perf_counter())
        assert res["correct"], res["checks"]
        assert res["failed"] == 0 and res["attempted"] >= 1
        got = set(res["metrics"])
        if trace:
            new = {m["name"] for m in c.per_layer} - {"device_idle_pct.score"}
            assert got == new, got ^ new  # no device operation on the CPU
            for m in res["metrics"].values():
                assert math.isfinite(m["value"]) and m["value"] >= 0
        else:
            assert got == {"frames_per_s", "setup_s"}
        json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_new_cell_control_is_not_correct(tiny, cell):
    res = harness.run_cell(harness.load_cell(cell, tiny), 6, 0.5, False, "cpu",
                           time.perf_counter(), program="control")
    assert not res["correct"]
    assert all(c["value"] > c["limit"] for c in res["checks"].values()), res["checks"]


def _no_deltas(monkeypatch):
    from colorvideovdp_tpu_torch.metrics import ml as ml_mod

    orig = ml_mod.cvvdp_ml_base._predict_video_source

    def predict(self, vs, root):
        Q, st = orig(self, vs, root)
        st.pop("delta_per_band")
        return Q, st

    monkeypatch.setattr(ml_mod.cvvdp_ml_base, "_predict_video_source", predict)


def _no_heatmap(monkeypatch):
    from colorvideovdp_tpu_torch.metrics import cvvdp as mod

    orig = mod.cvvdp._predict_video_source

    def predict(self, vs, root):
        Q, st = orig(self, vs, root)
        st.pop("heatmap")
        return Q, st

    monkeypatch.setattr(mod.cvvdp, "_predict_video_source", predict)


@pytest.mark.parametrize("cell, fault", [("hdr4k-ml-transformer", _no_deltas),
                                         ("hdr4k-heatmap", _no_heatmap)])
def test_program_without_the_output_fails_at_setup(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    with pytest.raises(RuntimeError, match="gives no"):
        harness.run_cell(harness.load_cell(cell, tiny), 5, 0.5, False, "cpu",
                         time.perf_counter())


def _wrong_band(monkeypatch):
    from colorvideovdp_tpu_torch.metrics import ml as ml_mod

    orig = ml_mod.cvvdp_ml_transformer.band_deltas
    monkeypatch.setattr(ml_mod.cvvdp_ml_transformer, "band_deltas",
                        lambda self, f: [d * (1.01 if k == 2 else 1.0)
                                         for k, d in enumerate(orig(self, f))])


def _wrong_map(monkeypatch):
    from colorvideovdp_tpu_torch.metrics import cvvdp as mod

    orig = mod.cvvdp._heatmap_map
    monkeypatch.setattr(mod.cvvdp, "_heatmap_map",
                        lambda self, hm, ctx: orig(self, hm * 1.05, ctx))


@pytest.mark.parametrize("cell, fault", [("hdr4k-ml-transformer", _wrong_band),
                                         ("hdr4k-heatmap", _wrong_map)])
def test_broken_program_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = harness.run_cell(harness.load_cell(cell, tiny), 5, 0.5, False, "cpu",
                           time.perf_counter())
    assert not res["correct"], res["checks"]


def test_ml_counts_by_hand():
    """An 8x8 two-frame clip at 3 pixels a degree: levels 8x8, 4x4, 2x2 (one
    blurred interior band, 3-pixel tiles), a head of width 4, one layer,
    2 heads, MLP 8."""
    s = work.Shape(B=1, F=2, H=8, W=8, channels=4, fl=9, sample_bytes=2, eotf="PQ", ppd=3.0)
    m = ml.Head(in_features=24, dim=4, depth=1, heads=2, mlp=8)
    assert work.levels(s) == [(8, 8), (4, 4), (2, 2)]
    assert ml.tiles(s) == [(3, 3), (2, 2), (1, 1)]
    c = ml.stage_counts(s, m)
    # Ingest: 256 pixels (2 frames of 64, 2 sides), 3 x 15 (PQ) + 15 + 4 x 17.
    assert c["ingest"] == (256 * 128, 256 * 6 + 256 * 16)
    # Reduce, 16 planes: 8x8 -> 4x4 (9 x (32 + 16)), 4x4 -> 2x2 (9 x (8 + 4)).
    assert c["reduce"] == (16 * 9 * 60, 16 * 4 * (64 + 16 + 16 + 4))
    # The band: expand 16 x 4 x (32 + 64); 128 pixel-frames x (band ops
    # 100 + 200 of the blur + 96, less 16 of pooling, plus 16 for S|T| and
    # S|R|).
    assert work.band_ops_per_pixel(4, True) == 396
    assert c["band"] == (16 * 4 * 96 + 128 * 396, 16 * 4 * (64 + 16) + 128 * 12 * 4)
    # Baseband, 2 frames of 2x2: 2 + 32 + 28 a pixel; 20 planes read and written.
    assert c["baseband"] == (8 * 62, 8 * 20 * 4)
    # Statistics: 3 x 4 planes a frame, 3 a pixel, 4 a tile.
    px, tl = 64 + 16 + 4, 9 + 4 + 1
    assert c["statistics"] == (2 * 12 * (3 * px + 4 * tl), 2 * 4 * 4 * (3 * px + 6 * tl))
    # Head: per token and layer 2 x 7 x 4 + 8 x 16 + 16 + 16 L + 8 L + 128 + 8
    # + 4 + 40 + 8 = 388 + 24 L; per tile 24 + 2 x 24 x 4 + 4 = 220; class
    # token 28 + 8 + 2 = 38; L = 10, 5, 2.
    head = sum(2 * (L * (388 + 24 * L) + (L - 1) * 220 + 38) for L in (10, 5, 2))
    weights = 4 * 25 + 4 + (64 + 16 + 64 + 8 + 4 + 16) + 13
    assert c["head"] == (head, 2 * 4 * 6 * 4 * (9 + 4 + 1) + weights * 4 + 3 * 4)
    ops, byt = ml.pipeline(s, m)
    assert ops == sum(o for o, _ in c.values())
    assert byt == 2 * 64 * 3 * 2 * 2 + 3 * 4


def test_ml_counts_of_the_cell():
    """At the cell's shape the head is about three quarters of the
    operations, and the whole is bound by its operations."""
    s = work.Shape(B=1, F=32, H=2160, W=3840, channels=4, fl=9, sample_bytes=2, eotf="PQ",
                   ppd=Display("standard_hdr_pq").ppd)
    assert ml.tiles(s)[0] == (29, 51)
    c = ml.stage_counts(s, ml.Head())
    ops, byt = ml.pipeline(s, ml.Head())
    assert 0.2 < c["head"][0] / ops < 0.8
    assert ops / work.PEAK_FLOPS > byt / work.PEAK_BYTES
    assert ml.pipeline(dataclasses.replace(s, F=64), ml.Head())[0] == 2 * ops


def _ctx(cell, spans=None, trace=True, records=True):
    tr = SimpleNamespace(t0=0, t1=10_000_000, window_s=0.01) if trace else None
    return SimpleNamespace(cell=cell, trace=tr, records=[{"frames": 2}] if records else [],
                           traffic=SimpleNamespace(shape=lambda f: None), work=work,
                           spans=spans)


@pytest.mark.parametrize("metric", ["ml_head_ms.score", "heatmap_ms.score"])
def test_span_readers_read_none_without_their_spans(monkeypatch, metric):
    cell = harness.load_cell("hdr4k-heatmap", ROOT)
    read = harness.layer_reader(cell, metric)
    monkeypatch.setattr(program_spans, "window", lambda ctx: None)
    assert read(_ctx(cell)) is None
    other = [SimpleNamespace(name=n, start=0, end=5) for n in ("cvvdp.predict", "cvvdp.bands")]
    monkeypatch.setattr(program_spans, "window", lambda ctx: other)
    assert read(_ctx(cell)) is None


def test_ml_roofline_reads_none_outside_its_configuration():
    read = harness.layer_reader(harness.load_cell("hdr4k-heatmap", ROOT),
                                "ml_pipeline_roofline_pct.score")
    assert read(_ctx(harness.load_cell("hdr4k-heatmap", ROOT))) is None
    ml_cell = harness.load_cell("hdr4k-ml-transformer", ROOT)
    assert read(_ctx(ml_cell, trace=False)) is None
    assert read(_ctx(ml_cell, records=False)) is None


def test_new_cells_with_jax_blocked(tiny):
    from perfbench.tests.test_perfbench_reference import _isolated

    _isolated(["jax", "jaxlib", "optax", "flax", "colorvideovdp_tpu"], f"""
import time
from perfbench import harness
root = {tiny!r}
for cell in {CELLS!r}:
    c = harness.load_cell(cell, root)
    harness.run_cell(c, 7, 0.5, True, "cpu", time.perf_counter())
""")
