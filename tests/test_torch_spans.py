"""The port's spans (``colorvideovdp_tpu_torch/utils/spans.py``) on the CPU:
nothing recorded with the profiler off; under ``torch.profiler`` the tree
of a two-block FHWC ``predict`` (its request, no relayout, the prefetch
worker's read, the uploads' bytes and channel-last counts), each leaf span
as a ``record_function`` event of the profile at the span's own time (the
relayout's in an HWCF ``predict``), the loss's backward holding its
recompute, the ML metric's blocks and head with its token count, and the
heatmap's span with its bytes."""

from __future__ import annotations

import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import colorvideovdp_tpu_torch as ct
from colorvideovdp_tpu_torch.metrics import cvvdp as cvvdp_mod
from colorvideovdp_tpu_torch.utils import spans

H, W, F, BLK, FPS = 48, 80, 6, 4, 30


def _clip(seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 65536, (F, H, W, 3), dtype=np.uint16)
    noise = rng.integers(-2000, 2000, ref.shape)
    test = np.clip(ref.astype(np.int32) + noise, 0, 65535).astype(np.uint16)
    return test, ref


def _metric():
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cpu")
    m.gpu_mem = m.block_gpu_mem(H * W, BLK, FPS)
    return m


def _loss_step(m):
    g = torch.Generator().manual_seed(1)
    ref = torch.rand((1, 3, 1, H, W), generator=g)
    test = (ref + 0.05 * torch.randn(ref.shape, generator=g)).clamp(0, 1).requires_grad_()
    m.get_loss_fn(H, W)(test, ref).backward()


def _predict(m):
    test, ref = _clip()
    m.predict(test, ref, dim_order="FHWC", frames_per_second=FPS)


def _ml_metric():
    m = ct.cvvdp_ml_transformer(display_name="standard_hdr_pq", device="cpu", random_init=True,
                                dim=32)
    m.gpu_mem = m.block_gpu_mem(H * W, BLK, FPS)
    return m


def _heatmap_metric():
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cpu", heatmap="supra-threshold")
    m.gpu_mem = m.block_gpu_mem(H * W, BLK, FPS)
    return m


def _predict_hwcf(m):
    test, ref = (np.ascontiguousarray(x.transpose(1, 2, 3, 0)) for x in _clip())
    m.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)


@pytest.fixture
def fresh():
    spans.clear()
    yield
    spans.clear()


@pytest.mark.parametrize("run, setup", [(_predict, _metric),
                                        (_loss_step, lambda: ct.cvvdp(device="cpu")),
                                        (_predict, _ml_metric), (_predict, _heatmap_metric)])
def test_profiler_off_records_nothing(fresh, run, setup):
    run(setup())
    assert spans.recorded() == []
    assert spans.span("cvvdp.block", frames=3) is spans.OFF
    assert spans.span("cvvdp.read") is spans.OFF
    assert spans.carried(len) is len


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("cvvdp.")]
    return spans.recorded(), events


@pytest.fixture
def traced_predict(fresh, monkeypatch):
    uploaded = []
    real = cvvdp_mod.upload

    def upload(a, device):
        uploaded.append(a.nbytes)
        return real(a, device)

    monkeypatch.setattr(cvvdp_mod, "upload", upload)
    rec, events = _profiled(_predict, _metric())
    return rec, events, uploaded


def test_predict_records_its_tree(traced_predict):
    rec, _, uploaded = traced_predict
    assert all(s.end is not None and s.end >= s.start for s in rec)
    roots = [s for s in rec if s.name == "cvvdp.predict"]
    assert len(roots) == 1 and roots[0].parent == -1
    root = roots[0]
    assert root.attrs == {"frames": F, "block_N": BLK}
    assert {s.request for s in rec} == {root.request}
    by_index = {s.index: s for s in rec}
    for s in rec:
        if s is not root:
            p = by_index[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p, s)
    names = [s.name for s in rec]
    # FHWC blocks go to the device as they lie: no host relayout.
    assert names.count("cvvdp.relayout") == 0
    assert names.count("cvvdp.block") == 2
    assert names.count("cvvdp.prefetch_submit") == names.count("cvvdp.prefetch_wait") == 1
    for s in rec:
        if s.name in ("cvvdp.ingest", "cvvdp.pyramid", "cvvdp.bands", "cvvdp.baseband"):
            assert by_index[s.parent].name == "cvvdp.block"
    main = root.thread
    worker = [s for s in rec if s.name == "cvvdp.read" and s.thread != main]
    assert len(worker) == 2 and all(s.parent == root.index for s in worker)
    assert sorted((s.attrs["frames"], s.attrs["padded"]) for s in worker) == [(BLK, 2)] * 2
    ups = [s for s in rec if s.name == "cvvdp.upload"]
    assert len(ups) == 4 and sum(s.attrs["bytes"] for s in ups) == sum(uploaded)
    assert [s.attrs["channel_last"] for s in ups] == [1] * 4
    assert sum(uploaded) == 2 * 2 * BLK * H * W * 3 * 2


def test_leaf_spans_are_profiler_events(traced_predict):
    fhwc, fhwc_events, _ = traced_predict
    spans.clear()
    # HWCF keeps the host relayout, the one leaf an FHWC request skips.
    hwcf, hwcf_events = _profiled(_predict_hwcf, _metric())
    rec, events = fhwc + hwcf, fhwc_events + hwcf_events
    main = threading.get_ident()
    leaves = [s for s in rec if s.name in spans.LEAVES and s.thread == main]
    # The ML head's and the heatmap's leaves open on their own paths (below).
    assert {s.name for s in leaves} == spans.LEAVES - {"cvvdp.ml.head", "cvvdp.heatmap"}
    assert "cvvdp.relayout" not in {s.name for s in fhwc}
    # The prefetch worker's profiler reads off: its reads are in memory only.
    assert len(events) == len(leaves)
    assert not {e[0] for e in events} - spans.LEAVES
    for s, e in zip(leaves, sorted(events, key=lambda e: e[1])):
        assert e[0] == s.name and abs(e[1] - s.start) <= 2_000_000, (s, e)
    for th in {e[3] for e in events}:
        mine = sorted((e for e in events if e[3] == th), key=lambda e: e[1])
        for a, b in zip(mine, mine[1:]):
            assert b[1] >= a[2], f"{b[0]} opens inside {a[0]}"


def test_loss_backward_holds_the_recompute(fresh):
    rec, _ = _profiled(_loss_step, ct.cvvdp(device="cpu"))
    by_name = {}
    for s in rec:
        by_name.setdefault(s.name, []).append(s)
    fwd, = by_name["cvvdp.loss.forward"]
    bwd, = by_name["cvvdp.loss.backward"]
    rcp, = by_name["cvvdp.loss.recompute"]
    blk, = by_name["cvvdp.block"]
    assert bwd.parent == fwd.index and rcp.parent == bwd.index and blk.parent == fwd.index
    assert bwd.start <= rcp.start and rcp.end <= bwd.end and fwd.end <= bwd.start
    assert {s.request for s in rec} == {fwd.request}
    inner = [s.name for s in rec if s.parent == rcp.index]
    assert inner[:3] == ["cvvdp.ingest", "cvvdp.pyramid", "cvvdp.bands"]


def test_list_is_bounded(fresh, monkeypatch):
    monkeypatch.setattr(spans, "_spans", deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(6):
            with spans.span("cvvdp.block", k=k):
                pass
    rec = spans.recorded()
    assert [s.attrs["k"] for s in rec] == [2, 3, 4, 5] and spans.dropped() == 2
    assert [s.index for s in rec] == [2, 3, 4, 5]


def _tree(rec):
    by_index = {s.index: s for s in rec}
    for s in rec:
        if s.parent >= 0:
            p = by_index[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p, s)
    return by_index


def _leaf_events_match(rec, events, name):
    mine = [s for s in rec if s.name == name]
    ev = sorted((e for e in events if e[0] == name), key=lambda e: e[1])
    assert len(mine) == len(ev) >= 1
    for s, e in zip(mine, ev):
        assert abs(e[1] - s.start) <= 2_000_000, (s, e)
    return mine


def test_ml_predict_records_blocks_and_head(fresh):
    m = _ml_metric()
    rec, events = _profiled(_predict, m)
    by_index = _tree(rec)
    root, = [s for s in rec if s.name == "cvvdp.predict"]
    assert root.attrs == {"frames": F, "block_N": BLK}
    blocks = [s for s in rec if s.name == "cvvdp.block"]
    assert len(blocks) == 2 and all(s.parent == root.index for s in blocks)
    for name in ("cvvdp.ingest", "cvvdp.pyramid", "cvvdp.bands"):
        steps = [s for s in rec if s.name == name]
        assert len(steps) == 2 and {by_index[s.parent].name for s in steps} == {"cvvdp.block"}
    head = _leaf_events_match(rec, events, "cvvdp.ml.head")
    back = _leaf_events_match(rec, events, "cvvdp.readback")
    assert head[0].parent == back[0].parent == root.index and head[0].end <= back[0].start
    # Tokens: a class token and the tiles of every band, per frame.
    fs = int(np.ceil(m.pix_per_deg))
    tiles = sum(-(-h // fs) * -(-w // fs) for h, w in m.lpyr.pyr_shape)
    bands = m.lpyr.get_band_count()
    assert head[0].attrs == {"tokens": F * (tiles + bands), "bands": bands}


def test_heatmap_span_holds_the_maps_bytes(fresh):
    rec, events = _profiled(_predict, _heatmap_metric())
    by_index = _tree(rec)
    maps = _leaf_events_match(rec, events, "cvvdp.heatmap")
    assert len(maps) == 2 and {by_index[s.parent].name for s in maps} == {"cvvdp.block"}
    assert [s.attrs["bytes"] for s in maps] == [3 * BLK * H * W * 2, 3 * (F - BLK) * H * W * 2]
    assert not [s for s in rec if s.parent in {m.index for m in maps}]
