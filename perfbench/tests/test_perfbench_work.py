"""The work counts at the cells' shapes, and their independence of how the
pipeline is split into stages."""

from __future__ import annotations

import pytest

from perfbench import work
from perfbench.reference.cvvdp_ref import Display


def _clip(F=32):
    return work.Shape(B=1, F=F, H=2160, W=3840, channels=4, fl=9, sample_bytes=2, eotf="PQ",
                      ppd=Display("standard_hdr_pq").ppd)


def _image(B=1):
    return work.Shape(B=B, F=1, H=1080, W=1920, channels=3, fl=0, sample_bytes=1, eotf="sRGB",
                      ppd=Display("standard_fhd").ppd)


def test_levels_of_the_cells():
    assert work.levels(_clip()) == [(2160, 3840), (1080, 1920), (540, 960), (270, 480),
                                    (135, 240), (68, 120), (34, 60), (17, 30), (9, 15)]
    assert work.levels(_image()) == [(1080, 1920), (540, 960), (270, 480), (135, 240),
                                     (68, 120), (34, 60), (17, 30), (9, 15)]


@pytest.mark.parametrize("shape, ops, byt", [
    (_clip(), 244179221184, 3185054208),  # a 32-frame 4K HDR clip
    (_image(), 1232917728, 12441696),     # an FHD sRGB image
])
def test_pipeline_counts_pinned(shape, ops, byt):
    assert work.pipeline(shape) == (ops, byt)


def test_band_stage_pinned():
    s = _clip(F=27)
    ops, byt = work.band(s)
    assert (ops, byt) == (132570496800, 11943342864)
    # Band 0 holds most of it; at the published peaks it is bound by its
    # bytes (40 a pixel against about 370 operations).
    o0, b0 = work.bands(s)[0]
    assert b0 / work.PEAK_BYTES > o0 / work.PEAK_FLOPS
    assert o0 > 0.7 * ops


def test_counts_scale_with_frames_and_batch():
    assert work.pipeline(_clip(F=64))[0] == 2 * work.pipeline(_clip(F=32))[0]
    assert work.pipeline(_image(B=4)) == tuple(4 * x for x in work.pipeline(_image()))


def test_pipeline_independent_of_the_stage_split(monkeypatch):
    """Merging stages or splitting the band stage band by band moves no
    count of the whole pipeline."""
    for s in (_clip(), _image()):
        before = work.pipeline(s)
        split = {k: v for k, v in work.STAGES.items() if k != "band"}
        for b in range(len(work.levels(s)) - 2):
            split[f"band{b}"] = (lambda b: lambda sh: work.bands(sh)[b])(b)
        monkeypatch.setattr(work, "STAGES", split)
        assert work.pipeline(s) == before
        merged = {"all": lambda sh: tuple(map(sum, zip(*[fn(sh) for fn in split.values()])))}
        monkeypatch.setattr(work, "STAGES", merged)
        assert work.pipeline(s) == before
        monkeypatch.undo()


def test_least_time_is_the_larger_bound():
    assert work.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    ops, byt = work.pipeline(_clip())
    assert work.least_seconds(ops, byt) == pytest.approx(ops / 67e12)
