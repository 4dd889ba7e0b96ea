"""The per-layer metrics that read the port's own spans
(``perfbench/program_spans.py``), on the shrunk cells on the CPU: each reads
a finite number in every cell it lists when the port is measured, and None
when the control (the reference, which records no span) is."""

from __future__ import annotations

import json
import math
import os
import time

import pytest

from perfbench import harness

CELLS = ["hdr4k-fchw", "hdr4k-fhwc", "fhd-images", "fhd-loss-b4"]
READERS = ("relayout_ms", "upload_gbps", "prefetch_wait_ms", "launch_host_ms",
           "recompute_ms", "idle_unspanned_pct")


def _span_metrics(root, cell):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        per_layer = json.load(f)["per_layer"]
    return [m["name"] for m in per_layer
            if m["name"].split(".")[0] in READERS and cell in m.get("workloads", [])]


def test_every_reader_is_listed():
    from perfbench.tests.conftest import ROOT

    listed = {n.split(".")[0] for c in CELLS for n in _span_metrics(ROOT, c)}
    assert listed == set(READERS)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("program", ["port", "control"])
def test_span_readers(tiny_root, cell, program):
    c = harness.load_cell(cell, tiny_root)
    names = _span_metrics(tiny_root, cell)
    assert names
    res = harness.run_cell(c, 2 ** 31 + 7, 0.5, True, "cpu", time.perf_counter(),
                           program=program)
    for name in names:
        if program == "port":
            v = res["metrics"][name]["value"]
            assert math.isfinite(v) and v >= 0, (name, v)
        else:
            assert name not in res["metrics"], name
