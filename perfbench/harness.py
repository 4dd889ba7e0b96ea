"""The benchmark's harness: finds a cell by name, runs it once, reports.

Everything particular to a cell lives in files the harness finds by name:

* ``BENCHMARK.json`` (the checkout's root): the cells (``workloads``), with
  each one's configuration and traffic mix, and the metrics;
* ``perfbench/configs/<config>.json``: a deployment (display, resolution,
  source, precision);
* ``perfbench/traffic/<traffic>.json``: a traffic mix, the parameters one
  generator of its ``kind`` reads, with the limits of its comparison;
* ``perfbench/traffic/<kind>.py``: the generator of a kind, a ``Traffic``
  class (set-up, one request, the end-to-end metrics, the comparison);
* ``perfbench/layer_metrics/<metric>.py``: the reader of one per-layer
  metric, ``read(ctx)`` -> a number, or None where it finds nothing; a
  metric without its own file is read by its family's, ``<family>.py``,
  the family being the part of its name before the first dot;
* ``perfbench/stages/<stage>/*.json``: name patterns of the device
  operations of one stage of the pipeline.

A run: set-up (content, the program, warm-up), then requests one after the
other until ``seconds`` have passed (a request is never cut), then the
comparison of what the window produced with the plain reference. With
``trace`` the window runs under ``torch.profiler`` and the result holds the
per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from types import SimpleNamespace

import torch

from . import trace as tr
from . import work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names the measured process may not hold: the JAX package
# and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "colorvideovdp_tpu")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: list  # the BENCHMARK.json metric entries this cell reports
    per_layer: list
    chips: int
    root: str = ROOT
    stages: dict = field(default_factory=dict)

    def traffic_class(self):
        kind = self.mix["kind"]
        return _module(os.path.join(self.root, "perfbench", "traffic", f"{kind}.py"),
                       f"perfbench_traffic_{kind}").Traffic


def _applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    base = os.path.join(root, "perfbench")
    stages = {}
    for path in sorted(glob.glob(os.path.join(base, "stages", "*", "*.json"))):
        stage = os.path.basename(os.path.dirname(path))
        stages.setdefault(stage, []).extend(_load_json(path)["patterns"])
    return Cell(name=name,
                config=_load_json(os.path.join(base, "configs", f"{spec['config']}.json")),
                mix=_load_json(os.path.join(base, "traffic", f"{spec['traffic']}.json")),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                chips=int(spec["chips"]), root=root, stages=stages)


def reader_path(root: str, metric: str) -> str:
    """The reader of ``metric``: ``layer_metrics/<metric>.py``, or where the
    metric has none of its own, the one of its family, named by the part
    before the first dot (``device_idle_pct.train`` -> ``device_idle_pct.py``)."""
    base = os.path.join(root, "perfbench", "layer_metrics")
    own = os.path.join(base, f"{metric}.py")
    return own if os.path.isfile(own) else os.path.join(base, metric.split(".")[0] + ".py")


def layer_reader(cell: Cell, metric: str):
    return _module(reader_path(cell.root, metric),
                   "perfbench_layer_" + metric.replace(".", "_")).read


class Device:
    """The device a run measures: the card, or the CPU where a test drives
    the harness without one (no number is then a device's)."""

    def __init__(self, device):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.dev)) if self.cuda else 0

    def describe(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(self.dev), "count": 1}
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                  "--format=csv,noheader", "-i", str(self.dev.index or 0)],
                                 capture_output=True, text=True, timeout=30)
            info["power_limit"] = smi.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            info["power_limit"] = "not read"
        return info


def forbidden_modules():
    """The forbidden top-level modules this process holds."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _profiler(device: Device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.cuda else [])
    return profile(activities=acts, record_shapes=False, profile_memory=False,
                   with_stack=False)


def run_window(traffic, seconds: float, device: Device, trace: bool):
    """Requests until ``seconds`` have passed; returns (records, window s,
    failed count, trace or None)."""
    from torch.profiler import record_function

    prof = _profiler(device) if trace else None
    records, failed = [], 0
    device.sync()
    device.reset_peak()
    with prof if prof is not None else nullcontext():
        t0 = time.perf_counter()
        i = 0
        while True:
            with record_function(tr.REQUEST_SPAN):
                try:
                    records.append(traffic.request(i, trace))
                except Exception:  # a failed request counts; the run goes on
                    traceback.print_exc(file=sys.stderr)
                    failed += 1
            i += 1
            if time.perf_counter() - t0 >= seconds or failed > 10:
                break
        device.sync()
        window = time.perf_counter() - t0
    return records, window, failed, (tr.read(prof) if prof is not None else None)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             program=None) -> dict:
    """One run of ``cell``: the result object and the compared numbers.
    ``program`` replaces the measured program (the control)."""
    device = Device(device)
    traffic = cell.traffic_class()(cell, seed, device.dev, program)
    traffic.setup()
    device.sync()
    setup_s = time.perf_counter() - t_start
    records, window, failed, trc = run_window(traffic, seconds, device, trace)
    peak = device.peak_bytes()
    ctx = SimpleNamespace(cell=cell, traffic=traffic, records=records, trace=trc, work=work)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = layer_reader(cell, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = traffic.end_to_end(records, window, peak)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
            else:
                raise KeyError(f"cell {cell.name} does not report {m['name']}")
    dev = device.describe()
    dev["memory_peak_bytes"] = peak
    result = {"attempted": len(records) + failed, "failed": failed, "metrics": metrics,
              "device": dev}
    if trc is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(trc), trc.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(trc),
                               "idle_gaps": tr.idle_gaps(trc)}
        # Device seconds by stage (``stages/``), "other" for the rest.
        result["stages"] = tr.stage_seconds(trc, cell.stages)
    traffic.release()
    if device.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = traffic.check(records)
    print(f"perfbench: the comparison with the reference took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    ok = failed == 0 and bool(records) and all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": ok, **result, "checks": checks}
    return result
