"""The traced window, read from ``torch.profiler``'s events.

``read`` takes a finished profile and keeps three kinds of events, each as
(name, start ns, end ns): the device's operations (kernels, copies and
sets, not the profiler's own annotation ranges), the benchmark's own spans
(``record_function`` ranges whose names start with ``perfbench.``), and the
host operations of the thread that issued the requests, outermost only.
The window runs from the first request span's start to the last one's end.

The device is busy over the union of its operations' intervals (copies and
kernels may overlap); an idle gap is a stretch of the window outside that
union, labelled by what the host was doing at its middle: the innermost
benchmark span and the outermost host operation there ("python" where the
interpreter ran no operation).
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

SPAN_PREFIX = "perfbench."
REQUEST_SPAN = "perfbench.request"


@dataclass
class Trace:
    t0: int
    t1: int
    device: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    ops: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9


def _kineto_events(prof):
    """(name, device?, user annotation?, thread, start ns, end ns) of every
    event of the profile."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), e.device_type() == DeviceType.CUDA, e.is_user_annotation(),
               e.start_thread_id(), start, start + e.duration_ns())


def _outermost(events):
    """The events no other one of the list contains (one thread's ranges nest)."""
    out, end = [], -1
    for ev in sorted(events, key=lambda e: (e[1], -e[2])):
        if ev[1] >= end:
            out.append(ev)
            end = ev[2]
    return out


def read(prof) -> Trace:
    device, spans, host = [], [], []
    for name, on_device, user, thread, start, end in _kineto_events(prof):
        if on_device:
            if not user:
                device.append((name, start, end))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, start, end, thread))
        else:
            host.append((name, start, end, thread))
    requests = [s for s in spans if s[0] == REQUEST_SPAN]
    if not requests:
        raise RuntimeError("the trace holds no request span")
    t0, t1 = min(s[1] for s in requests), max(s[2] for s in requests)
    main = requests[0][3]
    device = [(n, max(a, t0), min(b, t1)) for n, a, b in device if b > t0 and a < t1]
    return Trace(t0=t0, t1=t1, device=sorted(device, key=lambda e: e[1]),
                 spans=sorted([(n, a, b) for n, a, b, th in spans if th == main],
                              key=lambda e: e[1]),
                 ops=_outermost([(n, a, b) for n, a, b, th in host if th == main]))


def busy_intervals(tr: Trace):
    """The union of the device's intervals, merged, in order."""
    merged = []
    for _, a, b in tr.device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e9


def _at(events, points):
    """For each time in ``points``, the index of the event of ``events``
    (sorted by start) with the latest start that contains it, or -1."""
    if not events:
        return np.full(len(points), -1)
    starts = np.array([e[1] for e in events], np.int64)
    ends = np.array([e[2] for e in events], np.int64)
    idx = np.searchsorted(starts, points, side="right") - 1
    found = np.full(len(points), -1)
    # Spans nest a few deep: walk back from the latest start.
    for k in range(8):
        c = idx - k
        ok = (found < 0) & (c >= 0)
        cc = np.where(c >= 0, c, 0)
        hit = ok & (ends[cc] >= points) & (starts[cc] <= points)
        found = np.where(hit, cc, found)
    return found


def idle_gaps(tr: Trace, top: int = 10):
    """[[label, seconds]] of the window's idle time by what the host was
    doing, the largest ``top`` first."""
    busy = busy_intervals(tr)
    edges = [tr.t0] + [x for ab in busy for x in ab] + [tr.t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    if not gaps:
        return []
    mids = np.array([(a + b) // 2 for a, b in gaps], np.int64)
    si, oi = _at(tr.spans, mids), _at(tr.ops, mids)
    total = defaultdict(int)
    for (a, b), s, o in zip(gaps, si, oi):
        label = (tr.spans[s][0] if s >= 0 else "outside spans") + " / " + (
            tr.ops[o][0] if o >= 0 else "python")
        total[label] += b - a
    return [[k, v / 1e9] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(tr: Trace, top: int = 10, width: int = 160):
    """[[name, seconds]] of the device operations that took most time, each
    name cut to its first ``width`` characters."""
    total = defaultdict(int)
    for n, a, b in tr.device:
        total[n] += b - a
    return [[k.removeprefix("void ")[:width], v / 1e9]
            for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def stage_seconds(tr: Trace, stages: dict) -> dict:
    """{stage: device seconds} of the operations whose names match one of the
    stage's patterns (regular expressions, searched), the first stage in
    name order that matches taking an operation; the rest under "other"."""
    pats = [(name, [re.compile(p) for p in pats]) for name, pats in sorted(stages.items())]
    out = defaultdict(float)
    for n, a, b in tr.device:
        stage = next((s for s, ps in pats if any(p.search(n) for p in ps)), "other")
        out[stage] += (b - a) / 1e9
    return dict(out)
