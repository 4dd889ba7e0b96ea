"""The cost of one ``utils.spans`` span on the host, off and on.

    python -m colorvideovdp_tpu_torch.tools.span_cost [--n 200000]

Prints one JSON line of nanoseconds a span: ``off`` (the profiler not
running: the shared no-op), ``leaf_on`` and ``enclosing_on`` (under
``torch.profiler`` with CPU activity: a leaf opens a ``record_function``
too), each the least of five timed loops of ``--n`` spans (``--n`` / 10
under the profiler), and ``empty``, the loop alone, which the others
include.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..utils import spans


def _per_span_ns(name: str, n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter_ns()
        for _ in range(n):
            with spans.span(name):
                pass
        best = min(best, (time.perf_counter_ns() - t) / n)
    return best


def _empty_ns(n: int) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        best = min(best, (time.perf_counter_ns() - t) / n)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    n = ap.parse_args(argv).n
    out = {"torch": torch.__version__, "empty": _empty_ns(n),
           "off": _per_span_ns("cvvdp.read", n)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["leaf_on"] = _per_span_ns("cvvdp.read", max(n // 10, 1))
        out["enclosing_on"] = _per_span_ns("cvvdp.block", max(n // 10, 1))
    spans.clear()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
