"""The port's own spans in a traced window, for the per-layer metrics that
read them.

The port records its steps (``colorvideovdp_tpu_torch/utils/spans.py``)
only while ``torch.profiler`` runs, so only in a ``--trace 1`` window. Each
span has a ``name``, ``start`` and ``end`` in ``time.time_ns()``
nanoseconds (the profile's clock), a thread, a parent, a request and
``attrs``. A request's root is ``cvvdp.predict`` (scoring) or
``cvvdp.loss.forward`` (a training step). A program without the facility
(an earlier commit) or the control records none, and the readers then read
None.
"""

from __future__ import annotations

import sys

MODULE = "colorvideovdp_tpu_torch.utils.spans"
ROOTS = ("cvvdp.predict", "cvvdp.loss.forward")


def window(ctx):
    """The program's closed spans that start inside the traced window, or
    None where there are none."""
    mod = sys.modules.get(MODULE)
    if ctx.trace is None or mod is None:
        return None
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    out = [s for s in mod.recorded() if s.end is not None and t0 <= s.start <= t1]
    return out or None


def ms_per_root(ctx, root, names):
    """The time of the spans named in ``names`` (ms) over the window's
    ``root`` spans; None without spans or roots."""
    sp = window(ctx)
    if sp is None:
        return None
    n = sum(1 for s in sp if s.name == root)
    if not n:
        return None
    return sum(s.end - s.start for s in sp if s.name in names) / 1e6 / n
