"""heatmap_ms (every ``heatmap_ms.<suffix>``): the heatmap's colour map and
its float16 copy to the host (``cvvdp.heatmap`` spans, ``metrics/cvvdp.py``
``_heatmap_frames``), in ms per request (``cvvdp.predict``). The copy waits
for the device to finish the block's queued work, the D bands and the
reconstruct included, so the span is the map's wall time on the host.
None where no such span opens."""

from perfbench import program_spans

SPAN = "cvvdp.heatmap"


def read(ctx):
    sp = program_spans.window(ctx)
    if sp is None or not any(s.name == SPAN for s in sp):
        return None
    return program_spans.ms_per_root(ctx, "cvvdp.predict", (SPAN,))
