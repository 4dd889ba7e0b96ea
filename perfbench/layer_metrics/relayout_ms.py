"""relayout_ms (every ``relayout_ms.<suffix>``): the port's host relayout
of each side's array to frame-major order (``cvvdp.relayout`` spans,
``io/video_source.py`` ``_bfchw``) in ms per request (``cvvdp.predict``)."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_root(ctx, "cvvdp.predict", ("cvvdp.relayout",))
