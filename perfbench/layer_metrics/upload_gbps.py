"""upload_gbps (every ``upload_gbps.<suffix>``): the port's host-to-device
uploads (``cvvdp.upload`` spans, ``io/video_source.py`` ``upload``): the
sum of their ``bytes`` over the sum of their durations, in GB/s."""

from perfbench import program_spans


def read(ctx):
    sp = program_spans.window(ctx)
    ups = [s for s in sp or () if s.name == "cvvdp.upload"]
    ns = sum(s.end - s.start for s in ups)
    if ns <= 0:
        return None
    return sum(s.attrs["bytes"] for s in ups) / ns
