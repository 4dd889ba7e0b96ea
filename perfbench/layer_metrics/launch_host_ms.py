"""launch_host_ms (every ``launch_host_ms.<suffix>``): the host time of
each block's device work, the ingest, the pyramid, the band loop and the
baseband (``cvvdp.ingest``, ``cvvdp.pyramid``, ``cvvdp.bands``,
``cvvdp.baseband`` spans), in ms per request (``cvvdp.predict``). The
kernels are asynchronous, so this is the cost of enqueueing them, and of any
wait for the device inside those steps."""

from perfbench import program_spans

STEPS = ("cvvdp.ingest", "cvvdp.pyramid", "cvvdp.bands", "cvvdp.baseband")


def read(ctx):
    return program_spans.ms_per_root(ctx, "cvvdp.predict", STEPS)
