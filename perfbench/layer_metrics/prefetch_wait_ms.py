"""prefetch_wait_ms (every ``prefetch_wait_ms.<suffix>``): the time the
block loop's main thread waits for the worker's read of the next block
(``cvvdp.prefetch_wait`` spans) in ms per request (``cvvdp.predict``); 0
where no request's clip spans more than one block."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_root(ctx, "cvvdp.predict", ("cvvdp.prefetch_wait",))
