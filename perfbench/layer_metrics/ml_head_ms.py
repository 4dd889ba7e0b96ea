"""ml_head_ms (every ``ml_head_ms.<suffix>``): the host time of the ML
metrics' head, the regression from the tile statistics to each band's delta
and the JOD (``cvvdp.ml.head`` spans, ``metrics/ml.py``), in ms per request
(``cvvdp.predict``). Its launches are asynchronous, so this is the cost of
enqueueing them and of any wait for the device inside. None where no such
span opens."""

from perfbench import program_spans

SPAN = "cvvdp.ml.head"


def read(ctx):
    sp = program_spans.window(ctx)
    if sp is None or not any(s.name == SPAN for s in sp):
        return None
    return program_spans.ms_per_root(ctx, "cvvdp.predict", (SPAN,))
