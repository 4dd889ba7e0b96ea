"""device_idle_pct (every ``device_idle_pct.<suffix>``): the share of the
traced window in which the card ran no kernel and no copy, 100 (1 - busy /
window), busy being the union of the device operations' intervals
(``trace.busy_s``)."""

from perfbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace.window_s)
