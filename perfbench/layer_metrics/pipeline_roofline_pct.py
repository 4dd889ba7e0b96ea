"""pipeline_roofline_pct (every ``pipeline_roofline_pct.<suffix>``): the
least time the card needs for the whole algorithm on the window's valid
frames (``work.pipeline``: the raw frames read once, Q_per_ch written once,
every operation of the reference's algorithm once, against the published
H100 SXM peaks), as a share of the traced window's wall time."""


def read(ctx):
    if ctx.trace is None or not ctx.records:
        return None
    ops = byt = 0
    for r in ctx.records:
        o, b = ctx.work.pipeline(ctx.traffic.shape(r["frames"]))
        ops, byt = ops + o, byt + b
    return 100.0 * ctx.work.least_seconds(ops, byt) / ctx.trace.window_s
