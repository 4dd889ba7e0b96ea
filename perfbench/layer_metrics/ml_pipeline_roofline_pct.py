"""ml_pipeline_roofline_pct (every ``ml_pipeline_roofline_pct.<suffix>``):
the least time the card needs for ColorVideoVDP-ML-Transformer on the
window's valid frames (``work/ml.py`` ``pipeline``: the raw frames read
once, the deltas written once, every operation of the reference's algorithm
once, the head at the configuration's widths, against the published H100
SXM peaks), as a share of the traced window's wall time. None outside a
configuration of that metric."""

from perfbench.work import ml


def read(ctx):
    cfg = ctx.cell.config
    if ctx.trace is None or not ctx.records or cfg.get("metric") != "cvvdp_ml_transformer":
        return None
    m = ml.Head(in_features=int(cfg["in_channels"]), dim=int(cfg["dim"]),
                depth=int(cfg["depth"]), heads=int(cfg["heads"]), mlp=int(cfg["mlp_dim"]))
    ops = byt = 0
    for r in ctx.records:
        o, b = ml.pipeline(ctx.traffic.shape(r["frames"]), m)
        ops, byt = ops + o, byt + b
    return 100.0 * ctx.work.least_seconds(ops, byt) / ctx.trace.window_s
