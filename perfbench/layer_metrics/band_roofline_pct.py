"""band_roofline_pct (every ``band_roofline_pct.<suffix>``): the band
stage's least time (``work.bands``: each band's level G_i and the next level
G_i+1 read once and its operations, the larger of the two bounds per band,
summed over the frames the block loop computed) as a share of the device
time of the operations ``stages/band/*.json`` attributes to the band stage.
None where no operation matched."""

from perfbench import trace


def read(ctx):
    if ctx.trace is None or not ctx.records:
        return None
    device_s = trace.stage_seconds(ctx.trace, ctx.cell.stages).get("band", 0.0)
    if device_s <= 0:
        return None
    least = sum(ctx.work.least_seconds(o, b)
                for r in ctx.records for o, b in ctx.work.bands(ctx.traffic.shape(r["computed"])))
    return 100.0 * least / device_s
