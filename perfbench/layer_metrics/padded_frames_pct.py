"""padded_frames_pct (every ``padded_frames_pct.<suffix>``): frames the
block loop computes beyond those asked for, 100 (computed / valid - 1) over
the window's requests; a clip of N frames in blocks of blk computes ceil(N /
blk) blk (blk is ``stats["block_N_frames"]``). None for requests of one
frame."""


def read(ctx):
    recs = [r for r in ctx.records if r.get("frames", 1) > 1]
    if not recs:
        return None
    return 100.0 * (sum(r["computed"] for r in recs) / sum(r["frames"] for r in recs) - 1.0)
