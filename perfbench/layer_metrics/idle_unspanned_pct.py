"""idle_unspanned_pct (every ``idle_unspanned_pct.<suffix>``): the share of
the device's idle time in the traced window (the window outside
``trace.busy_intervals``) that no span of the port covers, on any thread.
The request roots (``program_spans.ROOTS``) are left out: a root covers its
whole request, and would hide the unnamed host work between its steps.
Without device operations (a run on the CPU) the whole window is idle."""

from perfbench import program_spans, trace


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys):
    """The total length shared by two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    sp = program_spans.window(ctx)
    if sp is None:
        return None
    tr = ctx.trace
    edges = [tr.t0] + [x for ab in trace.busy_intervals(tr) for x in ab] + [tr.t1]
    idle = [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    covered = _merge((max(s.start, tr.t0), min(s.end, tr.t1)) for s in sp
                     if s.name not in program_spans.ROOTS)
    return 100.0 * (total - _overlap(idle, covered)) / total
