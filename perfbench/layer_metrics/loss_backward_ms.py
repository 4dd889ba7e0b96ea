"""loss_backward_ms (every ``loss_backward_ms.<suffix>``): the benchmark's
own span around ``loss.backward()`` in a traced step, from a synchronised
start to the synchronisation that ends it, averaged over the window's steps
(ms)."""


def read(ctx):
    t = [r["backward_s"] for r in ctx.records if "backward_s" in r]
    return 1e3 * sum(t) / len(t) if t else None
