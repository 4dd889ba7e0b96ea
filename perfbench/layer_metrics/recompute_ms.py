"""recompute_ms (every ``recompute_ms.<suffix>``): the checkpoint's
recompute of the loss's block inside its backward (``cvvdp.loss.recompute``
spans) in ms per step (``cvvdp.loss.forward``), on the host's clock."""

from perfbench import program_spans


def read(ctx):
    return program_spans.ms_per_root(ctx, "cvvdp.loss.forward", ("cvvdp.loss.recompute",))
