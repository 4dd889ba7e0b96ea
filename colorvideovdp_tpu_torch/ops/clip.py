"""Clipping with the JAX package's gradient at ties.

Where the argument equals a bound, ``jnp.clip``, ``jnp.maximum`` and
``jnp.minimum`` split the gradient evenly between the two sides (0.5 each),
while ``torch.clamp`` passes all of it to the argument. Display-encoded
images clipped to [0, 1] hold many exact 0s and 1s, so every clip on the
differentiable path goes through ``torch.maximum``/``torch.minimum``, which
split it as JAX does. The forward values are those of ``torch.clamp``.
"""

from __future__ import annotations

import torch


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``clamp(x, lo, hi)`` with JAX's tie gradient; ``None`` leaves a side open."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x
