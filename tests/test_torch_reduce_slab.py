"""The slab mode of the port's reduce against the JAX package's
``reduce_slab_tpu`` (interpret mode on the CPU), on seeded numpy inputs.

``reduce_slab_plain`` is what ``pyramid_reduce_slab`` runs on CPU tensors;
the slab kernel is held to it bit for bit on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from colorvideovdp_tpu.ops.kernels.pyramid_reduce import reduce_slab_tpu  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels.pyramid_reduce import pyramid_reduce_slab  # noqa: E402


# (P, H_loc, W, rows_odd): W a multiple of 256, unaligned and odd; H_loc 64
# and 96 give the JAX kernel two row tiles (th 24 and 40).
@pytest.mark.parametrize("P,H_loc,W,rows_odd", [
    (2, 64, 512, False), (1, 64, 512, True), (2, 96, 300, False), (1, 96, 301, True),
    (3, 64, 301, False),
])
def test_reduce_slab_matches_reduce_slab_tpu(P, H_loc, W, rows_odd):
    x = np.random.RandomState(H_loc + W).rand(P, H_loc + 16, W).astype(np.float32)
    y_j = np.asarray(reduce_slab_tpu(jnp.asarray(x), H_loc, W, rows_odd, interpret=True))
    y_t = pyramid_reduce_slab(torch.from_numpy(x), rows_odd).numpy()
    assert y_t.shape == y_j.shape == (P, H_loc // 2, (W + 1) // 2)
    # Both sum the same products; XLA may contract or reorder a few of them.
    assert np.abs(y_t - y_j).max() <= 1e-6


@pytest.mark.parametrize("W", [512, 301])
def test_reduce_slab_with_edge_fixes_is_the_whole_reduce(W):
    """One slab with zero halos plus the vertical edge fixes, added after
    the horizontal pass as the sharded reduce adds them, is the whole
    level's reduce to float rounding (the JAX package's bound, 1e-5)."""
    H = 96
    x = torch.from_numpy(np.random.RandomState(W).rand(2, 3, H, W).astype(np.float32))
    z = torch.zeros(2, 3, 8, W)
    y = pyr.reduce_slab_plain(torch.cat([z, x, z], dim=-2), rows_odd=False)
    k = [float(v) for v in pyr.K5]

    def hrow(row):
        return pyr._reduce_1d(row.unsqueeze(-2), -1, odd_correction=False).squeeze(-2)

    y[..., 0, :] += hrow(x[..., 0, :] * k[1] + x[..., 1, :] * k[0])
    y[..., -1, :] += hrow(x[..., -1, :] * k[4])
    assert float((y - pyr.reduce_plain(x)).abs().max()) <= 1e-5


def test_reduce_slab_rejects_odd_slab():
    with pytest.raises(ValueError):
        pyramid_reduce_slab(torch.zeros(1, 16 + 7, 64), False)
