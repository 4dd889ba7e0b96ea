"""Per-tile feature statistics for the ML metric heads.

Counterpart of ``colorvideovdp_tpu/ops/feature_pooling.py`` (plain torch; the
JAX package computes it in XLA, no Pallas kernel is involved): the mean and
variance (E[x^2] - m^2) of S|T|, S|R| and D over ~1-visual-degree tiles, as
torch's AvgPool2d with ``ceil_mode=True`` gives them: edge windows are clipped
to the input and divide by their number of valid samples.

The sums follow the JAX package's layout (zero-pad, reshape to
(..., oh, fs, ow, fs), sum over both window axes, divide by the count table)
rather than ``F.avg_pool2d``, whose other summation order the heads'
sqrt(|var|) would amplify where a tile's variance is near 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _avg_pool_ceil(x: torch.Tensor, fs: int) -> torch.Tensor:
    """Average pool over the last two axes, window and stride ``fs``,
    ceil_mode. x: (..., H, W) -> (..., ceil(H / fs), ceil(W / fs))."""
    H, W = x.shape[-2:]
    oh, ow = -(-H // fs), -(-W // fs)
    xp = F.pad(x, (0, ow * fs - W, 0, oh * fs - H))
    sums = xp.reshape(tuple(x.shape[:-2]) + (oh, fs, ow, fs)).sum(dim=(-3, -1))
    # Valid samples per output cell (edge windows are smaller).
    ch = np.minimum(np.arange(1, oh + 1) * fs, H) - np.arange(oh) * fs
    cw = np.minimum(np.arange(1, ow + 1) * fs, W) - np.arange(ow) * fs
    return sums / torch.as_tensor(np.outer(ch, cw).astype(np.float32), device=x.device)


def feature_pooling(T: torch.Tensor, R: torch.Tensor, D: torch.Tensor,
                    feature_size: int) -> torch.Tensor:
    """T, R, D: (B, C, F, H, W) -> features (B, F, h', w', C, 6) with the six
    statistics (mean_T, var_T, mean_R, var_R, mean_D, var_D)."""
    stats = []
    for x in (T, R, D):
        m = _avg_pool_ceil(x, feature_size)
        stats += [m, _avg_pool_ceil(x * x, feature_size) - m * m]
    # (B, C, F, h', w', 6) -> (B, F, h', w', C, 6)
    return torch.stack(stats, dim=-1).permute(0, 2, 3, 4, 1, 5)
