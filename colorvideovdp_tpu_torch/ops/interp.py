"""Host-side LUT interpolation (counterpart of ``colorvideovdp_tpu/ops/interp.py:14``)."""

from __future__ import annotations

import numpy as np


def np_batch_interp1d(x, xp, fp):
    """Row-wise linear interpolation with linear extrapolation, numpy/fp32.

    ``fp`` is (rows, len(xp)); ``x`` is (rows,). The segment index is clamped
    to [0, len(xp)-2] and the ends extrapolate linearly.
    """
    x = np.asarray(x, np.float32)
    xp = np.asarray(xp, np.float32)
    fp = np.asarray(fp, np.float32)
    idx = np.clip(np.searchsorted(xp, x) - 1, 0, len(xp) - 2)
    x0, x1 = xp[idx], xp[idx + 1]
    y0 = fp[np.arange(fp.shape[0]), idx]
    y1 = fp[np.arange(fp.shape[0]), idx + 1]
    slope = (y1 - y0) / (x1 - x0)
    return y0 + slope * (x - x0)
