"""castleCSF contrast sensitivity via log-log LUTs.

Counterpart of ``colorvideovdp_tpu/ops/csf.py``: the spatial-frequency
interpolation depends only on the static per-band frequencies, so it is
folded on the host into one row over background luminance per (band,
channel); the per-pixel lookup is the ``csf_lut`` kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import config_files, json2dict
from .interp import np_batch_interp1d
from .kernels.csf_lut import CsfLut


class CastleCSF:
    """CSF S(rho, omega, L_bkg, channel) from JSON LUTs.

    Channels: 0=achromatic sustained, 1=red-green, 2=yellow-violet (all at
    omega=0) and the achromatic transient channel at omega=5 Hz.
    """

    def __init__(self, csf_version: str, config_paths=None):
        lut = json2dict(config_files.find(f"csf_lut_{csf_version}.json", config_paths or []))
        self.log_L_bkg = np.log10(np.asarray(lut["L_bkg"], np.float32))
        self.log_rho = np.log10(np.asarray(lut["rho"], np.float32))
        self.omega = lut["omega"]  # [0, 5]
        self.logS = [
            [np.asarray(lut[f"o{self.omega[0]}_c{cc + 1}"], np.float32) for cc in range(3)],
            [np.asarray(lut[f"o{self.omega[1]}_c1"], np.float32)],
        ]
        self._rho_cache: dict[str, np.ndarray] = {}
        self._table_cache: dict[tuple, torch.Tensor] = {}

    def logS_of_logL(self, rho: float, omega: float, cc: int) -> np.ndarray:
        """log10-sensitivity sampled over the LUT's L_bkg grid for one
        (rho, omega, channel)."""
        oo = 0 if omega == 0 else 1
        key = f"o{oo}_c{cc}_rho{rho}"
        if key not in self._rho_cache:
            n = self.log_L_bkg.shape[0]
            q = np.full((n,), np.log10(np.float32(rho)), np.float32)
            self._rho_cache[key] = np_batch_interp1d(q, self.log_rho, self.logS[oo][cc])
        return self._rho_cache[key]

    def lut_range(self):
        return float(self.log_L_bkg[0]), float(self.log_L_bkg[-1])

    def sensitivity_multi_channel(self, rho_per_ch, omega_per_ch, logL_bkg: torch.Tensor,
                                  channels, use_kernel: bool = True) -> torch.Tensor:
        """Sensitivities for several channels sharing one ``logL_bkg`` field,
        differentiable in it (``CsfLut``). Returns (n_ch, *logL_bkg.shape).
        The (n_ch, nk) table is uploaded once per (rho, omega, channel) rows
        and device: a copy from pageable memory would wait for the stream.
        This cache serves the callers that take one band at a time (the
        generic masking chain, the ML trunk); the band kernels take every
        interior band's rows in one (bands, C, nk) tensor, which
        ``metrics/cvvdp.py`` ``_band_tables`` stacks and keeps itself."""
        key = (tuple(rho_per_ch), tuple(omega_per_ch), tuple(channels), logL_bkg.device)
        luts_t = self._table_cache.get(key)
        if luts_t is None:
            luts = np.stack([self.logS_of_logL(rho, om, cc)
                             for rho, om, cc in zip(rho_per_ch, omega_per_ch, channels)])
            luts_t = self._table_cache[key] = torch.as_tensor(luts, device=logL_bkg.device)
        return CsfLut.apply(logL_bkg, luts_t, *self.lut_range(), use_kernel)
