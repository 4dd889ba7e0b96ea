"""Feature-map dataset for calibration (counterpart of the JAX package's
``calibration/data.py``, kept as a copy of its own).

Loads the per-band JSON feature maps written by ``extract_features``, with
optional resampling of the bands to the fixed rho grid [2^6 ... 2^-1] plus
the baseband. Samples are numpy arrays; the trainer moves them to its
device.
"""

from __future__ import annotations

import json
import logging
import os.path as osp
import re

import numpy as np
from scipy.interpolate import interp1d


class VideoDataset:
    log_rho_min = -1
    log_rho_max = 6

    def __init__(self, feature_dir, quality_table, split, resample):
        logging.info(f'Loading dataset "{self.__class__.__name__}"')
        self.feature_dir = feature_dir
        if not osp.isdir(self.feature_dir):
            raise FileNotFoundError(f"Extracted features not found at: {self.feature_dir}")
        self.quality_table = quality_table
        self.split = split
        self.resample = resample
        self._cache = {}

    def __getitem__(self, index):
        """Returns (qpc [B, C, F, bands] float32, base_rho_band, jod)."""
        row = self.quality_table.iloc[index]
        test_fname, quality = row[["test", "jod"]]
        cid = osp.splitext(test_fname)[0].replace("/", "_")
        if cid in self._cache:
            qpc, base_rho = self._cache[cid]
            return qpc, base_rho, quality

        feat_fname = osp.join(self.feature_dir, self.split, f"{cid}_fmap.json")
        if not osp.isfile(feat_fname):
            raise FileNotFoundError(f'Features missing for "{test_fname}": {feat_fname}')
        with open(feat_fname) as f:
            features = json.load(f)

        f_keys = {k for k in features if re.match(r"t\d+_b\d+", k)}
        bands = len({k.split("_")[1].lstrip("b") for k in f_keys})
        channels = len({k.split("_")[0].lstrip("t") for k in f_keys})
        batches = len(features["t0_b0"])
        frames = len(features["t0_b0"][0])

        # A top band under 2^6 cpd: the grid's first point is extrapolated
        # from a zero there.
        extrapolate = False
        if max(features["rho_band"]) < 2**self.log_rho_max:
            features["rho_band"].insert(0, 2**self.log_rho_max)
            extrapolate = True
        rho_band = np.asarray(features["rho_band"])

        qpc = np.empty((batches, channels, frames, bands), np.float32)
        for b in range(batches):
            for bb in range(bands):
                for cc in range(channels):
                    qpc[b, cc, :, bb] = np.asarray(features[f"t{cc}_b{bb}"][b])

        if self.resample:
            n_res = self.log_rho_max - self.log_rho_min + 2
            res = np.empty((batches, channels, frames, n_res), np.float32)
            grid = 2.0 ** np.linspace(self.log_rho_max, self.log_rho_min, n_res - 1)
            for b in range(batches):
                for cc in range(channels):
                    for tt in range(frames):
                        y = qpc[b, cc, tt]
                        lut = interp1d(rho_band, np.insert(y, 0, 0) if extrapolate else y)
                        res[b, cc, tt] = np.append(lut(grid), y[-1])
            qpc = res

        base_rho = np.float32(rho_band[-1])
        self._cache[cid] = (qpc, base_rho)
        return qpc, base_rho, quality

    def __len__(self):
        return len(self.quality_table)

    def iter_batches(self, batch_size, shuffle=False, seed=0):
        """Yield lists of samples (variable frame counts prevent stacking)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            yield [self[j] for j in idx]
