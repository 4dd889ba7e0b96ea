"""Extract per-band features for cvvdp calibration (counterpart of the JAX
package's ``calibration/extract_features.py``).

For each CSV row (test, reference, jod[, display]) the full metric runs once
on the device and its ``Q_per_ch`` features are written to
``features[_suffix]/{train,test}/<id>_fmap.json``, the row's split decided by
its ``--split-column`` value. Supports CSV-header arguments (a header value
overrides the command line, as in the JAX script), k/N worker sharding and
``--resume``.

    python -m colorvideovdp_tpu_torch.calibration.extract_features dataset.csv \
        -d standard_fhd [-w k/N] [--resume] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import pandas as pd

import colorvideovdp_tpu_torch as cvt
from colorvideovdp_tpu_torch.io.video_source_file import video_source_file


def read_args_from_file(args, argv):
    """Append the ``key: value`` lines of the CSV's comment header to
    ``argv`` as flags, after the user's, so that a header value overrides
    the command line. Returns the number of header lines to skip."""
    if not os.path.isfile(args.quality_file):
        raise FileNotFoundError(f"Quality file not found at: {args.quality_file}")
    with open(args.quality_file) as f:
        lines = f.readlines()
    n = 0
    for line in lines:
        line = line.strip("\n ")
        if line == "" or line.startswith("#"):
            n += 1
            continue
        if ":" not in line:
            break
        col_pos = line.find(":")
        key = line[:col_pos].replace("-", "_")
        val = line[col_pos + 1 :].strip()
        if key in vars(args):
            if val.lower() == "true":
                argv.append(f"--{key.replace('_', '-')}")
            else:
                argv.extend([f"--{key.replace('_', '-')}", val])
            logging.info(f"Updating {key} to {val}")
        else:
            logging.warning(f"{key} not found in argparse namespace, skipping")
        n += 1
    return n


def train_conditions(quality_table, split_column, train_ratio, seed):
    """The values of ``split_column`` whose rows train: the first
    ``train_ratio`` percent of the unique values in the order of numpy's
    seeded permutation, as the JAX scripts draw it."""
    if split_column not in quality_table.columns:
        raise ValueError(f'Split column "{split_column}" not found')
    unique_cond = np.random.RandomState(seed).permutation(quality_table[split_column].unique())
    return unique_cond[: (len(unique_cond) * train_ratio) // 100]


def features_dir(suffix):
    return "features" if suffix is None else "features_" + suffix


def get_parser():
    parser = argparse.ArgumentParser("Extract features for cvvdp calibration")
    parser.add_argument("quality_file", help="Path to .csv file containing quality scores.")
    parser.add_argument("-p", "--path-prefix", default="",
                        help="Prefix for each test and reference file")
    parser.add_argument("-s", "--split-column", default="reference",
                        help="Column name for the train-test split.")
    parser.add_argument("-r", "--train-ratio", type=int, choices=range(100), default=80,
                        help="Percentage of data used for training.")
    parser.add_argument("--seed", type=int, default=0,
                        help="Random seed for reproducible splits.")
    parser.add_argument("-w", "--worker", default=None, type=str,
                        help="k/N worker sharding: this worker processes rows k-1, k-1+N, ...")
    parser.add_argument("-f", "--features-suffix", default=None,
                        help="suffix for the features directory name.")
    parser.add_argument("-c", "--config-paths", type=str, nargs="+", default=[])
    parser.add_argument("-d", "--display", default=None,
                        help="Display name, or 'per-row' to read a 'display' column.")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="Skip already-extracted conditions.")
    parser.add_argument("--full-screen-resize",
                        choices=["bilinear", "bicubic", "nearest", "area"], default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the metric: 'cuda' (the default) or 'cpu'")
    parser.add_argument("-v", "--verbose", action="store_true", default=False)
    return parser


def get_args(argv=None):
    """(args, quality table): the command line, then the CSV header's
    arguments appended after it."""
    parser = get_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    num_skip = read_args_from_file(args, argv)
    args = parser.parse_args(argv)
    quality_table = pd.read_csv(args.quality_file, skiprows=num_skip)

    level = logging.DEBUG if args.verbose else logging.INFO
    logging.basicConfig(format="[%(levelname)s] %(message)s", level=level)

    if args.display is None:
        parser.error("Please select a display name, or pass '--display per-row' with a "
                     "'display' column.")
    if args.display == "per-row" and "display" not in quality_table.columns:
        parser.error('Per-row display selected but cannot find column "display".')
    return args, quality_table


def main(argv=None):
    args, quality_table = get_args(argv)

    metric = cvt.cvvdp(
        quiet=True,
        display_name=args.display if args.display != "per-row" else "standard_4k",
        temp_padding="replicate",
        config_paths=args.config_paths,
        device=args.device,
    )

    rng_start, rng_step = 0, 1
    if args.worker is not None:
        k, n = args.worker.split("/", 1)
        rng_start, rng_step = int(k) - 1, int(n)
        logging.info(f"Worker {k} out of {n} workers.")

    train_cond = train_conditions(quality_table, args.split_column, args.train_ratio, args.seed)

    ft_path = features_dir(args.features_suffix)
    os.makedirs(os.path.join(ft_path, "train"), exist_ok=True)
    os.makedirs(os.path.join(ft_path, "test"), exist_ok=True)

    rows = range(rng_start, len(quality_table), rng_step)
    for i, kk in enumerate(rows):
        test, ref, cond = quality_table.loc[kk][["test", "reference", args.split_column]]
        cid = os.path.splitext(test)[0].replace("/", "_")
        split = "train" if cond in train_cond else "test"
        dest_name = os.path.join(ft_path, split, cid + "_fmap.json")
        if args.resume and os.path.isfile(dest_name):
            logging.info(f"Skipping condition {cid}")
            continue

        display = quality_table.loc[kk]["display"] if args.display == "per-row" else args.display
        disp_photo = cvt.vvdp_display_photometry.load(display, config_paths=args.config_paths)
        disp_geom = cvt.vvdp_display_geometry.load(display, config_paths=args.config_paths)
        metric.set_display_model(display_photometry=disp_photo, display_geometry=disp_geom)

        t0 = time.time()
        try:
            vs = video_source_file(
                os.path.join(args.path_prefix, test),
                os.path.join(args.path_prefix, ref),
                display_photometry=disp_photo,
                full_screen_resize=args.full_screen_resize,
                resize_resolution=disp_geom.resolution,
                verbose=args.verbose,
                config_paths=args.config_paths,
            )
            _, stats = metric.predict_video_source(vs)
        except Exception:
            logging.error(f"Failed on condition {cid}")
            raise

        metric.write_features_to_json(stats, dest_name)
        logging.info(f"[{i + 1}/{len(rows)}] {cid} ({split}, {display}): "
                     f"{time.time() - t0:.3f} s")


if __name__ == "__main__":
    main()
