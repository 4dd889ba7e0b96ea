"""Re-fit a subset of cvvdp's scalar parameters against subjective JOD labels
(counterpart of the JAX package's ``calibration/train.py``).

Only the pooling stage runs during training, over the features that
``extract_features`` cached: the trainable parameters [ch_chrom_w,
ch_trans_w, baseband_weight, jod_a, jod_exp] are fitted with
``torch.optim.Adam`` (whose defaults are ``optax.adam``'s) on the MSE,
validated with RMSE/PLCC/SRCC, and written back to a
``cvvdp_parameters.json`` through the metric's ``save_to_config``. The
pooling is plain tensor code; it launches no kernel of the port.

    python -m colorvideovdp_tpu_torch.calibration.train dataset.csv \
        -e 50 --save best-rmse [-o new_config] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import pandas as pd
import torch
from scipy import stats as sstats

import colorvideovdp_tpu_torch as cvt
from colorvideovdp_tpu_torch.calibration.data import VideoDataset
from colorvideovdp_tpu_torch.calibration.extract_features import (features_dir,
                                                                  read_args_from_file,
                                                                  train_conditions)
from colorvideovdp_tpu_torch.ops import masking as mk

PARAMS = ("ch_chrom_w", "ch_trans_w", "baseband_weight", "jod_a", "jod_exp")


def init_params(metric, device):
    """The trainable parameters, float32 leaves that require grad, at the
    metric's values."""
    return {k: torch.tensor(np.asarray(getattr(metric, k), np.float32), device=device,
                            requires_grad=True) for k in PARAMS}


def pooling_and_jods(params, qpc, *, beta_sch, beta_tch, beta_t, image_int):
    """Differentiable pooling -> JOD with trainable weights (the metric's
    ``do_pooling_and_jods`` with ``params`` in place of its attributes)."""
    C, no_frames, bands = qpc.shape[1:]
    one = torch.ones((), dtype=qpc.dtype, device=qpc.device)
    per_ch_w = torch.stack([one, params["ch_chrom_w"], params["ch_chrom_w"],
                            params["ch_trans_w"]])[:C].reshape(1, C, 1, 1)
    per_sband_w = torch.ones((1, C, 1, bands), dtype=qpc.dtype, device=qpc.device)
    per_sband_w[:, :, 0, -1] = params["baseband_weight"][:C]
    Q_sc = mk.lp_norm(qpc * per_ch_w * per_sband_w, beta_sch, dim=3, normalize=False)
    Q_tc = mk.lp_norm(Q_sc, beta_tch, dim=1, normalize=False)
    if no_frames == 1:
        Q = Q_tc * image_int
    else:
        Q = mk.lp_norm(Q_tc, beta_t, dim=2, normalize=True)
    Q = torch.squeeze(Q)
    return mk.met2jod(Q, params["jod_a"], params["jod_exp"])


def pool_kwargs(metric):
    return dict(beta_sch=metric.beta_sch, beta_tch=metric.beta_tch, beta_t=metric.beta_t,
                image_int=metric.image_int)


def train_step(params, opt, batch, pool):
    """One Adam step on a batch of (qpc, rho, jod) samples: the per-sample
    gradients summed and divided by the batch length (variable-length clips
    do not stack). Returns the samples' losses before the step."""
    leaves = [params[k] for k in PARAMS]
    dev = leaves[0].device
    grads, losses = None, []
    for qpc, _rho, q in batch:
        label = torch.tensor(q, dtype=torch.float32, device=dev)
        jod = pooling_and_jods(params, torch.as_tensor(qpc, device=dev), **pool)
        loss = torch.mean((jod - label) ** 2)
        g = torch.autograd.grad(loss, leaves)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        losses.append(float(loss.detach()))
    for p, g in zip(leaves, grads):
        p.grad = g / len(batch)
    opt.step()
    return losses


@torch.no_grad()
def predict(params, qpc, pool):
    """The JOD that ``params`` give one sample's features (numpy)."""
    jod = pooling_and_jods(params, torch.as_tensor(qpc, device=params["jod_a"].device), **pool)
    return float(jod.reshape(-1)[0])


def evaluate(params, dataset, pool):
    preds, labels = [], []
    for batch in dataset.iter_batches(8):
        for qpc, _rho, q in batch:
            preds.append(predict(params, qpc, pool))
            labels.append(float(q))
    preds, labels = np.asarray(preds), np.asarray(labels)
    rmse = float(np.sqrt(np.mean((preds - labels) ** 2)))
    plcc = float(sstats.pearsonr(preds, labels)[0]) if len(preds) > 1 else 0.0
    srcc = float(sstats.spearmanr(preds, labels)[0]) if len(preds) > 1 else 0.0
    return rmse, plcc, srcc


def get_args(argv=None):
    parser = argparse.ArgumentParser("Calibrate cvvdp parameters for a new dataset")
    parser.add_argument("quality_file", help="Path to .csv file containing quality scores.")
    parser.add_argument("-o", "--output-dir", default="new_config")
    parser.add_argument("-s", "--split-column", default="reference")
    parser.add_argument("-r", "--train-ratio", type=int, choices=range(100), default=80)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-f", "--features-suffix", default=None)
    parser.add_argument("-c", "--config-paths", type=str, nargs="+", default=[])
    parser.add_argument("--resample-bands", action="store_true", default=False)
    parser.add_argument("-v", "--verbose", action="store_true", default=False)
    parser.add_argument("-b", "--batch", type=int, default=4)
    parser.add_argument("-lr", "--learning-rate", type=float, default=1e-3)
    parser.add_argument("-e", "--num-epochs", type=int, default=50)
    parser.add_argument("--val-epoch", type=int, default=1)
    parser.add_argument("--save", choices=["latest", "best-rmse", "best-pearson", "best-spearman"],
                        default="latest")
    parser.add_argument("--log-dir", default=None,
                        help="write tensorboard (or CSV fallback) training curves to this "
                        "directory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the refit: 'cuda' (the default) or 'cpu'")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    num_skip = read_args_from_file(args, argv)
    args = parser.parse_args(argv)
    quality_table = pd.read_csv(args.quality_file, skiprows=num_skip)
    level = logging.DEBUG if args.verbose else logging.INFO
    logging.basicConfig(format="[%(levelname)s] %(message)s", level=level)
    return args, quality_table


class TrainLogger:
    """Tensorboard training curves, with a plain-CSV fallback when
    tensorboard is unavailable."""

    def __init__(self, log_dir):
        self.writer = None
        self.csv = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir=log_dir)
        except ImportError:
            self.csv = open(os.path.join(log_dir, "training_log.csv"), "w")
            self.csv.write("step,tag,value\n")

    def add_scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        elif self.csv is not None:
            self.csv.write(f"{step},{tag},{value}\n")

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self.csv is not None:
            self.csv.close()


def main(argv=None):
    """Fit, write ``<output-dir>/cvvdp_parameters.json`` and return its path
    and each epoch's seconds (its training steps, not its validation)."""
    args, quality_table = get_args(argv)

    metric = cvt.cvvdp(quiet=True, temp_padding="replicate", config_paths=args.config_paths,
                       device=args.device)
    params = init_params(metric, metric.device)
    pool = pool_kwargs(metric)

    train_cond = train_conditions(quality_table, args.split_column, args.train_ratio, args.seed)
    train_table = quality_table[quality_table[args.split_column].isin(train_cond)]
    # As the JAX script: the test table is every row that is not a train row,
    # less any row that appears twice in the CSV (drop_duplicates(keep=False)
    # drops both copies).
    test_table = pd.concat([quality_table, train_table]).drop_duplicates(keep=False)

    ft_path = features_dir(args.features_suffix)
    train_ds = VideoDataset(ft_path, train_table, "train", args.resample_bands)
    val_ds = VideoDataset(ft_path, test_table, "test", args.resample_bands)

    opt = torch.optim.Adam([params[k] for k in PARAMS], lr=args.learning_rate)

    best = {"rmse": np.inf, "pearson": -np.inf, "spearman": -np.inf}
    best_params = {k: v.detach().clone() for k, v in params.items()}
    tlog = TrainLogger(args.log_dir)

    epoch_s = []
    try:
        for epoch in range(args.num_epochs):
            t0 = time.time()
            losses = []
            for batch in train_ds.iter_batches(args.batch, shuffle=True, seed=args.seed + epoch):
                losses += train_step(params, opt, batch, pool)
            if metric.device.type == "cuda":
                torch.cuda.synchronize(metric.device)
            epoch_s.append(time.time() - t0)
            epoch_loss = sum(losses) / max(len(losses), 1)
            logging.info(f"epoch {epoch}: train MSE {epoch_loss:.4f}")
            tlog.add_scalar("Loss/train", epoch_loss, epoch)

            if (epoch + 1) % args.val_epoch == 0 and len(val_ds) > 0:
                rmse, plcc, srcc = evaluate(params, val_ds, pool)
                logging.info(f"  val: RMSE {rmse:.4f} PLCC {plcc:.4f} SRCC {srcc:.4f}")
                tlog.add_scalar("RMSE/test", rmse, epoch)
                tlog.add_scalar("PLCC/test", plcc, epoch)
                tlog.add_scalar("SRCC/test", srcc, epoch)
                improved = ((args.save == "best-rmse" and rmse < best["rmse"])
                            or (args.save == "best-pearson" and plcc > best["pearson"])
                            or (args.save == "best-spearman" and srcc > best["spearman"]))
                best["rmse"] = min(best["rmse"], rmse)
                best["pearson"] = max(best["pearson"], plcc)
                best["spearman"] = max(best["spearman"], srcc)
                if improved:
                    best_params = {k: v.detach().clone() for k, v in params.items()}
    finally:
        tlog.close()

    final = params if args.save == "latest" else best_params
    # Push the fitted values back onto the metric and serialise.
    final = {k: v.detach().cpu().numpy() for k, v in final.items()}
    metric.ch_chrom_w = float(final["ch_chrom_w"])
    metric.ch_trans_w = float(final["ch_trans_w"])
    metric.baseband_weight = final["baseband_weight"]
    metric.jod_a = float(final["jod_a"])
    metric.jod_exp = float(final["jod_exp"])
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "cvvdp_parameters.json")
    metric.save_to_config(out, f"Calibrated on {args.quality_file} (PyTorch port)")
    logging.info(f"Saved calibrated parameters to {out}")
    return {"config": out, "epoch_s": epoch_s}


if __name__ == "__main__":
    main()
