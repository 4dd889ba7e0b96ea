"""Clip-list batch runner of the PyTorch port (counterpart of
``tools/run_cluster.py``): scores a CSV of clip pairs, k/N row-sharded over
workers, each worker writing its own CSV shard, then merges the shards.

Usage:
  python -m colorvideovdp_tpu_torch.tools.run_cluster --list clips.csv \
      --result out.csv [--worker k/N] [--resume] [--metric cvvdp] \
      [--display standard_4k] [--device cuda|cpu]
  python -m colorvideovdp_tpu_torch.tools.run_cluster --merge --result out.csv

clips.csv columns: test, reference [, display, fps]. Extra columns are
carried through to the output. Rows already present in the shard are
skipped with --resume. Each clip is scored with ``video_source_file`` and
``predict_video_source`` on one device; a clip that fails gets the Q_JOD
"error" and the batch goes on.

Under torchrun the worker spec defaults to ``RANK``/``WORLD_SIZE``, and a
worker scores on ``cuda:LOCAL_RANK`` when ``LOCAL_RANK`` is set. Run by
path, ``--merge`` imports no torch.
"""

from __future__ import annotations

import argparse
import csv
import glob
import logging
import os
import sys

# Run by path (``python colorvideovdp_tpu_torch/tools/run_cluster.py``), the
# package is found from the checkout, and --merge imports no torch.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--list", help="CSV of clip pairs to score")
    p.add_argument("--result", required=True, help="output CSV (base name)")
    p.add_argument("--merge", action="store_true",
                   help="merge <result>.shard*.csv into <result> and exit")
    p.add_argument("--metric", default="cvvdp")
    p.add_argument("--display", default="standard_4k",
                   help="default display model (per-row 'display' wins)")
    p.add_argument("--fps", type=float, default=0.0,
                   help="override fps for image sequences")
    p.add_argument("--worker", default=None,
                   help="k/N row sharding (0-based k); defaults to torchrun's "
                        "RANK/WORLD_SIZE when present")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default; cuda:LOCAL_RANK under torchrun) "
                        "or 'cpu'")
    p.add_argument("--temp-padding", default="symmetric",
                   choices=["replicate", "symmetric", "valid"],
                   help="temporal padding (the reference CLI's default is "
                        "symmetric; the metric ctor's is replicate)")
    p.add_argument("--resume", action="store_true",
                   help="skip rows already present in this worker's shard")
    p.add_argument("--nshards", type=int, default=None,
                   help="with --merge: expected shard count to verify")
    return p.parse_args(argv)


def _worker_spec(args):
    if args.worker:
        k, n = args.worker.split("/", 1)
        return int(k), int(n)
    if os.environ.get("RANK") and os.environ.get("WORLD_SIZE"):
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return 0, 1


def _device(args):
    """The worker's device: ``--device``, on card LOCAL_RANK under torchrun."""
    if args.device == "cuda" and os.environ.get("LOCAL_RANK"):
        return f"cuda:{int(os.environ['LOCAL_RANK'])}"
    return args.device


def _shard_name(result, k, n):
    if n == 1:
        return result
    base, ext = os.path.splitext(result)
    return f"{base}.shard{k:03d}of{n:03d}{ext or '.csv'}"


def merge(args):
    base, ext = os.path.splitext(args.result)
    shards = sorted(glob.glob(f"{base}.shard*{ext or '.csv'}"))
    if args.nshards is not None and len(shards) != args.nshards:
        raise SystemExit(
            f"expected {args.nshards} shards, found {len(shards)}")
    rows, header = [], None
    for s in shards:
        with open(s, newline="") as f:
            r = csv.reader(f)
            h = next(r)
            header = header or h
            rows.extend(list(r))
    with open(args.result, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    print(f"merged {len(shards)} shards, {len(rows)} rows -> {args.result}")


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.merge:
        merge(args)
        return
    if not args.list:
        raise SystemExit("--list is required unless --merge")

    k, n = _worker_spec(args)
    out_name = _shard_name(args.result, k, n)

    with open(args.list, newline="") as f:
        reader = csv.DictReader(f)
        all_rows = list(reader)
        in_fields = reader.fieldnames or []
    my_rows = [(i, r) for i, r in enumerate(all_rows) if i % n == k]
    logging.info(f"worker {k}/{n}: {len(my_rows)} of {len(all_rows)} rows")

    done = set()
    if args.resume and os.path.exists(out_name):
        with open(out_name, newline="") as f:
            for r in csv.DictReader(f):
                done.add((r.get("test"), r.get("reference")))

    # Imported here, so that --merge runs without torch.
    from colorvideovdp_tpu_torch.io.video_source_file import video_source_file
    from colorvideovdp_tpu_torch.metrics.base import vq_metric_dict

    out_fields = list(in_fields)
    for extra in ("metric", "Q_JOD"):
        if extra not in out_fields:
            out_fields.append(extra)
    new_file = not (args.resume and os.path.exists(out_name))
    out_f = open(out_name, "w" if new_file else "a", newline="")
    writer = csv.DictWriter(out_f, fieldnames=out_fields,
                            extrasaction="ignore")
    if new_file:
        writer.writeheader()

    met_cls = vq_metric_dict[args.metric]
    device = _device(args)
    metrics = {}  # display -> metric instance
    for i, row in my_rows:
        key = (row.get("test"), row.get("reference"))
        if key in done:
            continue
        display = row.get("display") or args.display
        if display not in metrics:
            kw_m = dict(display_name=display, quiet=True, device=device)
            try:
                metrics[display] = met_cls(temp_padding=args.temp_padding,
                                           **kw_m)
            except TypeError:  # metric without a temp_padding arg
                metrics[display] = met_cls(**kw_m)
        m = metrics[display]
        kw = {}
        fps = float(row.get("fps") or args.fps or 0)
        if fps > 0:
            kw["fps"] = fps
        try:
            vs = video_source_file(row["test"], row["reference"],
                                   display_photometry=display, **kw)
            Q, _ = m.predict_video_source(vs)
            row = dict(row, metric=args.metric, Q_JOD=f"{float(Q.reshape(-1)[0]):.6f}")
        except Exception as e:  # record the failure, keep the batch alive
            logging.error(f"row {i} ({row.get('test')}): {e}")
            row = dict(row, metric=args.metric, Q_JOD="error")
        writer.writerow(row)
        out_f.flush()
        logging.info(f"[{i}] {row.get('test')} -> {row['Q_JOD']}")
    out_f.close()


if __name__ == "__main__":
    main()
