"""Command-line interface of the PyTorch port (counterpart of
``colorvideovdp_tpu/cli.py``, with the same flags and output).

    python -m colorvideovdp_tpu_torch.cli -t test.yuv -r ref.yuv --display standard_hdr_pq
    cvvdp-torch -t test.png -r ref.png --heatmap supra-threshold -o out --device cpu

The metrics run on the card (``--device cuda``, the default) unless
``--device cpu`` is given; without a card the CLI fails rather than move to
the CPU. ``-i`` reads argument lines from standard input (a REPL)."""

from __future__ import annotations

import argparse
import glob
import inspect
import logging
import os
import shlex
import sys
import traceback

import numpy as np

import colorvideovdp_tpu_torch as cvt
from colorvideovdp_tpu_torch.io.writers import np2img, np2vid
from colorvideovdp_tpu_torch.metrics import dm_preview  # noqa: F401 (registers)
from colorvideovdp_tpu_torch.metrics import psnr  # noqa: F401 (registers)
from colorvideovdp_tpu_torch.metrics import ssim  # noqa: F401 (registers)
from colorvideovdp_tpu_torch.metrics.base import vq_exception, vq_metric_dict


def expand_wildcards(filestrs):
    if not isinstance(filestrs, list):
        return [filestrs]
    files = []
    for filestr in filestrs:
        if "*" in filestr:
            files += sorted(glob.glob(filestr))
        else:
            files.append(filestr)
    return files


def parse_args(arg_list=None):
    available_metrics = [m.replace("_", "-") for m in vq_metric_dict]
    parser = argparse.ArgumentParser(
        description="Evaluate ColorVideoVDP (PyTorch/CUDA) on a set of videos"
    )
    parser.add_argument("-t", "--test", type=str, nargs="+",
                        help="list of test images/videos")
    parser.add_argument("-r", "--ref", type=str, nargs="+",
                        help="list of reference images/videos")
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the metrics: 'cuda' (the default) or "
                        "'cpu'")
    parser.add_argument("--heatmap", type=str, default="none",
                        help="type of difference map (none, raw, threshold, "
                        "supra-threshold).")
    parser.add_argument("-g", "--distogram", type=float, default=-1, const=10,
                        nargs="?", help="generate a distogram; optional value "
                        "is the max JOD in the visualisation.")
    parser.add_argument("-x", "--features", action="store_true", default=False,
                        help="generate JSON files with extracted features.")
    parser.add_argument("-o", "--output-dir", type=str, default=None,
                        help="directory for heatmaps and feature files")
    parser.add_argument("--result", type=str, default=None,
                        help="write results to this CSV file.")
    parser.add_argument("-c", "--config-paths", type=str, nargs="+",
                        default=[], help="paths to configuration files or "
                        "directories (display_models.json, color_spaces.json, "
                        "cvvdp_parameters.json)")
    parser.add_argument("-d", "--display", type=str, default="standard_4k",
                        help="display name, or ? to list the models.")
    parser.add_argument("-n", "--nframes", type=int, default=-1,
                        help="number of video frames to compare")
    parser.add_argument("--count-frames", action="store_true", default=False,
                        help="count frames by decoding (slow, accurate)")
    parser.add_argument("-f", "--full-screen-resize",
                        choices=["bilinear", "bicubic", "nearest", "area"],
                        default=None, help="resize both videos to the "
                        "display resolution")
    parser.add_argument("-m", "--metric", choices=available_metrics, nargs="+",
                        default=["cvvdp"], help="metric(s) to run")
    parser.add_argument("--temp-padding",
                        choices=["replicate", "symmetric", "valid"],
                        default="symmetric",
                        help="temporal padding for the first frames")
    parser.add_argument("--pix-per-deg", type=float, default=None,
                        help="override display geometry with this ppd")
    parser.add_argument("--fps", type=float, default=None,
                        help="override/declare frames per second")
    parser.add_argument("--frames", type=str, default=None,
                        help="frame range first:step:last (Matlab notation)")
    parser.add_argument("--gpu-mem", type=float, default=None,
                        help="device memory budget in GB for block sizing")
    parser.add_argument("-q", "--quiet", action="store_true", default=False,
                        help="print only the final quality value")
    parser.add_argument("-v", "--verbose", action="store_true", default=False)
    parser.add_argument("--debug", action="store_true", default=False,
                        help="print stack traces on errors")
    parser.add_argument("--ffmpeg-cc", action="store_true", default=False,
                        help="accepted for compatibility (decode is OpenCV)")
    parser.add_argument("--temp-resample", type=float, nargs="?", default=-1,
                        const=0, help="resample both videos to a common "
                        "frame rate")
    parser.add_argument("-i", "--interactive", action="store_true",
                        default=False, help="read argument lines from stdin")
    parser.add_argument("--dump-channels", nargs="+",
                        choices=["temporal", "lpyr", "difference"],
                        default=None, help="dump intermediate channels")
    return parser.parse_args(arg_list)


def run_on_args(args):
    if args.quiet:
        log_level = logging.ERROR
    else:
        log_level = logging.DEBUG if args.verbose else logging.INFO
    logging.basicConfig(format="[%(levelname)s] %(message)s", level=log_level)

    args.metric = [m.replace("-", "_") for m in args.metric]

    if args.verbose:
        import platform

        logging.debug(f"Platform: {platform.platform()}")

    if args.display == "?":
        cvt.vvdp_display_photometry.list_displays(args.config_paths)
        return

    if args.test is None or args.ref is None:
        logging.error(
            "Paths to both test and reference content need to be specified."
        )
        return

    frame_range = None
    if args.frames is not None:
        ss = args.frames.split(":")
        sn = [0, 1, 10000] if len(ss) == 3 else [0, 10000]
        for kk in range(len(ss)):
            if ss[kk].isnumeric():
                sn[kk] = int(ss[kk])
        if len(ss) == 3:
            frame_range = range(sn[0], sn[2] + 1, sn[1])
        else:
            frame_range = range(sn[0], sn[1] + 1)

    if args.heatmap == "none":
        args.heatmap = None
    if args.heatmap and args.heatmap not in ("raw", "threshold",
                                             "supra-threshold"):
        logging.error(
            'The recognized heatmap types are: "none", "raw", "threshold" '
            'and "supra-threshold"'
        )
        sys.exit(1)
    do_heatmap = bool(args.heatmap)

    args.test = expand_wildcards(args.test)
    args.ref = expand_wildcards(args.ref)
    N_test, N_ref = len(args.test), len(args.ref)
    if N_test == 0:
        logging.error("No test images/videos found.")
        sys.exit(1)
    if N_ref == 0:
        logging.error("No reference images/videos found.")
        sys.exit(1)
    if N_test != N_ref and N_test != 1 and N_ref != 1:
        logging.error(
            "Pass the same number of reference and test sources, or a single "
            "reference/test to pair with all of the other kind."
        )
        sys.exit(1)

    display_photometry = cvt.vvdp_display_photometry.load(
        args.display, config_paths=args.config_paths
    )
    if args.pix_per_deg is None:
        display_geometry = cvt.vvdp_display_geometry.load(
            args.display, config_paths=args.config_paths
        )
    else:
        display_geometry = cvt.vvdp_display_geometry(
            [1024, 1024], ppd=args.pix_per_deg
        )

    out_dir = "." if args.output_dir is None else args.output_dir
    os.makedirs(out_dir, exist_ok=True)

    dump_channels = None
    if args.dump_channels:
        from colorvideovdp_tpu_torch.dump_channels import DumpChannels

        dump_channels = DumpChannels(
            dump_temp_ch="temporal" in args.dump_channels,
            dump_lpyr="lpyr" in args.dump_channels,
            dump_diff="difference" in args.dump_channels,
            output_dir=args.output_dir,
        )

    # Reflection-based constructor-argument filtering lets one CLI drive
    # heterogeneous metric constructors.
    metrics = []
    for mm in args.metric:
        if mm not in vq_metric_dict:
            raise RuntimeError(f"Unknown metric {mm}")
        metric_class = vq_metric_dict[mm]
        ctor_args = list(inspect.getfullargspec(metric_class.__init__)[0])
        bases = list(metric_class.__bases__)
        for bc in bases:
            if bc.__init__ is not object.__init__:
                ctor_args.extend(inspect.getfullargspec(bc.__init__)[0])
            bases.extend(bc.__bases__)
        met_args = {}
        if "display_photometry" in ctor_args:
            met_args["display_photometry"] = display_photometry
        if "display_geometry" in ctor_args:
            met_args["display_geometry"] = display_geometry
        if "heatmap" in ctor_args:
            met_args["heatmap"] = args.heatmap
        if "temp_padding" in ctor_args:
            met_args["temp_padding"] = args.temp_padding
        if "config_paths" in ctor_args:
            met_args["config_paths"] = args.config_paths
        if "gpu_mem" in ctor_args:
            met_args["gpu_mem"] = args.gpu_mem
        if "dump_channels" in ctor_args:
            met_args["dump_channels"] = dump_channels
        if "quiet" in ctor_args:
            met_args["quiet"] = args.quiet
        if "device" in ctor_args:
            met_args["device"] = args.device
        fv = metric_class(**met_args)
        fv.train(False)
        metrics.append(fv)
        info_str = fv.get_info_string()
        if info_str is not None:
            logging.info(
                "When reporting metric results, please include the following "
                "information:"
            )
            logging.info(info_str)

    res_fh = None
    if args.result is not None:
        res_fh = open(args.result, "w")
        res_fh.write("test, reference")
        for mm in metrics:
            res_fh.write(", " + mm.short_name())
        res_fh.write("\n")

    for kk in range(max(N_test, N_ref)):
        test_file = args.test[min(kk, N_test - 1)]
        ref_file = args.ref[min(kk, N_ref - 1)]
        if res_fh is not None:
            res_fh.write(f"{test_file}, {ref_file}")
        logging.info(
            f"Predicting the quality of '{test_file}' compared to "
            f"'{ref_file}'"
        )
        for mm in metrics:
            nframes = -2 if args.count_frames else args.nframes
            if args.temp_resample >= 0:
                from colorvideovdp_tpu_torch.io.video_source_file import (
                    video_source_temp_resample_file,
                )

                if args.temp_resample > 0:
                    video_source_temp_resample_file.max_fps = (
                        args.temp_resample
                    )
                vs = video_source_temp_resample_file(
                    test_file, ref_file,
                    display_photometry=display_photometry,
                    config_paths=args.config_paths,
                    full_screen_resize=args.full_screen_resize,
                    resize_resolution=display_geometry.resolution,
                    frames=nframes, verbose=args.verbose,
                )
            else:
                from colorvideovdp_tpu_torch.io.video_source_file import (
                    video_source_file,
                )

                vs = video_source_file(
                    test_file, ref_file,
                    display_photometry=display_photometry,
                    config_paths=args.config_paths,
                    full_screen_resize=args.full_screen_resize,
                    resize_resolution=display_geometry.resolution,
                    frames=nframes, fps=args.fps, frame_range=frame_range,
                    preload=False, ffmpeg_cc=args.ffmpeg_cc,
                    verbose=args.verbose,
                )

            base = os.path.splitext(os.path.basename(test_file))[0]
            base_fname = os.path.join(out_dir, base)
            mm.set_base_fname(base_fname)

            Q_pred, stats = mm.predict_video_source(vs)
            # A tensor on the metric's device, or a numpy value.
            Q = float(Q_pred.reshape(-1)[0])
            if args.quiet:
                print(f"{Q:0.4f}")
            else:
                units_str = f" [{mm.quality_unit()}]"
                print(f"{mm.short_name()}={Q:0.4f}{units_str}")
            if res_fh is not None:
                res_fh.write(f", {Q}")

            if args.features and stats is not None:
                dest = os.path.join(out_dir, base + "_fmap.json")
                logging.info(f"Writing feature map '{dest}' ...")
                mm.write_features_to_json(stats, dest)

            if do_heatmap and stats is not None:
                hm = np.asarray(stats["heatmap"], np.float32)
                # (1, C, F, H, W) -> (F, H, W, C)
                hm = hm[0].transpose(1, 2, 3, 0)
                if hm.shape[0] > 1:
                    dest = os.path.join(out_dir, base + "_heatmap.mp4")
                    logging.info(f"Writing heat map '{dest}' ...")
                    np2vid(hm, dest, vs.get_frames_per_second(), args.verbose)
                else:
                    dest = os.path.join(out_dir, base + "_heatmap.png")
                    logging.info(f"Writing heat map '{dest}' ...")
                    np2img(hm, dest)

            if args.distogram != -1:
                dest = os.path.join(out_dir, base + "_distogram.png")
                logging.info(f"Writing distogram '{dest}' ...")
                mm.export_distogram(stats, dest, jod_max=args.distogram)

            del stats
        if res_fh is not None:
            res_fh.write("\n")

    if res_fh is not None:
        res_fh.close()


def main(argv=None):
    args = parse_args(argv)
    try:
        if args.interactive:
            while True:
                line = sys.stdin.readline()
                if not line:
                    break
                run_on_args(parse_args(shlex.split(line)))
        else:
            run_on_args(args)
    except (vq_exception, FileNotFoundError) as ex:
        # A missing input file is the user's error too: logged, with the
        # traceback only under --debug.
        logging.error(str(ex))
        if args.debug:
            traceback.print_exc()


if __name__ == "__main__":
    main()
