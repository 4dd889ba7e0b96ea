"""Time the stages of the blur and CSF LUT kernels on the card, by variants.

    python3 colorvideovdp_tpu_torch/tools/stage_times.py

Without an SM profiler, a stage's cost is read here as the device time it
adds. Each variant is the kernel's source with
stages cut: a text edit of ``csrc/blur.cu`` or ``csrc/csf_lut.cu`` that must
match where ``VARIANTS`` says, built by its own ``nvcc`` (all started
together) into a library under ``build/colorvideovdp_tpu_torch/stages/``.
At each case the variants are timed in turns (full, each cut, then the same
in reverse) by device time (``kernel_times.device_ms``), beside a streaming
floor (``copy``: ``Tensor.copy_`` of the same bytes; for the LUT backward
``torch.sum`` of g's planes into the output); the full variant's output
must equal the package kernel's bit for bit.

Blur variants: ``no_vertical_taps`` (stage 1 keeps tap 0), ``no_horizontal_taps``
(stage 2 keeps tap 0), ``no_taps`` (both), ``no_fetch`` (no cp.async copy
issued: the ring is read as it stands), ``no_folds`` (the adjoint's edge folds
skipped). LUT variants: ``no_powf`` (10 ** v replaced by v), ``no_table``
(the lerp replaced by the index; the backward still reads its slope's
knots), ``no_powf_no_table``. A cut variant computes other numbers; only its
time is read.

Prints one JSON line. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

_H_TAPS = ("for (int k = 1; k <= 2 * R; ++k)\n          a = mul_add_rn",
           "for (int k = 1; k <= 0; ++k)\n          a = mul_add_rn", 1)
_V_TAPS = ("if (k >= 0 && k <= 2 * R) {", "if (k == 0) {", 1)
_INC = '#include "common.cuh"\n'
_NO_POWF = (_INC, _INC + "#define pow10_lut(v) (v)\n", 1)
_NO_TABLE = (_INC, _INC + "#define lut_lerp(v, nk, ind) (ind)\n", 1)

REPS = 20  # calls a device time averages over

# source -> variant -> [(text, replacement, times it must occur)]
VARIANTS = {
    "blur.cu": {
        "full": [],
        "no_vertical_taps": [_V_TAPS],
        "no_horizontal_taps": [_H_TAPS],
        "no_taps": [_V_TAPS, _H_TAPS],
        "no_fetch": [("cp_async16(dst, ", "if (false) cp_async16(dst, ", 1),
                     ("cp_async4(dst, ", "if (false) cp_async4(dst, ", 1)],
        "no_folds": [("if (ADJ && R > 0) {", "if (false) {", 2)],
    },
    "csf_lut.cu": {
        "full": [],
        "no_powf": [_NO_POWF],
        "no_table": [_NO_TABLE],
        "no_powf_no_table": [(_INC, _INC + "#define pow10_lut(v) (v)\n"
                              "#define lut_lerp(v, nk, ind) (ind)\n", 1)],
    },
}


def build_variants():
    """{(source, variant): ctypes library}, every variant built at once."""
    from colorvideovdp_tpu_torch.ops.kernels import _build

    root = os.path.join(_build.BUILD_DIR, "stages")
    shutil.rmtree(root, ignore_errors=True)
    jobs = []
    for src, variants in VARIANTS.items():
        with open(os.path.join(_build.CSRC_DIR, src)) as f:
            text = f.read()
        for name, edits in variants.items():
            d = os.path.join(root, f"{src[:-3]}_{name}")
            os.makedirs(d)
            shutil.copy(os.path.join(_build.CSRC_DIR, "common.cuh"), d)
            out = text
            for old, new, count in edits:
                if out.count(old) != count:
                    raise RuntimeError(f"{src} {name}: {old!r} occurs {out.count(old)} times, "
                                       f"not {count}")
                out = out.replace(old, new)
            with open(os.path.join(d, src), "w") as f:
                f.write(out)
            lib = os.path.join(d, "lib.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
                   os.path.join(d, src)]
            jobs.append(((src, name), lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                            stderr=subprocess.PIPE, text=True)))
    libs = {}
    for key, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key}: {err}")
        cdll = ctypes.CDLL(lib)
        for fn in ("cvvdp_blur", "cvvdp_csf_lut", "cvvdp_csf_lut_bwd"):
            if hasattr(cdll, fn):
                getattr(cdll, fn).argtypes = _build.SIGNATURES[fn]
        libs[key] = cdll
    return libs


def in_turns(calls, copy, reps):
    """Device ms of each call, in turns: the variants forward, then reversed;
    the copy first and last."""
    from colorvideovdp_tpu_torch.tools.kernel_times import device_ms

    names = list(calls)
    times = {name: [] for name in names}
    times["copy"] = [device_ms(copy, reps)]
    for name in names + names[::-1]:
        times[name].append(device_ms(calls[name], reps))
    times["copy"].append(device_ms(copy, reps))
    return times


def blur_cases(libs, reps):
    from colorvideovdp_tpu_torch.ops.blur import gaussian_kernel1d
    from colorvideovdp_tpu_torch.ops.kernels import blur as blr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for shape, n, sigma in (((12, 1080, 1920), 13, 3.0), ((3, 1080, 1920), 33, 8.0)):
        taps = np.ascontiguousarray(gaussian_kernel1d(n, sigma), np.float32)
        x = torch.rand(shape, device=dev, generator=gen)
        y = torch.empty_like(x)
        P, H, W = shape
        for adjoint in (0, 1):
            names = [v for v in VARIANTS["blur.cu"] if adjoint or v != "no_folds"]

            def call(lib, adjoint=adjoint):
                return lambda: lib.cvvdp_blur(x.data_ptr(), y.data_ptr(), P, H, W,
                                              taps.ctypes.data, n, adjoint, stream)

            call(libs[("blur.cu", "full")])()
            ref = (blr.blur_adjoint if adjoint else blr.blur)(x, taps)
            if not torch.equal(y, ref):
                raise AssertionError(f"the full blur variant differs from the kernel at {shape}")
            key = f"blur{'_adjoint' if adjoint else ''} {n} taps {tuple(shape)}"
            out[key] = in_turns({v: call(libs[("blur.cu", v)]) for v in names},
                                lambda: y.copy_(x), reps)
        del x, y
        torch.cuda.empty_cache()
    return out


def lut_cases(libs, reps):
    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.kernels import csf_lut

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    x0, x1 = m.csf.lut_range()
    lut4 = torch.as_tensor(np.stack([m.csf.logS_of_logL(0.1, m.omega[0 if cc < 3 else 1],
                                                        cc if cc < 3 else 0)
                                     for cc in range(4)]), device=dev)
    nk = lut4.shape[1]
    scale = (nk - 1) / (x1 - x0)
    out = {}
    for shape, C, backward in (((1, 1, 1080, 1920), 3, False), ((1, 1, 8, 2160, 3840), 4, False),
                               ((1, 1, 1080, 1920), 3, True)):
        luts = lut4[:C].contiguous()
        logL = torch.empty(shape, device=dev).uniform_(x0 - 0.5, x1 + 0.5, generator=gen)
        n = logL.numel()
        if backward:
            g = torch.randn((C,) + shape, device=dev, generator=gen)
            res = torch.empty_like(logL)

            def call(lib):
                return lambda: lib.cvvdp_csf_lut_bwd(logL.data_ptr(), g.data_ptr(),
                                                     res.data_ptr(), n, C, nk, luts.data_ptr(),
                                                     x0, scale, stream)

            ref = csf_lut.csf_lut_bwd(logL, g, luts, x0, x1)
            copy = (lambda: torch.sum(g, 0, out=res))  # noqa: E731 (reads g, writes n)
        else:
            res = torch.empty((C,) + shape, device=dev)

            def call(lib):
                return lambda: lib.cvvdp_csf_lut(logL.data_ptr(), res.data_ptr(), n, C, nk,
                                                 luts.data_ptr(), x0, scale, stream)

            ref = csf_lut.csf_lut(logL, luts, x0, x1)
            copy = (lambda: res.copy_(logL.expand((C,) + shape)))  # noqa: E731
        call(libs[("csf_lut.cu", "full")])()
        if not torch.equal(res, ref):
            raise AssertionError(f"the full LUT variant differs from the kernel at {shape}")
        key = f"csf_lut{'_bwd' if backward else ''} C={C} {tuple(shape)}"
        out[key] = in_turns({v: call(libs[("csf_lut.cu", v)]) for v in VARIANTS["csf_lut.cu"]},
                            copy, reps)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = build_variants()
    out = {"card": smi, "reps": REPS}
    out.update(blur_cases(libs, REPS))
    out.update(lut_cases(libs, REPS))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
