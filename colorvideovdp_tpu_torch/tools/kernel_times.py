"""Time the blur and CSF LUT kernels on the card, device time apart from call time.

    python3 colorvideovdp_tpu_torch/tools/kernel_times.py [--reps N] [--sass DIR]

Run as a script with ``PYTHONPATH`` naming a checkout's root, it measures that
checkout's package, so two checkouts compared in one call on one card take
turns (A, B, B, A). For each kernel at the shapes of the training step (phase
5 of ``chip_smoke.py``), of the generic chain and of the ML trunk's 4K band 0
it reports:

- ``device_ms``: the device time of one call, the sum of the CUDA kernels'
  times under ``torch.profiler`` over ``--reps`` calls, divided by the count
  (``device_ms`` below, which ``chip_smoke.py`` also uses);
- ``call_ms``: CUDA events around a single call, median of 5 (the host work
  of the wrapper between the events included), as ``chip_smoke.py`` times
  every kernel;
- the plain PyTorch version's call and device times and, for the blur, a
  depthwise convolution's (the library yardstick, cuDNN with TF32 off).

The blur's adjoint is timed as ``Blur.backward`` (the adjoint kernel on the
card; autograd of ``blur_plain`` in checkouts before it), beside autograd of
``blur_plain`` as its plain version. Then the training step of
``chip_smoke.py`` phase 5 (``get_loss_fn(1080, 1920)``, 4 seeded sRGB pairs):
its time, the device time of ``Blur.backward`` within it (``timed_backward``,
CUDA events around each call) and the step's device time by kernel
(``blur_backward_split``, which phase 5 also uses).
``--sass DIR`` writes ``cuobjdump -sass`` of the CSF LUT kernels to DIR and
prints each kernel's instructions by opcode.

Prints one JSON line. Needs a CUDA card; it exits with an error without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch


def device_ms(fn, reps=20):
    """Device time of one call of ``fn``: every CUDA kernel's time under
    ``torch.profiler`` over ``reps`` calls (after one warm-up), divided by
    ``reps``. The host's time between launches is not in it."""
    from colorvideovdp_tpu_torch.tools.path_times import profile_device

    fn()
    torch.cuda.synchronize()
    _, busy, _ = profile_device(lambda: [fn() for _ in range(reps)])
    return busy / reps


def call_ms(fn, reps=5):
    """CUDA events around one call, median of ``reps`` (after a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@contextlib.contextmanager
def timed_backward(function_cls):
    """Record CUDA events around every call of ``function_cls.backward`` (an
    autograd Function) while the context is open; yields the list of event
    pairs. Autograd looks the backward up on the class at each call."""
    orig = function_cls.__dict__["backward"]
    pairs = []

    def backward(ctx, *grads):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig.__func__(ctx, *grads)
        end.record()
        pairs.append((start, end))
        return out

    function_cls.backward = staticmethod(backward)
    try:
        yield pairs
    finally:
        function_cls.backward = orig


def timing_row(fn, plain, lib=None, reps=20):
    """A kernel call ``fn`` beside its plain version and the library call
    ``lib`` (or None): each one's call time and device time."""
    short = max(2, reps // 4)
    return {"call_ms": call_ms(fn), "device_ms": device_ms(fn, reps),
            "plain_ms": call_ms(plain), "plain_device_ms": device_ms(plain, short),
            "library_ms": None if lib is None else call_ms(lib),
            "library_device_ms": None if lib is None else device_ms(lib, short)}


def blur_backward_split(step, reps=5):
    """``Blur.backward``'s time within ``step`` (CUDA events around each of
    its calls, the median over ``reps`` steps), and one profiled step: its
    device time by kernel, the device's busy time and the wall time."""
    from colorvideovdp_tpu_torch.ops.kernels.blur import Blur
    from colorvideovdp_tpu_torch.tools.path_times import profile_device

    per_step = []
    for _ in range(reps):
        with timed_backward(Blur) as pairs:
            step()
        torch.cuda.synchronize()
        per_step.append(sum(a.elapsed_time(b) for a, b in pairs))
    rows, busy, wall = profile_device(step)
    return {"blur_backward_ms": float(np.median(per_step)), "blur_backward_calls": len(pairs),
            "device_busy_ms": busy, "profiled_wall_ms": 1e3 * wall,
            "device_ms_by_kernel": [[ms, count, name[:100]] for ms, count, name in rows[:14]]}


def blur_rows(reps):
    from types import SimpleNamespace

    from colorvideovdp_tpu_torch.ops.blur import blur_plain, gaussian_kernel1d
    from colorvideovdp_tpu_torch.ops.kernels import blur as blr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    cases = (("blur13_(12,1080,1920)", 13, 3.0, (12, 1080, 1920)),
             ("blur13_(3,135,241)", 13, 3.0, (3, 135, 241)),
             ("blur13_(1,4,8,2160,3840)", 13, 3.0, (1, 4, 8, 2160, 3840)),
             ("blur33_(3,1080,1920)", 33, 8.0, (3, 1080, 1920)))
    for name, n, sigma, shape in cases:
        taps = gaussian_kernel1d(n, sigma)
        x = torch.rand(shape, device=dev, generator=gen)
        P, H, W = x.numel() // (shape[-2] * shape[-1]), shape[-2], shape[-1]
        conv = torch.nn.Conv2d(P, P, n, groups=P, padding=n // 2, padding_mode="reflect",
                               bias=False).to(dev)
        with torch.no_grad():
            conv.weight.copy_(torch.as_tensor(np.outer(taps, taps), device=dev)
                              .expand(P, 1, n, n))
        xc = x.reshape(1, P, H, W)
        with torch.no_grad():
            out[name] = timing_row(lambda: blr.blur(x, taps), lambda: blur_plain(x, taps),
                                   lambda: conv(xc), reps)
        # The adjoint at the same shape: Blur's backward, against autograd
        # of blur_plain.
        g = torch.randn(shape, device=dev, generator=gen)
        ctx = SimpleNamespace(taps=taps, shape=g.shape)

        def autograd_adjoint():
            with torch.enable_grad():
                x0 = g.new_zeros(shape, requires_grad=True)
                return torch.autograd.grad(blur_plain(x0, taps), x0, g)[0]

        out[name + "_adjoint"] = timing_row(lambda: blr.Blur.backward(ctx, g),
                                            autograd_adjoint, None, reps)
        del x, g, conv, xc
        torch.cuda.empty_cache()
    return out


def lut_rows(reps):
    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.kernels import csf_lut

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    m = cvt.cvvdp(display_name="standard_hdr_pq", device="cuda", quiet=True)
    x0, x1 = m.csf.lut_range()
    lut4 = torch.as_tensor(np.stack([m.csf.logS_of_logL(0.1, m.omega[0 if cc < 3 else 1],
                                                        cc if cc < 3 else 0)
                                     for cc in range(4)]), device=dev)
    out = {}
    for name, shape, C in (("lut_(1,1,1080,1920)_C3", (1, 1, 1080, 1920), 3),
                           ("lut_(1,1,8,2160,3840)_C4", (1, 1, 8, 2160, 3840), 4),
                           ("lut_(1,1,29,1,1)_C4", (1, 1, 29, 1, 1), 4)):
        luts = lut4[:C].contiguous()
        logL = torch.empty(shape, device=dev).uniform_(x0 - 0.5, x1 + 0.5, generator=gen)
        out[name] = timing_row(lambda: csf_lut.csf_lut(logL, luts, x0, x1),
                               lambda: csf_lut.csf_lut_plain(logL, luts, x0, x1), None, reps)
        if C == 3:
            g = torch.randn((C,) + shape, device=dev, generator=gen)
            out[name + "_bwd"] = timing_row(
                lambda: csf_lut.csf_lut_bwd(logL, g, luts, x0, x1),
                lambda: csf_lut.csf_lut_bwd_plain(logL, g, luts, x0, x1), None, reps)
        torch.cuda.empty_cache()
    return out


def train_step(reps=5):
    """Phase 5's step: its time and peak memory, and ``blur_backward_split``."""
    import colorvideovdp_tpu_torch as cvt

    dev = torch.device("cuda")
    Ht, Wt, Bt = 1080, 1920, 4
    rng = np.random.RandomState(11)
    ref_np = rng.rand(Bt, 3, 1, Ht, Wt).astype(np.float32)
    test_np = np.clip(ref_np + rng.randn(*ref_np.shape).astype(np.float32) * 0.1, 0, 1)
    ref_t, test_t = torch.from_numpy(ref_np).to(dev), torch.from_numpy(test_np).to(dev)
    mt = cvt.cvvdp(display_name="standard_fhd", device="cuda", quiet=True)
    loss_fn = mt.get_loss_fn(Ht, Wt)

    def step():
        x = test_t.clone().requires_grad_()
        v = loss_fn(x, ref_t)
        return v.detach(), torch.autograd.grad(v, x)[0]

    v, _ = step()
    torch.cuda.reset_peak_memory_stats()
    step_ms = call_ms(step, reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return {"loss": float(v), "step_ms": step_ms, "peak_gib": peak,
            **blur_backward_split(step, reps)}


def sass_counts(out_dir):
    """``cuobjdump -sass`` of the built library's CSF LUT kernels into
    ``out_dir``; each kernel's instruction count by opcode."""
    from colorvideovdp_tpu_torch.ops.kernels import _build

    lib = _build.build()
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    counts, name, keep = {}, None, []
    for line in sass.splitlines():
        fm = re.search(r"Function : (\S+)", line)
        if fm:
            name = fm.group(1) if "csf_lut" in fm.group(1) else None
            if name:
                counts[name] = {}
                keep.append(line)
            continue
        if name is None:
            continue
        keep.append(line)
        om = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if om:
            op = om.group(1)
            counts[name][op] = counts[name].get(op, 0) + 1
    with open(os.path.join(out_dir, "csf_lut.sass"), "w") as f:
        f.write("\n".join(keep))
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    import colorvideovdp_tpu_torch as cvt
    from colorvideovdp_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    out = {"package": os.path.dirname(os.path.abspath(cvt.__file__)), "card": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    out.update(blur_rows(args.reps))
    out.update(lut_rows(args.reps))
    out["train_step"] = train_step()
    if args.sass:
        out["sass_csf_lut"] = sass_counts(args.sass)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
