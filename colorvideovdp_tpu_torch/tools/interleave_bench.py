"""Micro-benchmark of the lane interleave along W on the card: the
interleave, de-interleave and concat kernels of ``csrc/interleave.cu``
against their plain PyTorch versions, the PyTorch calls that compute the same
functions, the copy floor (the concat kernel: the same bytes with no shuffle)
and the bound (the bytes moved at the HBM rate).

Counterpart of ``tools/interleave_bench.py`` of the JAX package, at its shape:
(P, H, W) = (48, 2160, 3840), band 0 of a 4K block of 6 frames with its 8
test/reference channel planes. It measures what merging the two phases of a
polyphase expand costs, the step that the one-pass band kernel
(``csrc/band_pooled.cu``) does in shared memory.

Usage: ``python -m colorvideovdp_tpu_torch.tools.interleave_bench
[--cpu-check] [--reps N]``. ``--cpu-check`` checks the plain versions bit for
bit against numpy at (2, 128, 512) on the CPU and stops; without it the tool
needs a CUDA card and ``nvcc``, checks each kernel bit for bit against its
plain version, times every function (CUDA events, median of N, default 5)
and prints one JSON line of the results.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.kernels import interleave as il

SHAPE = (48, 2160, 3840)
CPU_SHAPE = (2, 128, 512)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet

KERNELS = {  # name: (kernel, plain version, library call, number of inputs)
    "interleave": (il.interleave, il.interleave_plain, il.library_interleave, 2),
    "concat": (il.concat, il.concat_plain, il.library_concat, 2),
    "deinterleave": (il.deinterleave, il.deinterleave_plain, il.library_deinterleave, 1),
}


def make_inputs(P, H, W, device, seed=0):
    """(ev, od, x): two seeded (P, H, W/2) halves and their interleave."""
    rng = np.random.RandomState(seed)
    ev = rng.rand(P, H, W // 2).astype(np.float32)
    od = rng.rand(P, H, W // 2).astype(np.float32)
    x = np.stack([ev, od], axis=-1).reshape(P, H, W)
    return tuple(torch.from_numpy(a).to(device) for a in (ev, od, x))


def _args(name, ev, od, x):
    return (x,) if KERNELS[name][3] == 1 else (ev, od)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def check(ev, od, x):
    """{name: max |kernel - plain|}; raises unless every kernel gives its
    plain version's bits (and the plain versions numpy's: interleave
    reproduces x, deinterleave returns ev and od, concat its halves)."""
    errs = {}
    for name, (fn, plain, _, _) in KERNELS.items():
        args = _args(name, ev, od, x)
        got, want = _outs(fn(*args)), _outs(plain(*args))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: the kernel differs from its plain version")
        errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))
    wh = ev.shape[-1]
    c = il.concat_plain(ev, od)
    ok = (torch.equal(il.interleave_plain(ev, od), x)
          and all(torch.equal(a, b) for a, b in zip(il.deinterleave_plain(x), (ev, od)))
          and torch.equal(c[..., :wh], ev) and torch.equal(c[..., wh:], od))
    if not ok:
        raise AssertionError("a plain version differs from its definition")
    return errs


def time_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def measure(ev, od, x, reps=5):
    """{name: {ms, plain_ms, library_ms, copy_floor_ms, bound_ms, GB/s}} on
    the card: each input read once and each output written once (16 bytes
    per output pair), over the HBM rate."""
    n_bytes = 2 * (ev.numel() + od.numel()) * ev.element_size()
    bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    floor_ms = time_ms(lambda: il.concat(ev, od), reps)
    rows = {}
    for name, (fn, plain, lib, _) in KERNELS.items():
        args = _args(name, ev, od, x)
        ms = floor_ms if name == "concat" else time_ms(lambda: fn(*args), reps)
        rows[name] = dict(ms=ms, plain_ms=time_ms(lambda: plain(*args), reps),
                          library_ms=time_ms(lambda: lib(*args), reps), copy_floor_ms=floor_ms,
                          bound_ms=bound_ms, bound_by="bytes", gb_per_s=n_bytes / ms / 1e6)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-check", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args(argv)
    if a.cpu_check:
        check(*make_inputs(*CPU_SHAPE, "cpu"))
        print(f"correctness ok {CPU_SHAPE} (plain versions, CPU)")
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("interleave_bench: needs a CUDA card (or --cpu-check)")
    ev, od, x = make_inputs(*SHAPE, "cuda")
    errs = check(ev, od, x)
    print(f"correctness ok {SHAPE}: every kernel bit-equal to its plain version")
    rows = measure(ev, od, x, a.reps)
    for name, r in rows.items():
        print(f"{name:13s} kernel {r['ms']:.3f} ms ({r['gb_per_s']:.0f} GB/s), plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, copy floor "
              f"{r['copy_floor_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({100 * r['bound_ms'] / r['ms']:.1f}% of it)")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": SHAPE,
                      "kernels": {k: dict(r, max_abs_err=errs[k]) for k, r in rows.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
