"""Lane interleave, concat and de-interleave along W: CUDA kernel wrappers
beside their plain PyTorch versions.

Replaces the Pallas micro-kernels of ``tools/interleave_bench.py``
(``pallas_interleave`` :50, ``pallas_concat`` :77, ``pallas_deinterleave``
:109), which measure what merging the two phases of a polyphase expand costs.
Kernels: ``csrc/interleave.cu`` (16-byte accesses, bound by memory). The
measurement is ``colorvideovdp_tpu_torch/tools/interleave_bench.py``.

* ``interleave(ev, od)``: (P, H, W/2) x 2 -> (P, H, W), ``out[..., 2j] = ev``,
  ``out[..., 2j + 1] = od``;
* ``concat(ev, od)``: ``[ev | od]`` along W, the same bytes without a shuffle
  (the copy floor);
* ``deinterleave(x)``: the inverse of ``interleave``, (ev, od).

CPU tensors take the plain versions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import torch

from . import _build


def _check_halves(name, ev, od):
    if ev.shape != od.shape or ev.dim() < 1:
        raise ValueError(f"{name}: halves of unequal shape {tuple(ev.shape)}, {tuple(od.shape)}")


def interleave_plain(ev, od):
    _check_halves("interleave", ev, od)
    out = ev.new_empty(ev.shape[:-1] + (2 * ev.shape[-1],))
    out[..., 0::2] = ev
    out[..., 1::2] = od
    return out


def concat_plain(ev, od):
    _check_halves("concat", ev, od)
    wh = ev.shape[-1]
    out = ev.new_empty(ev.shape[:-1] + (2 * wh,))
    out[..., :wh] = ev
    out[..., wh:] = od
    return out


def deinterleave_plain(x):
    if x.shape[-1] % 2:
        raise ValueError(f"deinterleave: odd width {x.shape[-1]}")
    v = x.reshape(x.shape[:-1] + (x.shape[-1] // 2, 2))
    return v[..., 0].contiguous(), v[..., 1].contiguous()


def interleave(ev, od):
    if ev.device.type == "cpu":
        return interleave_plain(ev, od)
    _check_halves("interleave", ev, od)
    _build.require_cuda("interleave", ev, od)
    out = ev.new_empty(ev.shape[:-1] + (2 * ev.shape[-1],))
    rc = _build.library().cvvdp_interleave(ev.data_ptr(), od.data_ptr(), out.data_ptr(),
                                           ev.numel(), _build.stream_handle(ev.device))
    _build.check_cuda(rc, "cvvdp_interleave")
    interleave.launches += 1
    return out


interleave.launches = 0


def concat(ev, od):
    if ev.device.type == "cpu":
        return concat_plain(ev, od)
    _check_halves("concat", ev, od)
    _build.require_cuda("concat", ev, od)
    wh = ev.shape[-1]
    out = ev.new_empty(ev.shape[:-1] + (2 * wh,))
    rc = _build.library().cvvdp_concat(ev.data_ptr(), od.data_ptr(), out.data_ptr(),
                                       ev.numel() // wh, wh, _build.stream_handle(ev.device))
    _build.check_cuda(rc, "cvvdp_concat")
    concat.launches += 1
    return out


concat.launches = 0


def deinterleave(x):
    if x.device.type == "cpu":
        return deinterleave_plain(x)
    if x.shape[-1] % 2:
        raise ValueError(f"deinterleave: odd width {x.shape[-1]}")
    _build.require_cuda("deinterleave", x)
    half = x.shape[:-1] + (x.shape[-1] // 2,)
    ev, od = x.new_empty(half), x.new_empty(half)
    rc = _build.library().cvvdp_deinterleave(x.data_ptr(), ev.data_ptr(), od.data_ptr(),
                                             ev.numel(), _build.stream_handle(x.device))
    _build.check_cuda(rc, "cvvdp_deinterleave")
    deinterleave.launches += 1
    return ev, od


deinterleave.launches = 0


def library_interleave(ev, od):
    """The one PyTorch call that computes ``interleave`` (a yardstick)."""
    return torch.stack((ev, od), dim=-1).reshape(ev.shape[:-1] + (2 * ev.shape[-1],))


def library_concat(ev, od):
    return torch.cat((ev, od), dim=-1)


def library_deinterleave(x):
    return x[..., 0::2].contiguous(), x[..., 1::2].contiguous()
