"""Bytes and operations of the ColorVideoVDP algorithm, from shapes alone.

The counts follow the algorithm of the plain reference (``perfbench/
reference/cvvdp_ref.py``), not any implementation of it: they do not change
when a program splits, fuses or reorders its kernels. Rules:

* An operation is one arithmetic result of one element: an add, subtract,
  multiply, divide, min, max, abs, compare-and-select, floor, square root,
  power, exponential or logarithm each counts 1. So a table lookup counts its
  index arithmetic and its lerp, and a transcendental function counts 1 (a
  lower count than any implementation issues, never a higher one).
* Bytes count each input of a stage read once and each output written once,
  in float32 unless the stage's input is the raw frames (1 or 2 bytes a
  sample); what an implementation reads again or keeps in between is not
  counted.
* Edge corrections of the pyramid and reflections of the blur are left out
  (a few rows per plane).
* The least time of a stage is the larger of its operations over the peak
  float32 rate and its bytes over the peak memory bandwidth: the published
  figures of one NVIDIA H100 SXM, 67 TFLOP/s outside the tensor cores and
  3.35 TB/s.

``Shape`` describes one call's work: B pairs of F frames of H x W pixels,
with ``channels`` = 4 for a video (three sustained channels and the
transient one) or 3 for an image, ``fl`` temporal taps (0 for an image),
``sample_bytes`` per raw sample, the display's EOTF and its ``ppd``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..reference.cvvdp_ref import band_freqs

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4

# Operations per sample of each EOTF from display-encoded [0, 1] to cd/m^2,
# the dtype's scaling included: sRGB (clip 2, compare-select 1, the two
# branches' 5, the gain and the two offsets 3) and PQ (clip 2, two powers 2,
# the rational part 5, the scale 1, the clip 2, the offsets 2).
EOTF_OPS = {"sRGB": 1 + 11, "PQ": 1 + 14}
# The blur taps of the phase uncertainty (pu_dilate 3: 13 taps) and the band
# size at or below which it is skipped.
BLUR_TAPS, BLUR_SKIP = 13, 6


@dataclass(frozen=True)
class Shape:
    B: int
    F: int
    H: int
    W: int
    channels: int
    fl: int
    sample_bytes: int
    eotf: str
    ppd: float


def levels(s: Shape):
    """(h, w) of every Gaussian level, the baseband's last."""
    out, h, w = [], s.H, s.W
    for _ in range(len(band_freqs(s.W, s.H, s.ppd))):
        out.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return out


def ingest(s: Shape):
    """Raw frames -> the interleaved channels (B, 2C, F, H, W): the EOTF of
    three samples, the 3x3 colour matrix (15), and for a video the four
    temporal filters of fl taps (4 (2 fl - 1)), per pixel of each side."""
    px = s.B * s.F * s.H * s.W * 2
    per = 3 * EOTF_OPS[s.eotf] + 15 + (4 * (2 * s.fl - 1) if s.fl else 0)
    return px * per, px * 3 * s.sample_bytes + px * s.channels * F32


def reduce(s: Shape):
    """Every reduce of the pyramid: a 5-tap pass (9) down the rows at the
    output's height and full width, then along them at the output's size, on
    the 2C planes."""
    ops = byt = 0
    lv = levels(s)
    planes = s.B * s.F * 2 * s.channels
    for (h, w), (h2, w2) in zip(lv[:-1], lv[1:]):
        ops += planes * 9 * (h2 * w + h2 * w2)
        byt += planes * F32 * (h * w + h2 * w2)
    return ops, byt


def band_ops_per_pixel(C: int, blurred: bool) -> int:
    """Operations per pixel of an interior band of C channels, its expand
    left out (``bands`` counts it): the Weber contrast (2 clips, then 4 per
    plane: subtract, divide, clip, gain), the log of the adaptation field
    (1), the CSF lookup (index 5, then 5 per channel), the sensitivity
    correction (C), the channel gains (4C),
    the masking input and the difference (5C), the 13-tap blur (2 x 25 per
    channel) and its scale (C), the masking power (4C), the cross-channel
    mix (C (2C - 1)), the masked difference (5C), the soft clamp (3C) and the
    pooling terms (4C)."""
    ops = 2 + 4 * 2 * C + 1 + 5 + 5 * C + C + 4 * C + 5 * C
    if blurred:
        ops += 2 * (2 * BLUR_TAPS - 1) * C
    ops += C + 4 * C + C * (2 * C - 1) + 5 * C + 3 * C + 4 * C
    return ops


def bands(s: Shape):
    """[(ops, bytes)] of each interior band: the expand of the next level to
    the band's size (4 a sample a pass, down the rows at the next level's
    width, then along them, on the 2C planes), then ``band_ops_per_pixel``;
    its level and the next one read once, the (B, C, F) sums written once."""
    lv = levels(s)
    out = []
    planes = s.B * s.F * 2 * s.channels
    for (h, w), (hn, wn) in zip(lv[:-2], lv[1:-1]):
        blurred = h > BLUR_SKIP and w > BLUR_SKIP
        ops = (planes * 4 * (h * wn + h * w)
               + s.B * s.F * h * w * band_ops_per_pixel(s.channels, blurred))
        byt = planes * F32 * (h * w + hn * wn) + s.B * s.channels * s.F * F32
        out.append((ops, byt))
    return out


def band(s: Shape):
    """The band stage: every interior band."""
    b = bands(s)
    return sum(o for o, _ in b), sum(y for _, y in b)


def baseband(s: Shape):
    """The baseband: the mean adaptation (2 a pixel), the contrast (4 a
    plane), the CSF at one field value, the difference and its pooling (8 a
    channel), on the last level."""
    h, w = levels(s)[-1]
    px = s.B * s.F * h * w
    return px * (2 + 4 * 2 * s.channels + 8 * s.channels), px * 2 * s.channels * F32


def pooling(s: Shape):
    """The per-band norms' tails and the pooling over bands, channels and
    frames to one JOD a pair: about 12 operations per (channel, frame,
    band), the (B, C, F, bands) Q read once."""
    n = s.B * s.channels * s.F * len(levels(s))
    return 12 * n, n * F32


STAGES = {"ingest": ingest, "reduce": reduce, "band": band, "baseband": baseband,
          "pooling": pooling}


def stage_counts(s: Shape):
    """{stage: (ops, bytes)} of one call."""
    return {name: fn(s) for name, fn in STAGES.items()}


def pipeline(s: Shape):
    """(ops, bytes) of the whole algorithm: every stage's operations; bytes
    only of the raw frames read once and of Q_per_ch written once, since the
    stages in between need not reach memory at all."""
    ops = sum(o for o, _ in stage_counts(s).values())
    byt = s.B * s.F * s.H * s.W * 3 * s.sample_bytes * 2 \
        + s.B * s.channels * s.F * len(levels(s)) * F32
    return ops, byt


def least_seconds(ops: float, byt: float) -> float:
    return max(ops / PEAK_FLOPS, byt / PEAK_BYTES)
