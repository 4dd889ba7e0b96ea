"""Bytes and operations of ColorVideoVDP-ML-Transformer, from shapes alone.

The counts follow the plain reference (``perfbench/reference/
cvvdp_ml_ref.py``) under the rules of ``perfbench/work/__init__.py``, whose
functions give the stages the two metrics share (``ingest``, ``reduce``,
``levels``, ``band_ops_per_pixel``): an operation is one arithmetic result of
one element (a multiply-add is 2), a transcendental function counts 1,
each input of a stage is read once and each output written once. They do
not depend on how a program implements the head (fused attention, other
GEMM tilings): a lower count than any implementation performs.

Stages: the ingest and the reduce as ``cvvdp``'s; each interior band's
CSF and masking as the pooled path's band less its pooling, with S|T| and
S|R| formed (an abs and a product each) and S|T|, S|R| and D written; the
baseband's contrast, |T - R| S, S|T| and S|R|; the six tile statistics of
every band; the head: sqrt(|var|) of the input, the patch embedding, per
encoder layer two LayerNorms (7 a value), the Q, K and V products, the
attention's scores, scale, softmax (exp, sum, divide: 3 a score) and
weighted sum, the output projection, the MLP with exact GELU (5 a value)
and the residual adds, then the class token's LayerNorm, Linear and ReLU.

``pipeline`` sums the operations of every stage; its bytes are only the
raw frames read once and the deltas written once, since the stages in
between need not reach memory.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import BLUR_SKIP, F32, Shape, band_ops_per_pixel, ingest, levels, reduce

POOL_OPS = 4  # a channel: ``band_ops_per_pixel``'s pooling terms
LN_OPS, GELU_OPS, SOFTMAX_OPS = 7, 5, 3


@dataclass(frozen=True)
class Head:
    """The regression transformer: token features, width, layers, heads,
    MLP width."""
    in_features: int = 24
    dim: int = 256
    depth: int = 4
    heads: int = 8
    mlp: int = 1024


def tiles(s: Shape):
    """(h', w') of each band's tile grid, tiles of ceil(ppd) pixels."""
    fs = math.ceil(s.ppd)
    return [(-(-h // fs), -(-w // fs)) for h, w in levels(s)]


def bands(s: Shape):
    """[(ops, bytes)] of each interior band: the expand as ``work.bands``,
    the band's operations less the pooling, S|T| and S|R| formed (4 a
    channel); levels read, S|T|, S|R| and D written."""
    lv = levels(s)
    C = s.channels
    planes = s.B * s.F * 2 * C
    out = []
    for (h, w), (hn, wn) in zip(lv[:-2], lv[1:-1]):
        blurred = h > BLUR_SKIP and w > BLUR_SKIP
        px = s.B * s.F * h * w
        ops = planes * 4 * (h * wn + h * w) + px * (band_ops_per_pixel(C, blurred)
                                                    - POOL_OPS * C + 4 * C)
        byt = planes * F32 * (h * w + hn * wn) + px * 3 * C * F32
        out.append((ops, byt))
    return out


def baseband(s: Shape):
    """The mean adaptation (2 a pixel), the contrast (4 a plane), |T - R| S
    (3 a channel), S|T| and S|R| (4 a channel); the level read, the three
    written."""
    h, w = levels(s)[-1]
    px = s.B * s.F * h * w
    C = s.channels
    return px * (2 + 4 * 2 * C + 7 * C), px * (2 * C + 3 * C) * F32


def statistics(s: Shape):
    """Per band, of S|T|, S|R| and D of each channel: the square and the two
    sums a pixel (3), then a tile's two divides, square and subtract (4);
    the three read, six statistics a tile and channel written."""
    C = s.channels
    ops = byt = 0
    for (h, w), (th, tw) in zip(levels(s), tiles(s)):
        ops += s.B * s.F * 3 * C * (3 * h * w + 4 * th * tw)
        byt += s.B * s.F * C * F32 * (3 * h * w + 6 * th * tw)
    return ops, byt


def head(s: Shape, m: Head):
    """The head on every band: per token of a band with L tokens a frame
    (its tiles and the class token), per layer 2 LayerNorms, the Q, K, V
    and output products (8 dim^2 + 4 dim with biases), scores and weighted
    sum (4 L dim), scale and softmax (4 L a head), the MLP (4 dim mlp +
    mlp + dim, GELU on mlp), two residual adds; the input's sqrt(|var|) (2
    a variance) and the patch embedding (2 in dim + dim) per tile; the
    class token's LayerNorm, Linear (2 dim + 1) and ReLU. Bytes: the
    statistics read, the weights read once, the deltas written."""
    D = m.dim
    ops = byt = 0
    for th, tw in tiles(s):
        n, L = s.B * s.F, th * tw + 1
        per_token = (2 * LN_OPS * D + 8 * D * D + 4 * D + 4 * L * D
                     + (1 + SOFTMAX_OPS) * L * m.heads
                     + 4 * D * m.mlp + m.mlp + D + GELU_OPS * m.mlp + 2 * D)
        per_tile = 2 * 3 * 4 + 2 * m.in_features * D + D
        ops += n * (L * m.depth * per_token + (L - 1) * per_tile + LN_OPS * D + 2 * D + 2)
        byt += n * (L - 1) * s.channels * 6 * F32
    weights = D * (m.in_features + 1) + D + m.depth * (4 * D * D + 4 * D + 2 * D * m.mlp
                                                       + m.mlp + D + 4 * D) + 3 * D + 1
    return ops, byt + weights * F32 + s.B * len(levels(s)) * F32


def stage_counts(s: Shape, m: Head):
    """{stage: (ops, bytes)} of one call."""
    b = bands(s)
    return {"ingest": ingest(s), "reduce": reduce(s),
            "band": (sum(o for o, _ in b), sum(y for _, y in b)), "baseband": baseband(s),
            "statistics": statistics(s), "head": head(s, m)}


def pipeline(s: Shape, m: Head):
    """(ops, bytes) of the whole algorithm: every stage's operations; bytes
    of the raw frames read once and of the deltas written once."""
    ops = sum(o for o, _ in stage_counts(s, m).values())
    return ops, s.B * s.F * s.H * s.W * 3 * s.sample_bytes * 2 + s.B * len(levels(s)) * F32
