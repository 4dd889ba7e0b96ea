"""Plain PyTorch ColorVideoVDP-ML-Transformer: the benchmark's reference for
the learned metric.

Upstream: gfxdisp/ColorVideoVDP ``pycvvdp/cvvdp_ml_metric.py``,
``cvvdp_ml_transformer`` and its head ``RegressionTransformer``, with the
parameters of ``vvdp_data/cvvdp_ml_transformer/cvvdp_parameters.json``
(30/05/2025; this file's copy: ``data/cvvdp_ml_transformer_parameters.json``).

The trunk is ColorVideoVDP's up to the masking: the display model, the four
temporal channels (replicate padding: frame 0 stands in for the frames
before the clip), the Laplacian pyramid with ``weber_g1`` contrast, the
castleCSF lookup table, ``mult-mutual`` masking with the cross-channel mix
and the soft clamp on the interior bands, and |T - R| S on the baseband.
Those steps are ``cvvdp_ref.py``'s, imported (``CVVDPReference.band_D`` for
an interior band's D). Each band is then pooled into six statistics per
tile of ceil(ppd) pixels: the mean and the variance E[x^2] - m^2 of S|T|,
S|R| and D, edge tiles clipped to the band and divided by their own sample
count. The head takes the means and sqrt(|var|) of the variances (an image
gains a zero fourth channel), 24 features a tile, as tokens; a class token
is prepended per band and frame, four pre-norm encoder layers (8 heads,
MLP 4 x dim, exact GELU, LayerNorm eps 1e-5) run, and the class token's
output goes through LayerNorm, Linear and ReLU and is averaged over the
frames. Band b's delta is that output / bands (the baseband's times
``baseband_weight``, an image's times ``image_int``), and the JOD is 10 less
the sum of the deltas.

Departures from upstream: attention, LayerNorm and GELU are written out
(``torch.matmul``, ``softmax``, ``erf``) where upstream calls
``nn.TransformerEncoderLayer``, whose fused fast path rounds otherwise; the
tile sums are taken tile by tile (a zero-padded reshape) where upstream
calls ``AvgPool2d(ceil_mode=True)``, the same values in exact arithmetic;
videos are scored in blocks of frames, the temporal filter's fl - 1 frames
carried between blocks, so that a 4K clip fits beside the program.

It imports nothing of the measured program. Arithmetic is in ``dtype``,
float32 by default; this file multiplies matrices, so both TF32 switches
are set False around every call (and restored), else the card would round
the products to TF32. ``dtype=torch.bfloat16`` computes every step in
bfloat16: the benchmark's control of a lower precision.

``seeded_weights`` is the rule by which the benchmark draws the head's
weights from a seed (the published checkpoint is not in the repository).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .cvvdp_ref import (RHO_BASEBAND, CVVDPReference, _json, band_freqs, clip, expand,
                        reduce, temporal_filters)

PARAMETERS = "cvvdp_ml_transformer_parameters.json"
# Keys of the ML parameters that the trunk does not read.
HEAD_KEYS = ("version", "__comment", "calibration_date", "internal_model_name",
             "baseband_weight", "image_int")


@contextlib.contextmanager
def full_float32():
    """Both TF32 switches False inside, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def seeded_weights(seed, in_channels=24, dim=256, depth=4, reg_bias=0.0, net="transformer_net"):
    """The head's weights drawn from ``seed``, flat in the checkpoint's layout
    (``"<net>.<key>"``: float32 numpy arrays): Linear weights uniform in
    +-1/sqrt(fan_in), biases 0, the class token standard normal, LayerNorms
    1 and 0; ``reg_head``'s bias ``reg_bias``. Keys are drawn in sorted order
    from one numpy generator seeded with ``seed``."""
    shapes = {"cls_token": (1, 1, dim), "patch_embed.1.weight": (dim, in_channels),
              "patch_embed.1.bias": (dim,), "reg_head.0.weight": (dim,),
              "reg_head.0.bias": (dim,), "reg_head.1.weight": (1, dim),
              "reg_head.1.bias": (1,)}
    for i in range(depth):
        pre = f"transformer.layers.{i}."
        shapes.update({pre + "self_attn.in_proj_weight": (3 * dim, dim),
                       pre + "self_attn.in_proj_bias": (3 * dim,),
                       pre + "self_attn.out_proj.weight": (dim, dim),
                       pre + "self_attn.out_proj.bias": (dim,),
                       pre + "linear1.weight": (4 * dim, dim), pre + "linear1.bias": (4 * dim,),
                       pre + "linear2.weight": (dim, 4 * dim), pre + "linear2.bias": (dim,),
                       pre + "norm1.weight": (dim,), pre + "norm1.bias": (dim,),
                       pre + "norm2.weight": (dim,), pre + "norm2.bias": (dim,)})
    rng = np.random.default_rng([int(seed) % (1 << 63), 17])
    out = {}
    for key in sorted(shapes):
        shape = shapes[key]
        if key == "cls_token":
            v = rng.standard_normal(shape)
        elif len(shape) == 2:
            b = 1.0 / math.sqrt(shape[1])
            v = rng.uniform(-b, b, shape)
        elif "norm" in key or key.startswith("reg_head.0."):
            v = np.full(shape, 1.0 if key.endswith("weight") else 0.0)
        elif key == "reg_head.1.bias":
            v = np.full(shape, reg_bias)
        else:
            v = np.zeros(shape)
        out[f"{net}.{key}"] = v.astype(np.float32)
    return out


def tile_stats(x, fs):
    """(mean, E[x^2] - mean^2) of (..., H, W) over fs x fs tiles, the edge
    tiles clipped to the band: (..., ceil(H / fs), ceil(W / fs)) each."""
    H, W = x.shape[-2:]
    oh, ow = -(-H // fs), -(-W // fs)
    ch = np.minimum(np.arange(1, oh + 1) * fs, H) - np.arange(oh) * fs
    cw = np.minimum(np.arange(1, ow + 1) * fs, W) - np.arange(ow) * fs
    count = torch.as_tensor(np.outer(ch, cw).astype(np.float32), device=x.device).to(x.dtype)

    def mean(y):
        y = torch.nn.functional.pad(y, (0, ow * fs - W, 0, oh * fs - H))
        return y.reshape(tuple(x.shape[:-2]) + (oh, fs, ow, fs)).sum(dim=(-3, -1)) / count

    m = mean(x)
    return m, mean(x * x) - m * m


def _linear(x, w, b):
    return torch.matmul(x, w.t()) + b


def _layer_norm(x, w, b, eps=1e-5):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) * (x - m)).mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * w + b


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


class RegressionTransformer:
    """The head on tokens (N, L, 24) -> (N,): the flat weights in ``dtype``
    on ``device``."""

    def __init__(self, flat, device, dtype, heads=8, net="transformer_net"):
        self.w = {k[len(net) + 1:]: torch.as_tensor(np.asarray(v, np.float32), device=device)
                  .to(dtype) for k, v in flat.items() if k.startswith(net + ".")}
        self.heads = heads
        self.depth = sum(1 for k in self.w if k.endswith(".linear1.weight"))

    def attention(self, x, pre):
        w = self.w
        N, L, D = x.shape
        dh = D // self.heads
        qkv = _linear(x, w[pre + "in_proj_weight"], w[pre + "in_proj_bias"])
        q, k, v = (a.reshape(N, L, self.heads, dh).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
        a = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        out = torch.matmul(a, v).transpose(1, 2).reshape(N, L, D)
        return _linear(out, w[pre + "out_proj.weight"], w[pre + "out_proj.bias"])

    def __call__(self, tokens):
        w = self.w
        x = _linear(tokens, w["patch_embed.1.weight"], w["patch_embed.1.bias"])
        x = torch.cat([w["cls_token"].expand(x.shape[0], 1, -1), x], dim=1)
        for i in range(self.depth):
            p = f"transformer.layers.{i}."
            x = x + self.attention(_layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"]),
                                   p + "self_attn.")
            h = _layer_norm(x, w[p + "norm2.weight"], w[p + "norm2.bias"])
            h = _linear(_gelu(_linear(h, w[p + "linear1.weight"], w[p + "linear1.bias"])),
                        w[p + "linear2.weight"], w[p + "linear2.bias"])
            x = x + h
        y = _layer_norm(x[:, 0], w["reg_head.0.weight"], w["reg_head.0.bias"])
        return torch.relu(_linear(y, w["reg_head.1.weight"], w["reg_head.1.bias"]))[:, 0]


def channel_blocks(base, test, ref, dim_order, fps, blk):
    """(frames, R) of each block of at most ``blk`` frames of a video pair of
    host arrays: R (1, 8, frames, H, W), the four temporal channels of the
    test (even) and the reference (odd) in DKL cd/m^2, frame 0 replicated
    before the clip and the filter's fl - 1 frames carried between blocks.
    ``base`` (a ``CVVDPReference``) gives the display model and the
    parameters."""
    order = dim_order.upper()
    N = test.shape[order.index("F")]
    H, W = test.shape[order.index("H")], test.shape[order.index("W")]
    filt = base._t(temporal_filters(fps, base.p["sigma_tf"], base.p["beta_tf"])[:, ::-1].copy())
    fl = filt.shape[1]
    tails = [None, None]
    for f0 in range(0, N, blk):
        f1 = min(N, f0 + blk)
        chans = []
        for s, a in enumerate((test, ref)):
            new = base.to_dkl(base._frames(a, dim_order, f0, f1))
            if tails[s] is None:
                tails[s] = new[:, :, :1].expand(-1, -1, fl - 1, -1, -1)
            buf = torch.cat([tails[s], new], dim=2)
            tails[s] = buf[:, :, f1 - f0:].contiguous()
            buf4 = torch.cat([buf, buf[:, 0:1]], dim=1)
            out = None
            for t in range(fl):
                term = buf4[:, :, t:t + f1 - f0] * filt[:, t].reshape(1, 4, 1, 1, 1)
                out = term if out is None else out + term
            chans.append(out)
            del new, buf, buf4
        yield f1 - f0, torch.stack(chans, dim=2).reshape(1, 8, f1 - f0, H, W)
        del chans


class CVVDPMLReference:
    """ColorVideoVDP-ML-Transformer of one display with the head weights
    ``flat`` (``seeded_weights``' layout) on ``device``, in ``dtype``."""

    def __init__(self, display_name, flat, device="cpu", dtype=torch.float32, heads=8,
                 block_pixels=1 << 28):
        self.base = CVVDPReference(display_name, device=device, dtype=dtype,
                                   block_pixels=block_pixels)
        p = _json(PARAMETERS)
        trunk = {k: v for k, v in p.items() if k not in HEAD_KEYS}
        if any(self.base.p.get(k) != v for k, v in trunk.items()):
            raise ValueError("the ML parameters' trunk differs from the default configuration")
        self.baseband_weight = float(np.asarray(p["baseband_weight"]).reshape(-1)[0])
        self.image_int = float(p["image_int"])
        self.head = RegressionTransformer(flat, device, dtype, heads)
        self.fs = math.ceil(self.base.display.ppd)

    def band_features(self, levels, freqs):
        """Per band, the tile statistics (B, F, h', w', C, 6): mean and
        variance of S|T|, S|R| and D, of one block's Gaussian levels."""
        b = self.base
        out = []
        for i in range(len(freqs) - 1):
            gi, gn = levels[i], levels[i + 1]
            mul = 1.0 if i == 0 else 2.0
            E = expand(gn, gi.shape[-2:])
            L_t, L_r = clip(E[:, 0:1], 0.01), clip(E[:, 1:2], 0.01)
            T = clip((gi[:, 0::2] - E[:, 0::2]) / L_t, hi=1000.0) * mul
            R = clip((gi[:, 1::2] - E[:, 1::2]) / L_r, hi=1000.0) * mul
            del E
            S = b.csf(torch.log10(L_r[:, 0]), b.csf_rows(freqs[i], T.shape[1])).movedim(0, 1) \
                * b.sens_corr
            D = b.band_D(gi, gn, freqs[i], mul)
            out.append(self._stats(torch.abs(T) * S, torch.abs(R) * S, D))
            del T, R, S, D
        g = levels[-1]
        L_bkg = torch.mean(clip(g[:, 0:2], 0.01), dim=(-1, -2), keepdim=True)
        T = clip(g[:, 0::2] / L_bkg[:, 0:1], hi=1000.0)
        R = clip(g[:, 1::2] / L_bkg[:, 1:2], hi=1000.0)
        S = b.csf(torch.log10(L_bkg[:, 1]), b.csf_rows(RHO_BASEBAND, T.shape[1])).movedim(0, 1) \
            * b.sens_corr
        out.append(self._stats(torch.abs(T) * S, torch.abs(R) * S, torch.abs(T - R) * S))
        return out

    def _stats(self, T, R, D):
        st = []
        for x in (T, R, D):
            st += list(tile_stats(x, self.fs))
        # (B, C, F, h', w', 6) -> (B, F, h', w', C, 6)
        return torch.stack(st, dim=-1).permute(0, 2, 3, 4, 1, 5)

    def deltas(self, features):
        """Each band's delta (B,) from its tile statistics."""
        is_image = features[0].shape[4] == 3
        out = []
        for bb, f in enumerate(features):
            f = torch.stack([f[..., 0::2], torch.sqrt(torch.abs(f[..., 1::2]))], dim=-1).flatten(-2)
            if is_image:
                f = torch.cat([f, f.new_zeros(f.shape[:4] + (1, 6))], dim=4)
            B, F, h, w = f.shape[:4]
            tokens = torch.cat([f[..., 0:4].reshape(B, F, h, w, -1),
                                f[..., 4:].reshape(B, F, h, w, -1)], dim=-1)
            y = self.head(tokens.reshape(B * F, h * w, -1)).reshape(B, F).mean(dim=1)
            d = y / len(features)
            if bb == len(features) - 1:
                d = d * self.baseband_weight
            if is_image:
                d = d * self.image_int
            out.append(d)
        return out

    @torch.no_grad()
    def score(self, test, ref, dim_order, fps=0.0):
        """(JOD, deltas (bands,) float32) of a test/reference pair of host
        arrays laid out as ``dim_order`` (as ``CVVDPReference.score``)."""
        with full_float32():
            b = self.base
            order = dim_order.upper()
            N = test.shape[order.index("F")] if "F" in order else 1
            H, W = test.shape[order.index("H")], test.shape[order.index("W")]
            freqs = band_freqs(W, H, b.display.ppd)
            if N == 1:
                T, R = (b.to_dkl(b._frames(a, dim_order, 0, 1)) for a in (test, ref))
                blocks = [(1, torch.stack([T, R], dim=2).reshape(1, 6, 1, H, W))]
            else:
                blocks = channel_blocks(b, test, ref, dim_order, fps,
                                        max(1, b.block_pixels // (H * W * 8)))
            feats = []
            for _, R in blocks:
                levels = [R]
                for _ in range(len(freqs) - 1):
                    levels.append(reduce(levels[-1]))
                del R
                feats.append(self.band_features(levels, freqs))
                del levels
            features = [torch.cat(f, dim=1) for f in zip(*feats)]
            deltas = self.deltas(features)
            jod = 10.0
            for d in deltas:
                jod = jod - d
            return float(jod[0]), torch.stack(deltas, dim=-1)[0].float().cpu().numpy()

