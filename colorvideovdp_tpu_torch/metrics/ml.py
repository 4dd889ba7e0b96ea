"""ColorVideoVDP-ML metrics on PyTorch: the cvvdp feature trunk plus learned
regressors.

Counterpart of ``colorvideovdp_tpu/metrics/ml.py``. The trunk is the cvvdp
band loop, but every band is pooled into per-tile statistics (the mean and
variance of S|T|, S|R| and D over ~1-visual-degree tiles,
``ops/feature_pooling.py``) instead of p-norms; the heads are an MLP gated by
a saliency MLP (``cvvdp_ml_saliency``) or a ViT-style regression transformer
(``cvvdp_ml_transformer``). Videos stream through the ingest kernel as in
``cvvdp``, but the first block forms its temporal padding inside the kernel
(``ingest_replicate`` for replicate padding, ``ingest_head`` from the raw
mirror-indexed head frames for symmetric padding), as the JAX package's
first-block step does; later blocks carry tails (``ingest``). The bands go
through the CSF LUT kernel and ``masking.apply_masking_model`` (the blur
kernel inside); the networks are plain ``torch.matmul`` products, as the JAX
package leaves them to XLA. Each band's head output, what the JOD loses to
the band, comes back as ``stats["delta_per_band"]`` (B, bands), read back
with the JOD.

Blocks are sized by ``cvvdp.estimate_block_N`` with the trunk's own memory
model (``cvvdp_ml_base.mem_model``, measured on an H100), counting the
memory the caching allocator holds unused as free. Spans (``utils/
spans.py``): ``cvvdp.block`` with ``cvvdp.ingest``, ``cvvdp.pyramid`` and
``cvvdp.bands`` inside, then ``cvvdp.ml.head`` (counts ``tokens``, the
tokens through the head with the class tokens, and ``bands``) and
``cvvdp.readback``.

Weights: the published checkpoints are not in the repository. They are read
from a ``cvvdp_ml.npz`` in the checkpoint's flat key layout
(``"<net>.<key>"``, ``tools/cvvdp_ml_manifest.json`` of this package),
searched on ``config_paths``, the family's directory
``vvdp_data/cvvdp_ml_{saliency,transformer}/``, ``$CVVDP_PATH`` and
``vvdp_data/``; ``python -m colorvideovdp_tpu_torch.tools.convert_ml_ckpt
cvvdp.ckpt cvvdp_ml.npz`` writes one from a torch checkpoint.
``random_init=True`` runs with random weights instead.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import masking as mk
from ..ops.feature_pooling import feature_pooling
from ..ops.kernels import ingest as ing
from ..ops.pyramid import LaplacianPyramid
from ..ops.temporal import get_temporal_filters
from ..utils import spans
from ..utils.config import VVDP_DATA, config_files
from .base import no_tf32, register_metric, vq_exception
from .cvvdp import cvvdp

# ---------------------------------------------------------------------------
# Networks, in the published checkpoints' module layout


class MLP(nn.Sequential):
    """``torchvision.ops.MLP``'s layout: Linear, ReLU, Dropout per hidden
    layer, then the last Linear, so that the state-dict keys are ``0.``,
    ``3.``, ``6.``, ... Dropout is the identity in eval mode."""

    def __init__(self, in_ch, hidden, dropout=0.2, device=None):
        dims = [in_ch] + list(hidden)
        layers = []
        for i in range(len(hidden)):
            layers.append(nn.Linear(dims[i], dims[i + 1], device=device))
            if i < len(hidden) - 1:
                layers += [nn.ReLU(), nn.Dropout(dropout)]
        super().__init__(*layers)

    def linears(self):
        return [m for m in self if isinstance(m, nn.Linear)]


class SelfAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch first) self-attention in eval mode,
    written out with ``torch.matmul`` and ``softmax`` as the JAX package's
    ``_mha`` does (the library module's fast path takes fused kernels with
    other numerics)."""

    def __init__(self, dim, heads, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim, device=device))
        self.out_proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        B, N, D = x.shape
        dh = D // self.heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (a.reshape(B, N, self.heads, dh).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
        att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).reshape(B, N, D)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer`` with ``norm_first=True``, exact GELU and
    LayerNorm eps 1e-5, in eval mode."""

    def __init__(self, dim, heads, device=None):
        super().__init__()
        self.self_attn = SelfAttention(dim, heads, device=device)
        self.linear1 = nn.Linear(dim, 4 * dim, device=device)
        self.linear2 = nn.Linear(4 * dim, dim, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)

    def forward(self, x):
        x = x + self.self_attn(self.norm1(x))
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


class _Encoder(nn.Module):
    def __init__(self, dim, heads, depth, device=None):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(dim, heads, device=device) for _ in range(depth))


class RegressionTransformer(nn.Module):
    """The ViT-style regressor: per-tile features (B, frames, h, w, C) are
    tokens, a class token is prepended, and its output is regressed through
    LayerNorm, Linear and ReLU, then averaged over the frames -> (B,)."""

    def __init__(self, in_channels=24, dim=256, depth=4, heads=8, device=None):
        super().__init__()
        self.patch_embed = nn.Sequential(nn.Identity(), nn.Linear(in_channels, dim, device=device))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, device=device))
        self.transformer = _Encoder(dim, heads, depth, device=device)
        self.reg_head = nn.Sequential(nn.LayerNorm(dim, eps=1e-5, device=device),
                                      nn.Linear(dim, 1, device=device), nn.ReLU())

    def forward(self, x):
        B, D, H, W, C = x.shape
        x = self.patch_embed(x.reshape(B * D, H * W, C))
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], dim=1)
        for layer in self.transformer.layers:
            x = layer(x)
        return self.reg_head(x[:, 0]).reshape(B, D).mean(dim=1)


def _uniform(t, bound, gen):
    t.copy_(torch.rand(t.shape, generator=gen) * (2.0 * bound) - bound)


def _init_linear(lin, gen):
    _uniform(lin.weight, 1.0 / math.sqrt(lin.in_features), gen)
    lin.bias.zero_()


@torch.no_grad()
def _random_init(net, seed):
    """The JAX package's distributions (``mlp_init``, ``transformer_init``):
    weights uniform in +-1/sqrt(fan_in), biases 0, the class token standard
    normal, LayerNorms 1 and 0, drawn from a ``torch.Generator`` seeded with
    ``seed``. The numbers differ from those of JAX's ``PRNGKey(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    if isinstance(net, MLP):
        for lin in net.linears():
            _init_linear(lin, gen)
        return
    _init_linear(net.patch_embed[1], gen)
    net.cls_token.copy_(torch.randn(net.cls_token.shape, generator=gen))
    norms = [net.reg_head[0]]
    for layer in net.transformer.layers:
        att = layer.self_attn
        _uniform(att.in_proj_weight, 1.0 / math.sqrt(att.in_proj_weight.shape[1]), gen)
        att.in_proj_bias.zero_()
        for lin in (att.out_proj, layer.linear1, layer.linear2):
            _init_linear(lin, gen)
        norms += [layer.norm1, layer.norm2]
    for norm in norms:
        norm.weight.fill_(1.0)
        norm.bias.zero_()
    _init_linear(net.reg_head[1], gen)


# ---------------------------------------------------------------------------
# Checkpoint loading: the JAX package's parsers and messages
# (``colorvideovdp_tpu/metrics/ml.py:159-289``), on numpy arrays.


def _split_nets(flat, net_names):
    """Flat "<net>.<key>" arrays -> {net: {key: array}}."""
    return {net: {k[len(net) + 1:]: np.asarray(v) for k, v in flat.items()
                  if k.startswith(net + ".")} for net in net_names}


def _load_npz_weights(config_paths):
    """The flat arrays of the first cvvdp_ml.npz on the search path."""
    npz_file = config_files.find("cvvdp_ml.npz", config_paths)
    with np.load(npz_file) as data:
        return {k: data[k] for k in data.files}


def _missing(net, key, flat):
    return vq_exception(
        f"cvvdp_ml checkpoint: net '{net}' is missing key '{key}'. The "
        "converted cvvdp_ml.npz does not match the reference architecture "
        "(reference builds these nets in cvvdp_ml_metric.py:399-644 and "
        "loads them by prefix in cvvdp_ml_metric.py:156-172). Keys present "
        f"under this net: {sorted(flat)[:10]}{'...' if len(flat) > 10 else ''}"
    )


def _check_consumed(net, flat, used):
    extra = sorted(set(flat) - used)
    if extra:
        raise vq_exception(
            f"cvvdp_ml checkpoint: net '{net}' has {len(extra)} unexpected "
            f"key(s) the loader would silently drop: {extra[:10]}"
            f"{'...' if len(extra) > 10 else ''}. This usually means the "
            "checkpoint was trained with a different architecture than the "
            "published one (cvvdp_ml_metric.py:399-644)."
        )


def _leaves(tree, path=""):
    """(path, shape) of every leaf, paths as ``jax.tree_util.keystr`` writes
    them ("[0]['weight']"), dict keys sorted as JAX flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tuple(tree.shape)


def _check_same_shapes(net, loaded, expected):
    got, want = dict(_leaves(loaded)), dict(_leaves(expected))
    bad = [f"{k}: ckpt {got.get(k)} vs expected {want.get(k)}"
           for k in sorted(set(got) | set(want)) if got.get(k) != want.get(k)]
    if bad:
        raise vq_exception(
            f"cvvdp_ml checkpoint: net '{net}' parameter shapes do not match "
            f"the published architecture: {bad[:8]}"
            f"{'...' if len(bad) > 8 else ''}"
        )


def _mlp_from_flat(flat, net="mlp"):
    """Flat torch-style keys ('0.weight', '3.weight', ...) -> layer list, in
    layer order. Every Linear index must carry exactly weight and bias, and
    no key under the net may go unconsumed."""
    idx = set()
    for k in flat:
        parts = k.split(".")
        if len(parts) < 2 or not parts[0].isdigit() or parts[1] not in ("weight", "bias"):
            raise vq_exception(
                f"cvvdp_ml checkpoint: net '{net}' has non-MLP key '{k}' "
                "(expected '<layer_idx>.weight'/'<layer_idx>.bias' from a "
                "torchvision.ops.MLP state_dict, cvvdp_ml_metric.py:412,476)"
            )
        idx.add(int(parts[0]))
    used, out = set(), []
    for i in sorted(idx):
        for part in ("weight", "bias"):
            if f"{i}.{part}" not in flat:
                raise _missing(net, f"{i}.{part}", flat)
            used.add(f"{i}.{part}")
        out.append({"weight": flat[f"{i}.weight"], "bias": flat[f"{i}.bias"]})
    if not out:
        raise _missing(net, "0.weight", flat)
    _check_consumed(net, flat, used)
    return out


def _transformer_from_flat(flat, depth=4, net="transformer_net"):
    used = set()

    def take(key):
        if key not in flat:
            raise _missing(net, key, flat)
        used.add(key)
        return flat[key]

    def lin(pre):
        return {"weight": take(pre + ".weight"), "bias": take(pre + ".bias")}

    p = {"patch_embed": lin("patch_embed.1"), "cls_token": take("cls_token"),
         "reg_norm": lin("reg_head.0"), "reg_linear": lin("reg_head.1"), "layers": []}
    for i in range(depth):
        pre = f"transformer.layers.{i}."
        p["layers"].append({
            "self_attn": {"in_proj_weight": take(pre + "self_attn.in_proj_weight"),
                          "in_proj_bias": take(pre + "self_attn.in_proj_bias"),
                          "out_proj": lin(pre + "self_attn.out_proj")},
            "linear1": lin(pre + "linear1"), "linear2": lin(pre + "linear2"),
            "norm1": lin(pre + "norm1"), "norm2": lin(pre + "norm2"),
        })
    _check_consumed(net, flat, used)
    return p


def _tree(net):
    """A network's parameters in the structure the parsers return."""
    def lin(m):
        return {"weight": m.weight, "bias": m.bias}

    if isinstance(net, MLP):
        return [lin(m) for m in net.linears()]
    return {"patch_embed": lin(net.patch_embed[1]), "cls_token": net.cls_token,
            "reg_norm": lin(net.reg_head[0]), "reg_linear": lin(net.reg_head[1]),
            "layers": [{"self_attn": {"in_proj_weight": layer.self_attn.in_proj_weight,
                                      "in_proj_bias": layer.self_attn.in_proj_bias,
                                      "out_proj": lin(layer.self_attn.out_proj)},
                        "linear1": lin(layer.linear1), "linear2": lin(layer.linear2),
                        "norm1": lin(layer.norm1), "norm2": lin(layer.norm2)}
                       for layer in net.transformer.layers]}


@torch.no_grad()
def _assign(tree, loaded):
    if isinstance(tree, dict):
        for k in tree:
            _assign(tree[k], loaded[k])
    elif isinstance(tree, list):
        for a, b in zip(tree, loaded):
            _assign(a, b)
    else:
        tree.copy_(torch.from_numpy(np.array(loaded, np.float32)))


# ---------------------------------------------------------------------------
# Metric classes


class cvvdp_ml_base(cvvdp):
    """The shared trunk: per-band tile statistics instead of pooled norms
    (JAX: ``cvvdp_ml_base``)."""

    # The family's directory under vvdp_data (its cvvdp_parameters.json).
    family = None
    # The trunk's memory model of a block (``cvvdp.estimate_block_N``),
    # from its peak on an H100 (4K, cvvdp_ml_transformer, blocks of 1 to 29
    # frames): 2.587 GB + 2.078 GB a frame, so b + c = 250.6 bytes a
    # pixel-frame and a = 1.53e9 beside the tails' b (fl - 1) term. c = 250
    # leaves 6% over the measured 234.6 for the caching allocator's rounding;
    # the reference metric's c = 320 held a 4K block to 29 frames.
    mem_model = (1.6e9, 16, 250)
    # The trunk takes no pooled route: its blocks follow ``mem_model`` on
    # every route.
    pooled_mem_model = None

    def __init__(self, random_init=False, disabled_features=None, **kwargs):
        self.random_init = random_init
        self.disabled_features = disabled_features
        kwargs["config_paths"] = (list(kwargs.get("config_paths") or [])
                                  + self._extra_config_paths())
        super().__init__(**kwargs)
        if self.do_heatmap:
            raise vq_exception("Currently cvvdp-ml metrics do not produce heatmaps")

    def _extra_config_paths(self):
        if self.family is None:
            return []
        base = os.path.join(VVDP_DATA, self.family)
        return [base] if os.path.isdir(base) else []

    def _build_nets(self) -> dict:
        """{net name: (module with uninitialised parameters, seed of its
        random initialisation)}."""
        raise NotImplementedError

    def get_nets_to_load(self):
        return list(self._build_nets())

    def load_config(self, config_paths=None):
        super().load_config(config_paths)
        for name, (net, seed) in self._build_nets().items():
            net = net.to_empty(device="cpu")
            _random_init(net, seed)
            setattr(self, name, net.to(self.device).eval().requires_grad_(False))
        if not self.random_init:
            try:
                flat = _load_npz_weights((config_paths or []) + self._extra_config_paths())
            except RuntimeError as e:
                raise vq_exception(
                    "ML-head weights not found. The reference downloads "
                    "torch checkpoints from huggingface.co/gfxdisp/cvvdp_ml; "
                    "convert one with python -m "
                    "colorvideovdp_tpu_torch.tools.convert_ml_ckpt and place "
                    "the resulting cvvdp_ml.npz on a config path, or pass "
                    f"random_init=True. ({e})"
                ) from e
            self.load_weights(flat)

    def load_weights(self, flat: dict):
        """Load flat checkpoint-layout arrays ("<net>.<key>": array, as in
        ``cvvdp_ml.npz`` or from ``convert.ml_weights_from_jax``) into the
        nets. Raises ``vq_exception`` on a missing, unexpected or misshapen
        key of any net."""
        by_net = _split_nets(flat, self.get_nets_to_load())
        for name in self.get_nets_to_load():
            net = getattr(self, name)
            if isinstance(net, MLP):
                loaded = _mlp_from_flat(by_net[name], net=name)
            else:
                loaded = _transformer_from_flat(by_net[name], len(net.transformer.layers), name)
            _check_same_shapes(name, loaded, _tree(net))
            _assign(_tree(net), loaded)

    def ml_weights(self) -> dict:
        """The nets' parameters as flat checkpoint-layout numpy arrays (what
        ``load_weights`` takes and ``cvvdp_ml.npz`` holds)."""
        return {f"{name}.{k}": v.detach().cpu().numpy()
                for name in self.get_nets_to_load()
                for k, v in getattr(self, name).state_dict().items()}

    @no_tf32()
    def _process_block(self, R, temp_ch, is_image, heatmap=False):
        """Pyramid -> CSF -> masking -> tile statistics for one frame block.
        R: (B, 2 * all_ch, F, H, W) interleaved. Returns (features, None,
        None): per band (B, F, h', w', all_ch, 6)."""
        if heatmap:
            raise vq_exception("Currently cvvdp-ml metrics do not produce heatmaps")
        all_ch = 2 + temp_ch
        use_k = self.enable_fused_kernels
        n_bands = self.lpyr.get_band_count()
        params = self._masking_params()
        with spans.span("cvvdp.pyramid"):
            bands, L_bkg_pyr = self.lpyr.decompose(R, use_kernel=use_k)
        rho_band = list(self.lpyr.get_freqs())
        rho_band[n_bands - 1] = 0.1
        sens_corr = 10.0 ** (self.sensitivity_correction / 20.0)
        feature_size = math.ceil(self.pix_per_deg)
        omegas = [self.omega[0 if cc < 3 else 1] for cc in range(all_ch)]
        channels = [cc if cc < 3 else 0 for cc in range(all_ch)]

        with spans.span("cvvdp.bands"):
            features = []
            for bb in range(n_bands):
                band = LaplacianPyramid.get_band(bands, bb)
                T_f, R_f = band[:, 0::2], band[:, 1::2]
                S = self.csf.sensitivity_multi_channel([float(rho_band[bb])] * all_ch, omegas,
                                                       L_bkg_pyr[bb], channels, use_kernel=use_k)
                # (all_ch, B, 1, F, h, w) -> (B, all_ch, F, h, w)
                S = S.movedim(0, 1)[:, :, 0] * sens_corr
                if bb == n_bands - 1:
                    D = torch.abs(T_f - R_f) * S
                else:
                    D = mk.apply_masking_model(T_f, R_f, S, params, use_k)
                features.append(feature_pooling(torch.abs(T_f) * S, torch.abs(R_f) * S, D,
                                                feature_size))
                del band, T_f, R_f, S, D
        return features, None, None

    @no_tf32()
    def predict_video_source(self, vid_source):
        """Score a video source; returns (Q_jod, stats). The first video block
        pads in the ingest kernel ("replicate" or "head" mode), later blocks
        carry tails. Packed sources (``.yuv``, decoded video files) are
        unpacked on the device; a source must have ``get_raw_block``.
        ``stats["delta_per_band"]`` holds each band's head output, (B, bands)
        float32: the JOD is 10 less their sum."""
        with spans.request("cvvdp.predict") as root:
            return self._predict_video_source(vid_source, root)

    def _predict_video_source(self, vid_source, root):
        if not hasattr(vid_source, "get_raw_block"):
            raise NotImplementedError("the ML metrics read sources with get_raw_block only")
        h, w, N_frames = vid_source.get_video_size()
        batch_sz = vid_source.get_batch_size()
        self._ensure_pyramids(w, h)
        is_image = N_frames == 1
        dm = vid_source.dm_photometry
        met_cs = self.met_colorspace()
        sources = ("test", "reference")

        if is_image:
            block_N = 1
            root.set(frames=1, block_N=1)
            raws = [self._raw(vid_source, vid_source.get_raw_block(s, 0, 1)) for s in sources]
            with spans.span("cvvdp.block"):
                with spans.span("cvvdp.ingest"):
                    T, R = (ing.raw_to_met(dm, raw, met_cs).expand(batch_sz, -1, -1, -1, -1)
                            for raw in raws)
                    R = ing.interleave_tr(T, R)
                features = self._process_block(R, temp_ch=1, is_image=True)[0]
        else:
            fps = vid_source.get_frames_per_second()
            self.F, _ = get_temporal_filters(fps, self.sigma_tf, self.beta_tf, self.temp_filter)
            self.filter_len = int(self.F[0].shape[0])
            filt = np.stack([f[::-1] for f in self.F])
            block_N = self.estimate_block_N(h * w * batch_sz, N_frames)
            root.set(frames=N_frames, block_N=block_N)
            feats, tails = [], None
            for ff in range(0, N_frames, block_N):
                cur = min(block_N, N_frames - ff)
                raws = [self._raw(vid_source, vid_source.get_raw_block(s, ff, block_N)) for s in sources]
                with spans.span("cvvdp.block"):
                    with spans.span("cvvdp.ingest"):
                        R, tails = self._ingest_block(vid_source, raws, tails, dm, filt, met_cs,
                                                      N_frames)
                    del raws
                    f_block = self._process_block(R, temp_ch=2, is_image=False)[0]
                    del R
                    feats.append([f[:, :cur] for f in f_block])
            features = [torch.cat(b, dim=1) if len(b) > 1 else b[0] for b in zip(*feats)]

        tokens = sum(f.shape[0] * f.shape[1] * (f.shape[2] * f.shape[3] + self.class_tokens)
                     for f in features)
        with spans.span("cvvdp.ml.head", tokens=tokens, bands=len(features)):
            deltas = self.band_deltas(features)
            Q_jod = self.jod_of_deltas(deltas)
        with spans.span("cvvdp.readback"):
            delta_host = torch.stack([d.expand(batch_sz) for d in deltas], dim=-1).cpu().numpy()
        stats = {
            "rho_band": self.lpyr.get_freqs(),
            "frames_per_second": vid_source.get_frames_per_second(),
            "width": w,
            "height": h,
            "N_frames": N_frames,
            "block_N_frames": block_N,
            "delta_per_band": delta_host,
        }
        return torch.squeeze(Q_jod), stats

    def _ingest_block(self, vid_source, raws, tails, dm, filt, met_cs, N_frames):
        """(R, tails) of one video block: the first block padded inside the
        ingest kernel, later blocks after the carried tails."""
        use_k = self.enable_fused_kernels
        if tails is not None:
            fn = ing.ingest if use_k else ing.ingest_plain
            R, *tails = fn(*tails, *raws, dm, filt, met_cs)
        elif self.temp_padding == "replicate":
            fn = ing.ingest_replicate if use_k else ing.ingest_first_plain
            R, *tails = fn(*raws, dm, filt, met_cs)
        else:
            idx = [self._get_symmetric_frame_index(fi, N_frames)
                   for fi in range(-self.filter_len + 1, 0)]
            heads = [self._raw(vid_source, vid_source.get_raw_frame_list(s, idx))
                     for s in ("test", "reference")]
            if use_k:
                R, *tails = ing.ingest_head(*heads, *raws, dm, filt, met_cs)
            else:
                R, *tails = ing.ingest_first_plain(*raws, dm, filt, met_cs, *heads)
        return R, tails

    # Tokens a band's head takes beyond its tiles, per frame (the
    # transformer's class token).
    class_tokens = 0

    def band_deltas(self, features) -> list:
        """Each band's head output, in band order: what the JOD loses to
        the band, (B,) each (a scalar for ``cvvdp_ml``)."""
        raise NotImplementedError

    @staticmethod
    def jod_of_deltas(deltas):
        """10 less each band's delta, subtracted in band order."""
        Q_JOD = deltas[0].new_full(deltas[0].shape, 10.0)
        for d in deltas:
            Q_JOD = Q_JOD - d
        return Q_JOD

    def do_pooling_and_jods(self, features):
        return self.jod_of_deltas(self.band_deltas(features))

    def _head_features(self, f, is_image):
        """The heads' input: sqrt(|var|) for the three variances, a zero
        fourth channel for images, and the disabled statistics zeroed."""
        f = torch.stack([f[..., 0::2], torch.sqrt(torch.abs(f[..., 1::2]))], dim=-1).flatten(-2)
        if is_image:
            f = torch.cat([f, f.new_zeros(f.shape[:4] + (1, f.shape[5]))], dim=4)
        if self.disabled_features is not None:
            mask = np.ones((6,), np.float32)
            mask[list(self.disabled_features)] = 0
            f = f * torch.as_tensor(mask, device=f.device)
        return f

    def export_distogram(self, stats, fname, jod_max=None, base_size=6):
        raise vq_exception("Currently cvvdp-ml metrics do not export distograms")


class cvvdp_ml(cvvdp_ml_base):
    """MLP head over (mean_D, std_D) (JAX: ``cvvdp_ml``; not registered)."""

    def _build_nets(self):
        return {"feature_net": (MLP(2 * 4, [24] * 3 + [1], device="meta"), 0)}

    def band_deltas(self, features):
        no_bands = len(features)
        is_image = features[0].shape[4] == 3
        deltas = []
        for bb, f in enumerate(features):
            fD = self._head_features(f, is_image)[..., 4:]
            D_all = self.feature_net(fD.reshape(fD.shape[:4] + (-1,)))
            if bb == no_bands - 1:
                D_all = D_all * float(self.baseband_weight.reshape(-1)[0])
            if is_image:
                D_all = D_all * self.image_int
            deltas.append(D_all.reshape(-1).mean() / no_bands)
        return deltas

    def full_name(self):
        return "ColorVideoVDP-ML"

    def short_name(self):
        return "cvvdp-ml"


class cvvdp_ml_saliency(cvvdp_ml):
    """MLP head gated by a saliency (attention) MLP over the T/R statistics."""

    family = "cvvdp_ml_saliency"

    def _build_nets(self):
        return {"feature_net": (MLP(2 * 4, [24] * 3 + [1], device="meta"), 0),
                "att_net": (MLP(4 * 4, [48] * 4 + [1], device="meta"), 1)}

    def band_deltas(self, features):
        no_bands = len(features)
        batch_sz = features[0].shape[0]
        is_image = features[0].shape[4] == 3
        deltas = []
        for bb, f in enumerate(features):
            f = self._head_features(f, is_image)
            f_TR = f[..., 0:4].reshape(f.shape[:4] + (-1,))
            f_D = f[..., 4:].reshape(f.shape[:4] + (-1,))
            att = torch.relu(self.att_net(f_TR))
            D_all = torch.relu(self.feature_net(f_D)) * att / no_bands
            if bb == no_bands - 1:
                D_all = D_all * float(self.baseband_weight.reshape(-1)[0])
            if is_image:
                D_all = D_all * self.image_int
            deltas.append(D_all.reshape(batch_sz, -1).mean(dim=1))
        return deltas

    def full_name(self):
        return "ColorVideoVDP-ML-Saliency"

    def short_name(self):
        return "cvvdp-ml-saliency"


class cvvdp_ml_transformer(cvvdp_ml):
    """ViT-style regression head over all 24 per-tile features."""

    family = "cvvdp_ml_transformer"
    class_tokens = 1

    def __init__(self, dim=256, **kwargs):
        self._dim = dim
        super().__init__(**kwargs)

    def _build_nets(self):
        return {"transformer_net": (RegressionTransformer(24, self._dim, depth=4, heads=8,
                                                          device="meta"), 0)}

    def band_deltas(self, features):
        is_image = features[0].shape[4] == 3
        deltas = []
        for bb, f in enumerate(features):
            f = self._head_features(f, is_image)
            f_all = torch.cat([f[..., 0:4].reshape(f.shape[:4] + (-1,)),
                               f[..., 4:].reshape(f.shape[:4] + (-1,))], dim=-1)
            delta = self.transformer_net(f_all) / len(features)
            if bb == len(features) - 1:
                delta = delta * float(self.baseband_weight.reshape(-1)[0])
            if is_image:
                delta = delta * self.image_int
            deltas.append(delta)
        return deltas

    def full_name(self):
        return "ColorVideoVDP-ML-Transformer"

    def short_name(self):
        return "cvvdp-ml-transformer"


register_metric(cvvdp_ml_saliency)
register_metric(cvvdp_ml_transformer)
