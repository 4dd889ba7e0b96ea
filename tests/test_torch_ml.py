"""The ColorVideoVDP-ML metrics of the PyTorch port against the JAX package
(CPU): the first-block ingest modes, feature pooling, the heads at full
width, weight loading and the weights carried over by ``convert``.

The end-to-end cases, which compile the JAX trunk, are in
``test_torch_ml_saliency.py`` and ``test_torch_ml_transformer.py`` and use
the helpers here. Weights are seeded numpy arrays in the published
checkpoint layout (``tools/cvvdp_ml_manifest.json``), written to an npz
that both packages load through ``config_paths``. The JAX metrics run
their Pallas ingest in interpret mode (``force_fused``), as the JAX
package's own tests do.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.metrics import ml as ml_j  # noqa: E402
from colorvideovdp_tpu.ops.feature_pooling import feature_pooling as feature_pooling_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels.ingest import make_ingest_fn  # noqa: E402
from colorvideovdp_tpu.ops.temporal import apply_temporal_filters  # noqa: E402
from colorvideovdp_tpu_torch.convert import ml_weights_from_jax  # noqa: E402
from colorvideovdp_tpu_torch.metrics import ml as ml_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.feature_pooling import feature_pooling  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing_t  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"saliency": (ml_j.cvvdp_ml_saliency, ct.cvvdp_ml_saliency),
            "transformer": (ml_j.cvvdp_ml_transformer, ct.cvvdp_ml_transformer)}
# standard_fhd (37.8 pixels per degree: 38-pixel tiles) at 64x128, so that
# band 0 has 2 x 4 tiles, the last ones partial.
DISPLAY, H, W, N, FPS = "standard_fhd", 64, 128, 5, 30.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def seeded_weights(family, seed):
    """Flat checkpoint-layout weights of ``family`` with every key and shape
    of the published manifest: Linear weights uniform in +-1/sqrt(fan_in)
    (non-negative in the MLPs' last layers, so that the saliency head's two
    ReLU outputs respond), biases uniform in +-0.3, the LayerNorm gains near
    1 and the class token standard normal."""
    with open(os.path.join(REPO, "tools", "cvvdp_ml_manifest.json")) as f:
        shapes = json.load(f)[f"cvvdp_ml_{family}"]
    last = {f"feature_net.{3 * 3}.weight", f"att_net.{3 * 4}.weight"}
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(shapes):
        shape = tuple(shapes[key])
        if key.endswith("cls_token"):
            v = rng.randn(*shape)
        elif len(shape) == 2:
            b = 1.0 / np.sqrt(shape[1])
            v = rng.uniform(0.0 if key in last else -b, b, shape)
        elif "norm" in key or ".reg_head.0." in key:
            v = (1.0 if key.endswith("weight") else 0.0) + rng.uniform(-0.1, 0.1, shape)
        else:
            v = rng.uniform(-0.3, 0.3, shape)
        out[key] = v.astype(np.float32)
    return out


def write_npz(directory, flat):
    np.savez(os.path.join(str(directory), "cvvdp_ml.npz"), **flat)
    return [str(directory)]


def port_gpu_mem(blk, pix, fl=9):
    """gpu_mem (GB) that gives ``blk``-frame blocks under the port's memory
    model (``cvvdp.estimate_block_N``: a = 1.6e9, b = 16, c = 320)."""
    return (1.6e9 + pix * (fl - 1) * 16 + pix * 336 * (blk + 0.5)) / 1e9


# ---------------------------------------------------------------------------
# (a) the first-block ingest modes


def _filters():
    F, _ = cj.ops.temporal.get_temporal_filters(30, *[np.asarray(v) for v in (
        [5.79336, 14.1255, 6.63661, 0.12314], [1.3314, 1.1196, 0.947901, 0.1898])])
    return np.stack([f[::-1] for f in F])


def _up(a):
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a.copy())


def _raw_frames(dtype, shape, fl, seed):
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    raws = [(rng.rand(*shape) * top).astype(dtype) for _ in range(2)]
    heads = [(rng.rand(shape[0], fl - 1, *shape[2:]) * top).astype(dtype) for _ in range(2)]
    return raws, heads


@pytest.mark.parametrize("mode", ["replicate", "head"])
@pytest.mark.parametrize("display,dtype,tol", [
    ("standard_4k", np.uint8, 1e-5),
    # PQ: XLA fuses the JAX kernel's float32 PQ chain (up to 3e-5 from JAX's
    # op-by-op pq2lin, which the port follows; tests/test_torch_kernels.py).
    ("standard_hdr_pq", np.uint8, 1e-4),
    ("standard_hdr_pq", np.uint16, 1e-4),
])
def test_ingest_first_modes_match_make_ingest_fn(display, dtype, tol, mode):
    dm_j = cj.vvdp_display_photometry.load(display)
    dm_t = ct.vvdp_display_photometry.load(display)
    filt = _filters()
    fl = filt.shape[1]
    shape = (1, 3, 3, 16, 128)
    raws, heads = _raw_frames(dtype, shape, fl, 1)
    fn = make_ingest_fn(dm_j, dtype, shape, filt, fl, mode, interpret=True)
    ins = (heads + raws) if mode == "head" else raws
    out_j = [np.asarray(o) for o in fn(*[jnp.asarray(a) for a in ins])]
    if mode == "head":
        out_t = ing_t.ingest_head(*[_up(a) for a in heads + raws], dm_t, filt)
    else:
        out_t = ing_t.ingest_replicate(*[_up(a) for a in raws], dm_t, filt)
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) <= tol


@pytest.mark.parametrize("mode", ["replicate", "head"])
def test_ingest_first_modes_log_lms_match_jax(mode):
    """The log contrast's colour space, which the JAX package forms in XLA
    (its first-block step without the Pallas ingest), not in its kernel."""
    mj = cj.cvvdp(display_name="standard_4k", quiet=True)
    dm_j = mj.display_photometry
    dm_t = ct.vvdp_display_photometry.load("standard_4k")
    filt = _filters()
    fl = filt.shape[1]
    shape = (1, 3, 3, 16, 40)
    raws, heads = _raw_frames(np.uint8, shape, fl, 2)
    cs = "logLMS_DKLd65"
    outs, tails = [], []
    for k in range(2):
        new = mj._flat_to_met(dm_j, jnp.asarray(raws[k]).reshape(-1), shape, cs)
        if mode == "head":
            pad = mj._flat_to_met(dm_j, jnp.asarray(heads[k]).reshape(-1),
                                  (1, fl - 1) + shape[2:], cs)
        else:
            pad = jnp.broadcast_to(new[:, :, 0:1], (1, 3, fl - 1) + shape[3:])
        buf = jnp.concatenate([pad, new], axis=2)
        outs.append(np.asarray(apply_temporal_filters(buf, filt)))
        tails.append(np.asarray(buf[:, :, shape[1]:]))
    R_j = np.stack(outs, axis=2).reshape((1, 8) + outs[0].shape[2:])
    hd = [_up(a) for a in heads] if mode == "head" else [None, None]
    out_t = ing_t.ingest_first_plain(*[_up(a) for a in raws], dm_t, filt, cs, *hd)
    for a, b in zip(out_t, (R_j, *tails)):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) <= 1e-5


@pytest.mark.parametrize("mode", ["replicate", "head"])
def test_ingest_first_modes_equal_tail_mode_on_formed_tails(mode):
    """A first-block mode gives the bits of tail mode fed the padding that
    ``cvvdp`` forms as tails (frame 0 repeated, or the converted heads)."""
    dm = ct.vvdp_display_photometry.load("standard_hdr_pq")
    filt = _filters()
    fl = filt.shape[1]
    raws, heads = _raw_frames(np.uint16, (2, 4, 3, 8, 24), fl, 3)
    raws, heads = [_up(a) for a in raws], [_up(a) for a in heads]
    if mode == "head":
        first = ing_t.ingest_head(*heads, *raws, dm, filt)
        tails = [ing_t.raw_to_met(dm, h) for h in heads]
    else:
        first = ing_t.ingest_replicate(*raws, dm, filt)
        tails = [ing_t.raw_to_met(dm, r[:, :1]).expand(-1, -1, fl - 1, -1, -1) for r in raws]
    for a, b in zip(first, ing_t.ingest_plain(*tails, *raws, dm, filt)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (b) feature pooling


@pytest.mark.parametrize("shape,fs", [((2, 4, 3, 37, 53), 16), ((1, 3, 2, 64, 128), 38),
                                      ((1, 4, 1, 5, 9), 38)])
def test_feature_pooling_matches_jax(shape, fs):
    """Partial edge tiles and a band smaller than one tile. Held per
    statistic before any square root."""
    rng = np.random.RandomState(4)
    T, R, D = (rng.rand(*shape).astype(np.float32) * 50 for _ in range(3))
    got = feature_pooling(*(torch.from_numpy(x) for x in (T, R, D)), fs).numpy()
    want = np.asarray(feature_pooling_j(T, R, D, fs))
    assert got.shape == want.shape
    for s in range(6):
        assert _rel(got[..., s], want[..., s]) <= 1e-5


# ---------------------------------------------------------------------------
# (c) the heads at full width


@pytest.mark.parametrize("net", ["feature_net", "att_net", "transformer_net"])
def test_heads_match_jax(net):
    family = "transformer" if net == "transformer_net" else "saliency"
    flat = seeded_weights(family, 5)
    sub = {k[len(net) + 1:]: v for k, v in flat.items() if k.startswith(net + ".")}
    m = FAMILIES[family][1](display_name=DISPLAY, device="cpu", random_init=True)
    m.load_weights(flat)
    module = getattr(m, net)
    rng = np.random.RandomState(6)
    if net == "transformer_net":
        # (B, frames, h, w, 24): 12 tokens per frame plus the class token.
        x = rng.randn(2, 2, 3, 4, 24).astype(np.float32)
        want = np.asarray(ml_j.transformer_apply(ml_j._transformer_from_flat(sub), x))
    else:
        x = rng.randn(2, 3, 5, module.linears()[0].in_features).astype(np.float32) * 3
        want = np.asarray(ml_j.mlp_apply(ml_j._mlp_from_flat(sub, net), x))
    got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("family", ["ml", "saliency", "transformer"])
@pytest.mark.parametrize("case", ["video", "image-disabled"])
def test_pooling_and_jods_match_jax(weights_dir, family, case):
    """The heads' pooling on the same per-band features: sqrt(|var|) of
    negative variances, the zero channel of images, disabled statistics, the
    baseband weight and image_int (``cvvdp_ml`` is the unregistered MLP
    head)."""
    cls_j, cls_t = {"ml": (ml_j.cvvdp_ml, ml_t.cvvdp_ml), **FAMILIES}[family]
    C, disabled = (3, [1, 4]) if case == "image-disabled" else (4, None)
    frames = 1 if C == 3 else 3
    mj = cls_j(display_name=DISPLAY, quiet=True, config_paths=weights_dir,
               disabled_features=disabled)
    mt = cls_t(display_name=DISPLAY, device="cpu", config_paths=weights_dir,
               disabled_features=disabled)
    rng = np.random.RandomState(14)
    feats = [rng.randn(2, frames, h, w, C, 6).astype(np.float32) * 5
             for h, w in ((3, 4), (2, 2), (1, 1))]
    q_j = np.asarray(jax.jit(mj.do_pooling_and_jods)([jnp.asarray(f) for f in feats]))
    q_t = mt.do_pooling_and_jods([torch.from_numpy(f) for f in feats]).numpy()
    assert q_t.shape == q_j.shape
    assert np.abs(10.0 - q_j).max() > 1e-3
    assert np.abs(q_t - q_j).max() <= 1e-5 * max(1.0, np.abs(10.0 - q_j).max())


# ---------------------------------------------------------------------------
# (d) weight loading


def _mutated(family, fault):
    flat = seeded_weights(family, 8)
    net = "att_net" if family == "saliency" else "transformer_net"
    key = sorted(k for k in flat if k.startswith(net + "."))[1]
    if fault == "missing":
        del flat[key]
    elif fault == "extra":
        flat[f"{net}.unexpected.weight"] = np.zeros((2, 2), np.float32)
    else:
        flat[key] = np.zeros(flat[key].shape[:-1] + (flat[key].shape[-1] + 1,), np.float32)
    return flat


@pytest.mark.parametrize("family", ["saliency", "transformer"])
@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "no-file"])
def test_loader_fails_loud_as_jax_does(tmp_path, family, fault):
    """Both packages raise their vq_exception with the same message on a
    missing key, an unexpected key, a wrong shape; and with no npz at all,
    where each names its own converter."""
    if fault != "no-file":
        write_npz(tmp_path, _mutated(family, fault))
    cls_j, cls_t = FAMILIES[family]
    with pytest.raises(cj.vq_exception) as e_j:
        cls_j(display_name=DISPLAY, quiet=True, config_paths=[str(tmp_path)])
    with pytest.raises(ct.vq_exception) as e_t:
        cls_t(display_name=DISPLAY, device="cpu", config_paths=[str(tmp_path)])
    want = str(e_j.value)
    if fault == "no-file":
        want = want.replace("with tools/convert_ml_ckpt.py and",
                            "with python -m colorvideovdp_tpu_torch.tools.convert_ml_ckpt and")
        assert want != str(e_j.value)
    assert str(e_t.value) == want


def test_ml_metrics_registered():
    assert ct.vq_metric_dict["cvvdp_ml_saliency"] is ct.cvvdp_ml_saliency
    assert ct.vq_metric_dict["cvvdp_ml_transformer"] is ct.cvvdp_ml_transformer
    assert ct.vq_metric_dict["cvvdp"] is ct.cvvdp
    assert "cvvdp_ml" not in ct.vq_metric_dict


def test_heatmap_raises():
    with pytest.raises(ct.vq_exception, match="heatmaps"):
        ct.cvvdp_ml_saliency(display_name=DISPLAY, device="cpu", random_init=True,
                             heatmap="raw")


# ---------------------------------------------------------------------------
# (e) end to end (the cases are in tests/test_torch_ml_{saliency,transformer}.py,
# one file per family so that each stays short), (f) weights through convert


def _content(seed):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(H, W, 3, N) * 0.8 * 255).astype(np.uint8)
    noise = rng.randn(H, W, 3, N) * 0.05 * 255
    test = np.clip(ref.astype(np.float64) + noise, 0, 255).astype(np.uint8)
    return test, ref


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cvvdp_ml")
    return write_npz(d, {**seeded_weights("saliency", 9), **seeded_weights("transformer", 10)})


def jax_metric(family, weights_dir):
    """The JAX metric of ``family`` that the end-to-end cases share, in blocks
    of 3 frames (its block model gives one block at this size)."""
    m = FAMILIES[family][0](display_name=DISPLAY, quiet=True, config_paths=weights_dir)
    m.force_fused = True
    m.estimate_block_N = lambda pix, n: min(3, n)
    return m


def check_matches_jax(mj, weights_dir, family, case):
    """JOD within 1e-4 of max(1, |10 - JOD|) on an image pair or a 5-frame
    video. Videos: JAX in blocks of 3 (its first block through the Pallas
    ingest's replicate or head mode, interpret), the port in blocks of 2, 2
    and 1(+1)."""
    test, ref = _content(11)
    mt = FAMILIES[family][1](display_name=DISPLAY, device="cpu", config_paths=weights_dir,
                             gpu_mem=port_gpu_mem(2, H * W))
    if case == "image":
        kw = dict(dim_order="HWC")
        test, ref = test[..., 0], ref[..., 0]
    else:
        kw = dict(dim_order="HWCF", frames_per_second=FPS)
        mj.temp_padding = mt.temp_padding = case
    Qj, _ = mj.predict(test, ref, **kw)
    Qt, st = mt.predict(test, ref, **kw)
    jod_j, jod_t = float(Qj), float(Qt)
    assert abs(10.0 - jod_j) > 1e-2  # the seeded heads respond
    assert abs(jod_t - jod_j) <= 1e-4 * max(1.0, abs(10.0 - jod_j)), (jod_t, jod_j)
    if case != "image":
        assert st["block_N_frames"] == 2


@pytest.mark.parametrize("family", ["saliency", "transformer"])
def test_convert_weights_match_npz_route(weights_dir, family):
    test, ref = _content(12)
    cls = FAMILIES[family][1]
    m_npz = cls(display_name=DISPLAY, device="cpu", config_paths=weights_dir)
    m_conv = cls(display_name=DISPLAY, device="cpu", random_init=True)
    m_conv.load_weights(ml_weights_from_jax(jax_metric(family, weights_dir)))
    for a, b in zip(m_npz.ml_weights().items(), m_conv.ml_weights().items()):
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    jods = [float(m.predict(test[..., 0], ref[..., 0], dim_order="HWC")[0])
            for m in (m_npz, m_conv)]
    assert jods[0] == jods[1]


def test_random_init_is_seeded():
    """``random_init`` draws from torch generators seeded as the JAX package
    seeds its keys: two instances hold the same weights."""
    a, b = (ml_t.cvvdp_ml_saliency(display_name=DISPLAY, device="cpu", random_init=True)
            for _ in range(2))
    wa, wb = a.ml_weights(), b.ml_weights()
    assert sorted(wa) == sorted(seeded_weights("saliency", 0))
    assert all(np.array_equal(wa[k], wb[k]) for k in wa)
