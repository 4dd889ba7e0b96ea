"""The D mode of the one-pass raw-band kernel (``ops/kernels/band_pooled.py``
``band_pooled_d``) against the JAX package's D route, and the metric's
heatmap routing through it.

On CPU tensors the port runs its plain version (the raw-pair chain fed
``gausspyr_expand(gn)``). The JAX side runs the plain chain of its raw D
route, ``make_fused_mult_mutual_raw(pool_beta=None)``'s ``jnp_impl`` (the
Weber contrast, the CSF LUT lookup and ``apply_masking_model``, which skips
the blur on a band under its pad size), fed its own ``gausspyr_expand(gn)``.
Inputs are seeded numpy arrays handed to both packages.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import masking as mk_j  # noqa: E402
from colorvideovdp_tpu.ops import pyramid as pyr_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels import csf_lut as lut_j  # noqa: E402
from colorvideovdp_tpu_torch.metrics import cvvdp as cvvdp_t  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402

RHO = 6.08
BETA = 2.0
# (h, w): an even band, an odd one, and one of 5 rows, under the blur's pad
# size (6 at the default pu_dilate): its blur is skipped (the JAX package's
# fused_masking_transducer, the kernel's unit tap).
SHAPES = [(64, 96), (33, 47), (5, 17)]
# D against the JAX chain: both round every product and quotient in float32,
# in orders that differ (the blur's taps, the LUT's interpolation), so a few
# ulps of the largest D.
D_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _metrics():
    return (cj.cvvdp(display_name="standard_4k", quiet=True),
            ct.cvvdp(display_name="standard_4k", device="cpu"))


def _inputs(C, h, w, seed, F=2):
    """gi (1, 2C, F, h, w) and gn (1, 2C, F, ceil(h/2), ceil(w/2)), each
    seeded uniform in [30, 50), and the band's LUT rows (C, nk)."""
    mj, _ = _metrics()
    rng = np.random.RandomState(seed)
    gi = (30.0 + 20.0 * rng.rand(1, 2 * C, F, h, w)).astype(np.float32)
    gn = (30.0 + 20.0 * rng.rand(1, 2 * C, F, (h + 1) // 2, (w + 1) // 2)).astype(np.float32)
    lut = np.stack([mj.csf.logS_of_logL(RHO, mj.omega[0 if cc < 3 else 1], cc if cc < 3 else 0)
                    for cc in range(C)]).astype(np.float32)
    return gi, gn, lut


def _lut_range():
    mj, _ = _metrics()
    return float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])


def _sens():
    mj, _ = _metrics()
    return 10.0 ** (mj.sensitivity_correction / 20.0)


def _jax_D(gi, gn, lut, ref_only, mul):
    """D of the JAX raw route's plain chain fed JAX's expand of gn."""
    mj, _ = _metrics()
    x0, x1 = _lut_range()
    g = jnp.asarray(gi)
    E = pyr_j.gausspyr_expand(jnp.asarray(gn), gi.shape[-2:])
    lb_r = jnp.clip(E[:, 1:2], 0.01, None)
    lb_t = lb_r if ref_only else jnp.clip(E[:, 0:1], 0.01, None)
    T = jnp.clip((g[:, 0::2] - E[:, 0::2]) / lb_t, None, 1000.0) * mul
    R = jnp.clip((g[:, 1::2] - E[:, 1::2]) / lb_r, None, 1000.0) * mul
    S = jnp.moveaxis(lut_j._jnp_lookup(jnp.log10(lb_r[:, 0]), lut, x0, x1), 0, 1) * _sens()
    return np.asarray(mk_j.apply_masking_model(T, R, S, mj._masking_params()))


def _consts(C, ref_only):
    _, mt = _metrics()
    x0, x1 = _lut_range()
    return bm.BandConsts.make(mt._masking_params(), C, x0, x1, _sens(), ref_only, BETA)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("C", [4, 3])
@pytest.mark.parametrize("ref_only", [False, True])
def test_band_pooled_d_matches_jax_d_route(shape, C, ref_only):
    """D of one band, the plain version and the wrapper on CPU tensors (the
    same function), against the JAX chain within 1e-5 of max|D|; the D
    mode's sums equal the pooled mode's exactly."""
    h, w = shape
    gi, gn, lut = _inputs(C, h, w, seed=3 * h + C)
    mul = 2.0
    D_j = _jax_D(gi, gn, lut, ref_only, mul)
    k = _consts(C, ref_only)
    args = ([torch.from_numpy(gi)], [torch.from_numpy(gn)], torch.from_numpy(lut)[None],
            [mul], k)
    (D_t,), sums = bp.band_pooled_d_plain(*args)
    (D_w,), sums_w = bp.band_pooled_d(*args)
    assert torch.equal(D_w, D_t) and torch.equal(sums_w, sums)
    assert D_t.shape == D_j.shape == (1, C, 2, h, w)
    assert np.abs(D_j).max() > 0
    assert np.abs(D_t.numpy() - D_j).max() <= D_TOL * np.abs(D_j).max()
    assert sums.shape == (1, 1, C, 2)
    assert torch.equal(sums, bp.band_pooled_plain(*args))


def test_band_pooled_d_takes_several_bands_in_one_launch():
    """The list form over bands with and without the blur: each band's D
    and sums are those of the band alone."""
    C = 4
    k = _consts(C, False)
    ins = [_inputs(C, h, w, seed=40 + i) for i, (h, w) in enumerate(SHAPES)]
    gis = [torch.from_numpy(g) for g, _, _ in ins]
    gns = [torch.from_numpy(n) for _, n, _ in ins]
    luts = torch.from_numpy(np.stack([lut for _, _, lut in ins]))
    muls = [1.0, 2.0, 2.0]
    Ds, sums = bp.band_pooled_d(gis, gns, luts, muls, k)
    assert len(Ds) == len(SHAPES) and sums.shape == (len(SHAPES), 1, C, 2)
    for i in range(len(SHAPES)):
        (D1,), s1 = bp.band_pooled_d([gis[i]], [gns[i]], luts[i:i + 1], [muls[i]], k)
        assert torch.equal(Ds[i], D1) and torch.equal(sums[i], s1[0])


def _pair(kind):
    """A seeded 48x256 pair on standard_4k: one image (band 3 has 6 rows and
    takes no blur) or 7 frames, with the ``gpu_mem`` and keywords that make
    the video two blocks of 4 frames."""
    rng = np.random.RandomState(23)
    ref = (rng.rand(48, 256, 3, 7) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 8).astype(np.int16),
                   0, 255).astype(np.uint8)
    if kind == "image":
        return test[..., 0], ref[..., 0], None, dict(dim_order="HWC")
    pix = 48 * 256
    # The port's block model (estimate_block_N): a = 1.6e9, b = 16, c = 320
    # bytes a pixel, a 9-tap temporal filter at 30 fps.
    gpu_mem = (1.6e9 + pix * 8 * 16 + pix * 336 * 4.5) / 1e9
    return test, ref, gpu_mem, dict(dim_order="HWCF", frames_per_second=30)


def _route_spies(monkeypatch):
    """Record each ``band_pooled_d`` launch's (gi, gn) shapes and the
    channel count of every plain expand that goes through
    ``ops/pyramid.py`` (the heatmap's reconstruct)."""
    seen = {"d": [], "expand": []}
    pooled_d = bp.band_pooled_d

    def spy_d(gis, gns, *args):
        seen["d"].append([(tuple(g.shape[-2:]), tuple(n.shape[-2:]))
                          for g, n in zip(gis, gns)])
        return pooled_d(gis, gns, *args)

    expand = pyr_t.gausspyr_expand

    def spy_expand(x, *a, **kw):
        seen["expand"].append(int(x.shape[1]))
        return expand(x, *a, **kw)

    monkeypatch.setattr(bp, "band_pooled_d", spy_d)
    monkeypatch.setattr(pyr_t, "gausspyr_expand", spy_expand)
    return seen


@pytest.mark.parametrize("kind", ["image", "video"])
def test_heatmap_route_hands_gn_to_band_pooled_d(monkeypatch, kind):
    """A raw heatmap: every raw band, with and without the blur, goes to
    ``band_pooled_d`` with gn, as ``band_groups`` packs them, once a block,
    and the metric expands no raw band itself (the only plain expands are
    the reconstruct's, of one-channel maps)."""
    seen = _route_spies(monkeypatch)
    test, ref, gpu_mem, kw = _pair(kind)
    m = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap="raw", gpu_mem=gpu_mem)
    _, st = m.predict(test, ref, **kw)
    n_blocks = 1 if kind == "image" else 2
    assert st["block_N_frames"] == (1 if kind == "image" else 4)
    params = m._masking_params()
    shapes = [tuple(s) for s in m.lpyr.pyr_shape[:-1]]
    blurs = [params.blurs(*s) for s in shapes]
    assert not all(blurs)  # the blur-off band is on this path
    C, F = (3, 1) if kind == "image" else (4, 4)
    want = [[(shapes[bb], ((shapes[bb][0] + 1) // 2, (shapes[bb][1] + 1) // 2)) for bb in sel]
            for sel in bm.band_groups(shapes, 1, C, F, blurs, gn=True)]
    assert seen["d"] == want * n_blocks and len(want) >= 1
    assert seen["expand"] == [1] * (len(shapes) * n_blocks)
    assert not hasattr(cvvdp_t, "gausspyr_expand")


@pytest.mark.parametrize("kind", ["image", "video"])
def test_raw_heatmap_jod_equals_pooled_only_jod(kind):
    """The JOD with a "raw" heatmap is the pooled-only JOD to the bit, at the
    same block length: both take their Q columns from the same sums."""
    test, ref, gpu_mem, kw = _pair(kind)
    out = []
    for hm in ("raw", None):
        Q, st = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap=hm,
                         gpu_mem=gpu_mem).predict(test, ref, **kw)
        out.append((float(Q), st["block_N_frames"]))
    assert out[0] == out[1]
    assert np.isfinite(out[0][0])


def test_mega_heatmap_jod_equals_mega_pooled_jod():
    """At 96x512, where the JAX package's gate (``use_band_mega``,
    ``force_fused``) sends bands 0 and 1 to its mega-kernel, the port's one
    route gives a raw heatmap JOD that is the pooled-only JOD."""
    rng = np.random.RandomState(29)
    ref = (rng.rand(96, 512, 3) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + 9, 0, 255).astype(np.uint8)
    jods = []
    for hm in ("raw", None):
        m = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap=hm)
        jods.append(float(m.predict(test, ref, dim_order="HWC")[0]))
    assert jods[0] == jods[1]
