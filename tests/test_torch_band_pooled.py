"""The one-pass pooled raw-band route of the PyTorch port
(``ops/kernels/band_pooled.py``) against the JAX package's raw-pair route.

On CPU tensors the port runs its plain version (the raw-pair chain fed
``gausspyr_expand(gn)``); the JAX side runs ``make_fused_mult_mutual_raw``
(``fused_csf_contrast_raw`` + ``fused_blur_transducer`` pooled, or the blur
and ``fused_masking_transducer`` on a band the blur skips) in interpret mode,
fed its own ``gausspyr_expand(gn)``, as ``tests/test_torch_kernels.py``
runs it. Inputs are seeded numpy arrays handed to both packages.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import masking as mk_j  # noqa: E402
from colorvideovdp_tpu.ops import pyramid as pyr_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels.masking_fused import make_fused_mult_mutual_raw  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402

GAINS = np.array([1.0, 1.45, 1.0, 1.0], np.float32)
RHO = 6.08
BETA = 2.0
# (h, w): an even band, an odd one, and one of 5 rows, under the blur's pad
# size (6 at the default pu_dilate): its blur is a unit tap.
SHAPES = [(64, 96), (33, 47), (5, 17)]


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


def _jax_route(C, ref_only, mul, lut):
    mj, _ = _metrics()
    params = mj._masking_params()
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    sens = 10.0 ** (mj.sensitivity_correction / 20.0)
    return make_fused_mult_mutual_raw(lut, x0, x1, GAINS[:C], sens, params,
                                      lambda M: mk_j.phase_uncertainty(M, params),
                                      ref_only, mul, pool_beta=BETA)


def _consts(C, ref_only):
    mj, mt = _metrics()
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    sens = 10.0 ** (mj.sensitivity_correction / 20.0)
    return bm.BandConsts.make(mt._masking_params(), C, x0, x1, sens, ref_only, BETA)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("C", [4, 3])
@pytest.mark.parametrize("ref_only", [False, True])
def test_band_pooled_matches_jax_raw_route(shape, C, ref_only):
    """Pooled sums of one band, the plain version and the wrapper on CPU
    tensors (the same function), against the JAX route's pooled norm
    q = safe_pow(sum / (h w), 1 / beta) turned back into sums in float64:
    within 1e-5 relative."""
    h, w = shape
    gi, gn, lut = _inputs(C, h, w, seed=h + C)
    mul = 2.0
    q_j = np.asarray(_jax_route(C, ref_only, mul, lut)(
        jnp.asarray(gi), pyr_j.gausspyr_expand(jnp.asarray(gn), (h, w))))
    k = _consts(C, ref_only)
    args = ([torch.from_numpy(gi)], [torch.from_numpy(gn)], torch.from_numpy(lut)[None],
            [mul], k)
    s_plain = bp.band_pooled_plain(*args)
    s_wrap = bp.band_pooled(*args)
    assert torch.equal(s_wrap, s_plain)
    assert s_plain.shape == (1, 1, C, 2)
    eps = 1e-5  # safe_pow's shift (ops/masking.py _EPS)
    s_j = ((q_j.astype(np.float64) + eps ** (1.0 / BETA)) ** BETA - eps) * (h * w)
    s_t = s_plain[0].numpy().astype(np.float64)
    assert np.all(s_j > 0)
    assert float(np.max(np.abs(s_t - s_j) / s_j)) <= 1e-5


def test_band_pooled_takes_several_bands_in_one_launch():
    """The list form: each band's sums are those of the band alone."""
    C = 4
    k = _consts(C, False)
    ins = [_inputs(C, h, w, seed=i) for i, (h, w) in enumerate(SHAPES)]
    gis = [torch.from_numpy(g) for g, _, _ in ins]
    gns = [torch.from_numpy(n) for _, n, _ in ins]
    luts = torch.from_numpy(np.stack([lut for _, _, lut in ins]))
    muls = [1.0, 2.0, 2.0]
    out = bp.band_pooled(gis, gns, luts, muls, k)
    for i in range(len(SHAPES)):
        assert torch.equal(out[i], bp.band_pooled([gis[i]], [gns[i]], luts[i:i + 1],
                                                  [muls[i]], k)[0])


def _route_spies(monkeypatch):
    """Record what the metric hands to ``band_pooled_sums`` and to
    ``band_pooled_d``, every call of the previous route (``band_sums``,
    ``band_masking``) and of the previous heatmap D mode, and the channel
    count of every plain expand through ``ops/pyramid.py``."""
    seen = {"pooled": [], "pooled_d": [], "expand": [], "band_sums": 0, "band_masking": 0,
            "d": []}
    pooled = bp.band_pooled_sums
    pooled_d = bp.band_pooled_d

    def spy_pooled(gis, gns, *args):
        seen["pooled"].append([(tuple(g.shape[-2:]), tuple(n.shape[-2:]))
                               for g, n in zip(gis, gns)])
        return pooled(gis, gns, *args)

    def spy_pooled_d(gis, gns, *args):
        seen["pooled_d"].append([(tuple(g.shape[-2:]), tuple(n.shape[-2:]))
                                 for g, n in zip(gis, gns)])
        return pooled_d(gis, gns, *args)

    expand = pyr_t.gausspyr_expand

    def spy_expand(x, *a, **kw):
        seen["expand"].append(int(x.shape[1]))
        return expand(x, *a, **kw)

    def counting(key, fn):
        def run(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return run

    band_d = bm.band_masking_d

    def spy_d(gis, Es, *args):
        seen["d"].append([tuple(g.shape[-2:]) for g in gis])
        return band_d(gis, Es, *args)

    monkeypatch.setattr(bp, "band_pooled_sums", spy_pooled)
    monkeypatch.setattr(bp, "band_pooled_d", spy_pooled_d)
    monkeypatch.setattr(pyr_t, "gausspyr_expand", spy_expand)
    monkeypatch.setattr(bm, "band_sums", counting("band_sums", bm.band_sums))
    monkeypatch.setattr(bm, "band_masking", counting("band_masking", bm.band_masking))
    monkeypatch.setattr(bm, "band_masking_d", spy_d)
    return seen


def _want_pooled(m, B, F):
    shapes = [tuple(s) for s in m.lpyr.pyr_shape[:-1]]
    return [[(shapes[bb], ((shapes[bb][0] + 1) // 2, (shapes[bb][1] + 1) // 2)) for bb in sel]
            for sel in bm.band_groups(shapes, B, 4 if F > 1 else 3, F, gn=True)]


def test_default_route_hands_gn_to_band_pooled(monkeypatch):
    """A 1-frame 64x96 score, one loss step and a raw heatmap: every pooled
    raw band group goes to ``band_pooled_sums`` with gn, none through a
    plain expand and ``band_sums`` / ``band_masking``; the heatmap's raw
    bands go to ``band_pooled_d`` with gn, not to ``band_masking_d`` fed the
    expand (its only plain expands are the reconstruct's one-channel
    maps)."""
    seen = _route_spies(monkeypatch)
    rng = np.random.RandomState(3)
    ref = (rng.rand(64, 96, 3) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(64, 96, 3) * 8).astype(np.int16),
                   0, 255).astype(np.uint8)
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    m.predict(test, ref, dim_order="HWC")
    want = _want_pooled(m, 1, 1)
    assert seen["pooled"] == want and len(want) >= 1
    assert (seen["expand"], seen["band_sums"], seen["band_masking"], seen["d"]) == ([], 0, 0, [])

    seen["pooled"].clear()
    x = torch.from_numpy(test.transpose(2, 0, 1)[None, :, None] / np.float32(255)).float()
    r = torch.from_numpy(ref.transpose(2, 0, 1)[None, :, None] / np.float32(255)).float()
    x.requires_grad_()
    v = m.get_loss_fn(64, 96)(x, r)
    (g,) = torch.autograd.grad(v, x)
    # Once in the forward, once in the checkpointed block's recompute.
    assert seen["pooled"] == want * 2
    assert (seen["expand"], seen["band_sums"], seen["band_masking"]) == ([], 0, 0)
    assert torch.isfinite(g).all() and g.abs().max() > 0

    seen["pooled"].clear()
    mh = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap="raw")
    mh.predict(test, ref, dim_order="HWC")
    assert seen["pooled"] == [] and seen["band_sums"] == 0 and seen["d"] == []
    shapes = [tuple(s) for s in mh.lpyr.pyr_shape[:-1]]
    blurs = [mh._masking_params().blurs(*s) for s in shapes]
    assert seen["pooled_d"] == [[(shapes[bb], ((shapes[bb][0] + 1) // 2,
                                               (shapes[bb][1] + 1) // 2)) for bb in sel]
                                for sel in bm.band_groups(shapes, 1, 3, 1, blurs, gn=True)]
    assert seen["expand"] == [1] * len(shapes)


def test_band_pooled_gradient_matches_jax():
    """``BandPooled``'s gradients in gi and gn against JAX's
    ``value_and_grad`` of its raw-pair route fed ``gausspyr_expand(gn)``:
    a weighted sum of the pooled norms, within 1e-4 (the loss tolerance),
    gradients within 1e-3 of max|g|."""
    C, (h, w) = 4, SHAPES[1]
    gi, gn, lut = _inputs(C, h, w, seed=21)
    wts = np.random.RandomState(22).rand(1, C, 2).astype(np.float32)
    route = _jax_route(C, False, 2.0, lut)

    def f_j(gi_, gn_):
        return jnp.sum(route(gi_, pyr_j.gausspyr_expand(gn_, (h, w))) * wts)

    v_j, (dgi_j, dgn_j) = jax.value_and_grad(f_j, argnums=(0, 1))(jnp.asarray(gi),
                                                                    jnp.asarray(gn))
    k = _consts(C, False)
    gi_t, gn_t = (torch.from_numpy(a).requires_grad_() for a in (gi, gn))
    sums = bp.band_pooled_sums([gi_t], [gn_t], torch.from_numpy(lut)[None], [2.0], k)
    v_t = torch.sum(bm.pooled_norm(sums[0], h, w, BETA) * torch.from_numpy(wts))
    dgi_t, dgn_t = torch.autograd.grad(v_t, (gi_t, gn_t))
    assert abs(float(v_t.detach()) - float(v_j)) <= 1e-4
    for g_t, g_j in ((dgi_t, dgi_j), (dgn_t, dgn_j)):
        g_j = np.asarray(g_j)
        assert np.abs(g_t.numpy() - g_j).max() <= 1e-3 * np.abs(g_j).max()


def test_band_fused_shares_the_pooled_route():
    """The mega route's pooled mode is ``band_pooled`` for one band, and its
    gradient is the same recompute."""
    C, (h, w) = 4, SHAPES[0]
    gi, gn, lut = _inputs(C, h, w, seed=5)
    k = dataclasses.replace(_consts(C, False))
    from colorvideovdp_tpu_torch.ops.kernels import band_fused as bf

    gi_t, gn_t, lut_t = torch.from_numpy(gi), torch.from_numpy(gn), torch.from_numpy(lut)
    assert torch.equal(bf.band_fused(gi_t, gn_t, lut_t, 1.0, k),
                       bp.band_pooled([gi_t], [gn_t], lut_t[None], [1.0], k)[0])
    g = torch.from_numpy(np.random.RandomState(6).rand(1, C, 2).astype(np.float32))
    a = [x.clone().requires_grad_() for x in (gi_t, gn_t)]
    b = [x.clone().requires_grad_() for x in (gi_t, gn_t)]
    ga = torch.autograd.grad(torch.sum(bf.band_fused_sums(*a, lut_t, 1.0, k) * g), a)
    gb = torch.autograd.grad(torch.sum(bp.band_pooled_sums([b[0]], [b[1]], lut_t[None],
                                                           [1.0], k)[0] * g), b)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)
