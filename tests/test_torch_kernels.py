"""Each kernel module of the PyTorch port against the JAX kernel it replaces.

On CPU tensors every wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernels the way the JAX package's own tests do (interpret
mode off-TPU). Inputs are seeded numpy arrays handed to both packages.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import masking as mk_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels import csf_lut as lut_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels.band_stack import make_band_stack  # noqa: E402
from colorvideovdp_tpu.ops.kernels.ingest import make_ingest_fn  # noqa: E402
from colorvideovdp_tpu.ops.kernels.masking_fused import make_fused_mult_mutual_raw  # noqa: E402
from colorvideovdp_tpu.ops.kernels.pyramid_reduce import reduce_tpu  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import csf_lut as lut_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels.pyramid_reduce import pyramid_reduce  # noqa: E402


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def metrics():
    return (cj.cvvdp(display_name="standard_4k", quiet=True),
            ct.cvvdp(display_name="standard_4k", device="cpu"))


@pytest.mark.parametrize("shape", [(2, 57, 256), (1, 66, 300), (3, 64, 128)])
def test_reduce_matches_reduce_tpu(shape):
    """Odd H and odd W included: both passes key the last-sample branch on
    H's parity (trap 1)."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    y_j = np.asarray(reduce_tpu(jnp.asarray(x), interpret=True))
    y_t = pyramid_reduce(torch.from_numpy(x)).numpy()
    assert y_t.shape == y_j.shape
    assert np.abs(y_t - y_j).max() <= 1e-6 * max(1.0, np.abs(y_j).max())


@pytest.mark.parametrize("display,dtype,tol", [
    ("standard_4k", np.uint8, 1e-5),
    # PQ in float32 is ill-conditioned near the display peak (C2 - C3 * im_t
    # cancels): XLA compiles the JAX kernel's PQ chain into one fusion whose
    # result is up to 3e-5 relative from JAX's own op-by-op pq2lin, which
    # the port follows (test_pq2lin_matches_jax below holds it to that).
    ("standard_hdr_pq", np.uint8, 1e-4),
    ("standard_hdr_pq", np.uint16, 1e-4),
])
def test_ingest_tail_mode_matches_make_ingest_fn(display, dtype, tol):
    dm_j = cj.vvdp_display_photometry.load(display)
    dm_t = ct.vvdp_display_photometry.load(display)
    F, _ = cj.ops.temporal.get_temporal_filters(30, *[np.asarray(v) for v in (
        [5.79336, 14.1255, 6.63661, 0.12314], [1.3314, 1.1196, 0.947901, 0.1898])])
    filt = np.stack([f[::-1] for f in F])
    fl = filt.shape[1]
    assert fl == 9
    shape = (1, 3, 3, 16, 128)
    rng = np.random.RandomState(1)
    top = np.iinfo(dtype).max
    raw_t = (rng.rand(*shape) * top).astype(dtype)
    raw_r = (rng.rand(*shape) * top).astype(dtype)
    tail_t = (rng.rand(1, 3, fl - 1, 16, 128) * 60).astype(np.float32)
    tail_r = (rng.rand(1, 3, fl - 1, 16, 128) * 60).astype(np.float32)

    fn = make_ingest_fn(dm_j, dtype, shape, filt, fl, "tail", interpret=True)
    out_j = [np.asarray(o) for o in fn(jnp.asarray(tail_t), jnp.asarray(tail_r),
                                      jnp.asarray(raw_t), jnp.asarray(raw_r))]

    def up(a):
        return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a.copy())

    out_t = ing_t.ingest(torch.from_numpy(tail_t), torch.from_numpy(tail_r), up(raw_t),
                         up(raw_r), dm_t, filt)
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) <= tol


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pq2lin_matches_jax(dtype):
    """Every code of the dtype through the port's pq2lin and the JAX
    package's, op by op. The port rounds both powers correctly; XLA's CPU
    pow misses about one uint16 code in a thousand by an ulp, which the
    curve amplifies up to 5e-5 relative near the peak. Wherever XLA's two
    powers are correctly rounded, the results are bit-identical."""
    top = np.iinfo(dtype).max
    v = np.arange(top + 1, dtype=np.float32) / np.float32(top)
    L_j = np.asarray(cj.ops.colorspace.pq2lin(jnp.asarray(v)))
    L_t = ct.ops.colorspace.pq2lin(torch.from_numpy(v)).numpy()
    y1, y2 = np.float32(1 / 78.84375), np.float32(1 / 0.1593017578125)
    im = np.asarray(jnp.power(jnp.asarray(v), 1.0 / 78.84375))
    q = np.asarray(jnp.clip(jnp.asarray(im) - 0.8359375, 0.0, None)
                   / (18.8515625 - 18.6875 * jnp.asarray(im)))
    exact = ((im == (v.astype(np.float64) ** np.float64(y1)).astype(np.float32))
             & (np.asarray(jnp.power(jnp.asarray(q), 1.0 / 0.1593017578125))
                == (q.astype(np.float64) ** np.float64(y2)).astype(np.float32)))
    assert exact.mean() > 0.99
    assert np.array_equal(L_t[exact], L_j[exact])
    assert float(np.max(np.abs(L_t - L_j) / np.maximum(L_j, 0.005))) <= 1e-4


def _band_inputs(rng, C, B, F, shapes):
    gis, Es = [], []
    for h, w in shapes:
        base = 30.0 + 20.0 * rng.rand(B, 2 * C, F, h, w).astype(np.float32)
        gis.append(base)
        Es.append(base + rng.randn(B, 2 * C, F, h, w).astype(np.float32))
    return gis, Es


def _luts(m, rhos, C):
    return np.stack([np.stack([m.csf.logS_of_logL(r, m.omega[0 if cc < 3 else 1],
                                                  cc if cc < 3 else 0) for cc in range(C)])
                     for r in rhos])


@pytest.mark.parametrize("C", [4, 3])
def test_band_masking_wide_matches_fused_raw(metrics, C):
    mj, mt = metrics
    params = mj._masking_params()
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    sens = 10.0 ** (mj.sensitivity_correction / 20.0)
    rng = np.random.RandomState(2)
    (gi,), (E,) = _band_inputs(rng, C, 1, 2, [(32, 256)])
    luts = _luts(mj, [6.08], C)
    gains = np.array([1.0, 1.45, 1.0, 1.0], np.float32)[:C]
    fused = make_fused_mult_mutual_raw(luts[0], x0, x1, gains, sens, params,
                                       lambda M: mk_j.phase_uncertainty(M, params),
                                       False, 2.0, pool_beta=2.0)
    q_j = np.asarray(fused(jnp.asarray(gi), jnp.asarray(E)))

    k = bm_t.BandConsts.make(mt._masking_params(), C, x0, x1, sens, False, 2.0)
    sums = bm_t.band_masking([torch.from_numpy(gi)], [torch.from_numpy(E)],
                             torch.from_numpy(luts), [2.0], k)
    q_t = bm_t.pooled_norm(sums[0], 32, 256, 2.0).numpy()
    assert q_t.shape == q_j.shape == (1, C, 2)
    assert _rel(q_t, q_j) <= 1e-4


def test_band_masking_narrow_stack_matches_band_stack(metrics):
    """Three narrow bands in one launch; the 5x16 band skips the blur."""
    mj, mt = metrics
    params = mj._masking_params()
    C = 4
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    shapes = [(16, 64), (8, 32), (5, 16)]
    luts = _luts(mj, [1.5, 0.75, 0.38], C)
    gains = np.array([1.0, 1.45, 1.0, 1.0], np.float32)
    rng = np.random.RandomState(3)
    gis, Es = _band_inputs(rng, C, 1, 3, shapes)
    stack = make_band_stack(luts, x0, x1, gains, 1.23, params, False, 2.0, 2.0, shapes,
                            interpret=True)
    q_j = [np.asarray(q) for q in stack([jnp.asarray(g) for g in gis],
                                        [jnp.asarray(e) for e in Es])]

    k = bm_t.BandConsts.make(mt._masking_params(), C, x0, x1, 1.23, False, 2.0)
    sums = bm_t.band_masking([torch.from_numpy(g) for g in gis],
                             [torch.from_numpy(e) for e in Es],
                             torch.from_numpy(luts), [2.0] * 3, k)
    for i, (h, w) in enumerate(shapes):
        q_t = bm_t.pooled_norm(sums[i], h, w, 2.0).numpy()
        assert q_t.shape == q_j[i].shape
        assert _rel(q_t, q_j[i]) <= 1e-4, i


@pytest.mark.parametrize("shape", [(1, 1, 6, 1, 1), (2, 300)])
def test_csf_lut_matches_pallas_lookup(metrics, shape):
    mj, _ = metrics
    luts = _luts(mj, [0.1], 4)[0]
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    rng = np.random.RandomState(4)
    logL = rng.uniform(x0 - 1.0, x1 + 1.0, shape).astype(np.float32)
    logL.reshape(-1)[:2] = [x0, x1]  # both ends of the table
    look = lut_j._make_lookup(None, luts, x0, x1)
    S_pallas = np.asarray(look(jnp.asarray(logL)))
    S_jnp = np.asarray(lut_j._jnp_lookup(jnp.asarray(logL), luts, x0, x1))
    S_t = lut_t.csf_lut(torch.from_numpy(logL), torch.from_numpy(luts), x0, x1).numpy()
    assert S_t.shape == S_pallas.shape == (4,) + shape
    assert float(np.max(np.abs(S_t - S_pallas) / S_pallas)) <= 1e-5
    assert float(np.max(np.abs(S_t - S_jnp) / S_jnp)) <= 1e-5


def _lut_kernel_model(n, C, offset, sms):
    """The element split of ``csrc/csf_lut.cu`` for n elements whose logL
    starts ``offset`` floats past a 16-byte boundary (output and gradient
    planes start on one): the grid (``lut_blocks``, 256 threads, at most 8
    blocks an SM), the vector body over groups of 4 where logL is aligned,
    then the scalar loop. Returns, in the order the threads take them, each
    channel's access as (element indices, channel, whether it is one 16-byte
    access: a group of 4 in a plane that starts on a 16-byte boundary)."""
    vec = offset % 4 == 0
    n4 = n // 4 if vec else 0
    work = n4 + n % 4 if vec else n
    blocks = min(-(-work // 256), sms * 8)
    threads = blocks * 256
    steps = []
    for tid in range(threads):
        for q in range(tid, n4, threads):
            idx = list(range(4 * q, 4 * q + 4))
            for c in range(C):
                # forward: out plane c; backward: g plane c (the output is
                # one plane, aligned)
                steps.append((idx, c, (c * n + 4 * q) % 4 == 0))
        for i in range(4 * n4 + tid, n, threads):
            for c in range(C):
                steps.append(([i], c, False))
    return steps


@pytest.mark.parametrize("n, offset", [(1, 0), (3, 0), (4, 0), (4097, 0), (4097, 1),
                                       (20003, 0), (20000, 3), (8192, 0)])
@pytest.mark.parametrize("C", [3, 4])
def test_csf_lut_kernel_model_matches_plain(metrics, n, offset, C):
    """Every element taken once, by the vector body or the scalar loop, each
    16-byte access aligned, and the results, computed in the
    order the threads take the elements, within 1e-6 of ``csf_lut_plain`` /
    ``csf_lut_bwd_plain`` (torch's CPU pow rounds the lanes of its vector
    body and its tail apart, so a reordered call can differ by an ulp; the
    card tests hold the kernel to the plain versions bit for bit)."""
    mj, _ = metrics
    luts = torch.from_numpy(_luts(mj, [0.1], 4)[0][:C].copy())
    x0, x1 = float(mj.csf.log_L_bkg[0]), float(mj.csf.log_L_bkg[-1])
    rng = np.random.RandomState(n + offset)
    logL = torch.from_numpy(rng.uniform(x0 - 0.5, x1 + 0.5, n).astype(np.float32))
    g = torch.from_numpy(rng.randn(C, n).astype(np.float32))
    steps = _lut_kernel_model(n, C, offset, sms=1)
    seen = torch.zeros((C, n), dtype=torch.int64)
    for idx, c, is_vec in steps:
        assert not is_vec or len(idx) == 4
        seen[c, torch.tensor(idx)] += 1
    assert bool((seen == 1).all())
    vec_groups = sum(1 for idx, c, _ in steps if len(idx) == 4 and c == 0)
    assert vec_groups == (n // 4 if offset % 4 == 0 else 0)
    order = torch.tensor([i for idx, c, _ in steps if c == 0 for i in idx])
    out = torch.full((C, n), float("nan"))
    d_out = torch.full((n,), float("nan"))
    out[:, order] = lut_t.csf_lut_plain(logL[order], luts, x0, x1)
    d_out[order] = lut_t.csf_lut_bwd_plain(logL[order], g[:, order], luts, x0, x1)
    assert _rel(out, lut_t.csf_lut_plain(logL, luts, x0, x1)) <= 1e-6
    assert _rel(d_out, lut_t.csf_lut_bwd_plain(logL, g, luts, x0, x1)) <= 1e-6
