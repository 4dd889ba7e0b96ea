"""The port's mesh path in every configuration (``colorvideovdp_tpu_torch/
parallel``): the weber_g0_ref and log codings through the band kernel's halo
mode, a configuration off the band kernel through the generic chain on
whole levels, the sharded heatmap and the sharded loss step, against the
JAX package's single-device ``predict`` and ``jax.value_and_grad`` of its
``get_loss_fn`` on the same seeded arrays.

One module-scoped spawn of 4 gloo ranks on the CPU runs every mesh case. The
in-process tests hold the plain versions the mesh path adds: the halo mode's
plain version in every coding, pooled and with D, bit for bit against the
whole band's on the owned rows, and each collective's adjoint against
autograd of the gathered computation, with the ranks simulated by threads
whose collectives meet at a barrier.
"""

import functools
import threading

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import counted_wrappers  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402
from colorvideovdp_tpu_torch.parallel import launch, run_ranks  # noqa: E402
from colorvideovdp_tpu_torch.parallel import sharding as sh  # noqa: E402
from colorvideovdp_tpu_torch.utils.config import write_parameters  # noqa: E402

JOD_TOL = 2e-4  # as tests/test_torch_sharding.py holds images
HEATMAP_TOL = 2e-3  # the JAX package's own sharded heatmap bound (tests/test_sharding.py:92)
LOSS_TOL, GRAD_TOL = 1e-4, 1e-3  # as tests/test_torch_loss.py
H, W = 128, 192

# name: (configuration, mesh batch groups, pairs, heatmap)
SCORE_CASES = {
    "g0ref-1x4": ({"contrast": "weber_g0_ref"}, 1, 1, None),
    "g0ref-2x2": ({"contrast": "weber_g0_ref"}, 2, 2, None),
    "log-1x4": ({"contrast": "log"}, 1, 1, None),
    "log-2x2": ({"contrast": "log"}, 2, 2, None),
    "hard-clamp-1x4": ({"dclamp_type": "hard"}, 1, 1, None),
    "raw-heatmap-1x4": ({}, 1, 1, "raw"),
    "supra-heatmap-1x4": ({}, 1, 1, "supra-threshold"),
}
# name: (mesh batch groups, pairs)
LOSS_CASES = {"loss-2x2": (2, 2), "loss-1x4": (1, 1)}


def _images(B, seed):
    rng = np.random.RandomState(seed)
    ref = rng.randint(0, 255, (B, H, W, 3)).astype(np.int16)
    test = np.clip(ref + rng.randn(B, H, W, 3) * 14, 0, 255).astype(np.uint8)
    return test, ref.astype(np.uint8)


def _loss_pair(B, seed=17):
    rng = np.random.RandomState(seed)
    ref = rng.rand(B, 3, 1, H, W).astype(np.float32)
    test = np.clip(ref + rng.randn(*ref.shape).astype(np.float32) * 0.1, 0, 1)
    return test, ref


def _save(d, name, test, ref):
    paths = [str(d / f"{name}_{k}.npy") for k in ("t", "r")]
    for p, a in zip(paths, (test, ref)):
        np.save(p, a)
    return dict(zip(("test", "reference"), paths))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One 4-rank spawn: every case of SCORE_CASES and LOSS_CASES."""
    d = tmp_path_factory.mktemp("configs4")
    jobs, data = [], {}
    for i, (name, (over, batch, B, hm)) in enumerate(SCORE_CASES.items()):
        test, ref = _images(B, seed=20 + i)
        data[name] = (test, ref)
        spec = dict(_save(d, name, test, ref), dim_order="BHWC", fps=0,
                    display_name="standard_4k", batch=batch, **over)
        if hm:
            spec["heatmap"] = hm
        jobs.append((sh.score_rank, (spec,)))
    for name, (batch, B) in LOSS_CASES.items():
        test, ref = _loss_pair(B)
        data[name] = (test, ref)
        jobs.append((sh.score_rank, (dict(_save(d, name, test, ref), display_name="standard_4k",
                                          batch=batch, loss=True),)))
    res = run_ranks(launch.run_jobs, 4, (jobs,), timeout_s=600, device="cpu")
    names = list(SCORE_CASES) + list(LOSS_CASES)
    return {"data": data, "res": {n: [r[j] for r in res] for j, n in enumerate(names)},
            "dir": d}


@functools.lru_cache(maxsize=None)
def _config(root, **over):
    return write_parameters(f"{root}/{'_'.join(f'{k}-{v}' for k, v in over.items())}", **over) \
        if over else None


@pytest.mark.parametrize("name", list(SCORE_CASES))
def test_mesh_scoring_matches_jax_predict(world4, name):
    """Every rank's JOD (and heatmap) against the JAX package's single-device
    ``predict``: the codings take the halo mode at band 0 (64- and 32-row
    slabs of the 128-row image), the hard clamp the generic chain."""
    over, batch, B, hm = SCORE_CASES[name]
    test, ref = world4["data"][name]
    mj = cj.cvvdp(display_name="standard_4k", quiet=True, heatmap=hm,
                  config_paths=_config(str(world4["dir"]), **over))
    want, stats = mj.predict(test if B > 1 else test[0], ref if B > 1 else ref[0],
                             dim_order="BHWC" if B > 1 else "HWC")
    want = np.asarray(want, np.float64).reshape(-1)
    generic = "dclamp_type" in over
    for r in world4["res"][name]:
        route = r["route"]
        assert route["chain"] == ("generic" if generic else "band")
        assert route["halo_bands"] == ([] if generic else [0]), route
        got = np.asarray(r["jod"], np.float64).reshape(-1)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=JOD_TOL)
        np.testing.assert_array_equal(r["Q_per_ch"], world4["res"][name][0]["Q_per_ch"])
        if hm:
            h_j = np.asarray(stats["heatmap"], np.float32)
            h_t = r["heatmap"].astype(np.float32).reshape(h_j.shape)
            assert r["heatmap"].dtype == np.float16
            assert np.abs(h_t - h_j).max() <= HEATMAP_TOL
            assert np.array_equal(r["heatmap"], world4["res"][name][0]["heatmap"])
            assert r["launches"]["band_pooled_d_halo"] == 0  # CPU tensors: the plain version


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(B):
    """The value and test gradient of the JAX package's ``get_loss_fn`` (its
    ``block``: colour conversion and interleave, then ``_process_block`` and
    the pooling) in two stages: the conversion op by op, its vector-Jacobian
    product through ``jax.vjp``, and the rest jitted under
    ``jax.value_and_grad``. With the conversion jitted too, XLA's last-bit
    rounding of the converted frames moves the gradient at B = 1 and
    128x192 by 2.6e-3 of max|g| in a cluster of about 250 pixels (a
    near-tie, where a 1-ulp change of the input moves the gradient); op by
    op (minutes on a CPU) the port's single-device gradient agrees with
    JAX's within 7e-6, and this staged evaluation's within 8e-6."""
    m = cj.cvvdp(display_name="standard_4k", quiet=True)
    m._ensure_pyramids(W, H)
    dm = m.display_photometry
    test, ref = _loss_pair(B)

    def colour(t, r):
        return m._interleave_tr(dm.source_2_target_colorspace(t, "DKLd65"),
                                dm.source_2_target_colorspace(r, "DKLd65"))

    def pooled(R):
        Q_per_ch, _, _ = m._process_block(R, temp_ch=1, is_image=True)
        return jnp.mean(10.0 - m.do_pooling_and_jods(Q_per_ch))

    R, vjp = jax.vjp(colour, jnp.asarray(test), jnp.asarray(ref))
    v, g_R = jax.jit(jax.value_and_grad(pooled))(R)
    return float(v), np.asarray(vjp(g_R)[0])


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_mesh_loss_step_matches_jax_value_and_grad(world4, name):
    """``shard_loss_fn``: the loss on every rank within 1e-4 of JAX's, and the
    ranks' gradient slabs, put together, within 1e-3 of max|g|."""
    batch, B = LOSS_CASES[name]
    v_j, g_j = _jax_value_and_grad(B)
    got = np.full_like(g_j, np.nan)
    for r in world4["res"][name]:
        assert abs(r["loss"] - v_j) <= LOSS_TOL, (r["loss"], v_j)
        assert r["loss"] == world4["res"][name][0]["loss"]
        g = r["grad"]
        bl, hl = g.shape[0], g.shape[-2]
        assert (bl, hl) == (B // batch, H * batch // 4)
        got[r["b"] * bl:(r["b"] + 1) * bl, ..., r["s"] * hl:(r["s"] + 1) * hl, :] = g
    assert np.abs(g_j).max() > 0
    assert np.abs(got - g_j).max() <= GRAD_TOL * np.abs(g_j).max()


# ---------------------------------------------------------------------------
# The halo mode's plain version in every coding, against the whole band

C, B1, F1, HB, WB, N_SPACE = 4, 1, 2, 64, 160, 4  # a band of 64 rows, 16-row slabs


def _exchange_from(full):
    """``exchange_rows`` of a rank whose slab is cut from ``full``."""
    def exchange(x, r, mesh):
        h_loc = x.shape[-2]
        lo, hi = mesh.s * h_loc, (mesh.s + 1) * h_loc
        z = x.new_zeros(x.shape[:-2] + (r, x.shape[-1]))
        above = full[..., lo - r:lo, :] if mesh.s > 0 else z
        below = full[..., hi:hi + r, :] if mesh.s < mesh.n_space - 1 else z
        return above, below
    return exchange


def _mesh(s, n_space=N_SPACE, b=0, n_batch=1):
    mesh = sh.Mesh.__new__(sh.Mesh)
    mesh.n_batch, mesh.n_space, mesh.b, mesh.s = n_batch, n_space, b, s
    mesh.backend, mesh.token = None, None
    mesh.space_group = mesh.batch_group = None
    return mesh


def _coding_band(coding, seed, root):
    cp = write_parameters(str(root / coding), contrast=coding)
    m = ct.cvvdp(display_name="standard_4k", device="cpu", config_paths=cp)
    m._ensure_pyramids(WB, HB)
    k, luts = m._band_tables(C)
    rng = np.random.RandomState(seed)
    lo, span = (-1.0, 2.0) if coding == "log" else (30.0, 20.0)
    gi = torch.from_numpy((lo + span * rng.rand(B1, 2 * C, F1, HB, WB)).astype(np.float32))
    return k, luts, gi, pyr.reduce_plain(gi)


def _halo_inputs(monkeypatch, gi, gn, s, gn_sharded):
    mesh, h_loc = _mesh(s), HB // N_SPACE
    monkeypatch.setattr(sh, "exchange_rows", _exchange_from(gi))
    x = sh.halo_rows(gi[..., s * h_loc:(s + 1) * h_loc, :], mesh)
    if gn_sharded:
        hn_loc = gn.shape[-2] // N_SPACE
        level = sh.Level(gn[..., s * hn_loc:(s + 1) * hn_loc, :], True, gn.shape[-2])
        monkeypatch.setattr(sh, "exchange_rows", _exchange_from(gn))
    else:
        level = sh.Level(gn, False, gn.shape[-2])
    y, row0 = sh.halo_gn(level, mesh)
    return x, y, (s * h_loc, HB, row0)


@pytest.fixture
def one_thread():
    """PyTorch's CPU log10 and pow may differ by an ulp between a vector
    body and a scalar tail: one thread and 16-column rows keep every element
    of the slab and of the whole band in a vector body."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("gn_sharded", [True, False], ids=["gn-sharded", "gn-replicated"])
@pytest.mark.parametrize("s", [0, 1, N_SPACE - 1], ids=["first", "middle", "last"])
@pytest.mark.parametrize("coding", bm.CODINGS)
def test_halo_plain_is_the_whole_band_bit_for_bit(monkeypatch, one_thread, tmp_path, coding, s,
                                                  gn_sharded):
    """``band_pooled_halo_plain`` and ``band_pooled_d_halo_plain`` on rank s's
    slab (``halo_rows`` of gi, ``halo_gn`` of gn) give, bit for bit, the
    whole band's D on the owned rows (``band_pooled_d_plain``) and the sums
    of that D; the wrappers on CPU tensors are the plain versions."""
    k, luts, gi, gn = _coding_band(coding, 5 + s, tmp_path)
    assert k.coding == coding
    x, y, slab = _halo_inputs(monkeypatch, gi, gn, s, gn_sharded)
    args = ([x], [y], luts[1:2], [2.0], k, [slab])
    D_whole, _ = bp.band_pooled_d_plain([gi], [gn], luts[1:2], [2.0], k)
    h_loc = HB // N_SPACE
    D_own = D_whole[0][..., s * h_loc:(s + 1) * h_loc, :].contiguous()
    Ds, sums = bp.band_pooled_d_halo_plain(*args)
    assert Ds[0].shape == D_own.shape and torch.equal(Ds[0], D_own)
    want = torch.sum(bm._pow_static(D_own + bm._EPS, k.beta) - bm._EPS ** k.beta, dim=(-2, -1))
    assert torch.equal(sums[0], want)
    assert torch.equal(bp.band_pooled_halo_plain(*args), sums)
    assert torch.equal(bp.band_pooled_halo(*args), sums)
    D2, s2 = bp.band_pooled_d_halo(*args)
    assert torch.equal(D2[0], Ds[0]) and torch.equal(s2, sums)


def test_halo_d_mode_is_counted():
    assert counted_wrappers()["band_pooled_d_halo"] is bp.band_pooled_d_halo


# ---------------------------------------------------------------------------
# The collectives' adjoints, ranks simulated by threads


def _simulate(monkeypatch, n, fn, axis="space"):
    """Run ``fn(mesh, i)`` on n threads, each a rank of a (1, n) mesh (or
    (n, 1) with ``axis`` "batch"), whose ``_all_gather`` and ``_all_reduce``
    meet at a barrier; returns the results in rank order."""
    barrier, slots, local = threading.Barrier(n), [None] * n, threading.local()

    def all_gather(x, group, k, mesh):
        slots[local.i] = x.detach().clone()
        barrier.wait()
        parts = [p.clone() for p in slots]
        barrier.wait()
        return parts

    def all_reduce(x, mesh, op=None, group=None):
        parts = all_gather(x, group, n, mesh)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    monkeypatch.setattr(sh, "_all_gather", all_gather)
    monkeypatch.setattr(sh, "_all_reduce", all_reduce)
    out, errors = [None] * n, []

    def run(i):
        local.i = i
        mesh = _mesh(i, n) if axis == "space" else _mesh(0, 1, b=i, n_batch=n)
        try:
            out[i] = fn(mesh, i)
        except BaseException as e:  # reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0]
    return out


def _slab(x, i, n, axis=-2):
    h = x.shape[axis] // n
    return x.narrow(axis, i * h, h)


def _rng_tensor(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float64))


def test_exchange_rows_adjoint(monkeypatch):
    """Each rank's objective reads its slab and the neighbours' rows; every
    rank's slab gradient is that of the sum of all ranks' objectives."""
    n, r, X = 4, 3, _rng_tensor(0, 2, 5, 24, 7)
    Wa, Wb, Wx = (_rng_tensor(s, n, 2, 5, r if s < 3 else 6, 7) for s in (1, 2, 3))

    def rank(mesh, i):
        x = _slab(X, i, n).clone().requires_grad_()
        above, below = sh.exchange_rows(x, r, mesh)
        f = (Wa[i] * above).sum() + (Wb[i] * below).sum() + (Wx[i] * x ** 2).sum()
        f.backward()
        return x.grad

    got = torch.cat(_simulate(monkeypatch, n, rank), dim=-2)
    Xg = X.clone().requires_grad_()
    total = 0
    for i in range(n):
        x = _slab(Xg, i, n)
        z = torch.zeros_like(x[..., :r, :])
        above = _slab(Xg, i - 1, n)[..., -r:, :] if i > 0 else z
        below = _slab(Xg, i + 1, n)[..., :r, :] if i < n - 1 else z
        total = total + (Wa[i] * above).sum() + (Wb[i] * below).sum() + (Wx[i] * x ** 2).sum()
    total.backward()
    assert torch.allclose(got, Xg.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("axis", ["space", "batch"])
def test_gather_adjoint_keeps_the_own_slab(monkeypatch, axis):
    """``gather_rows`` / ``gather_batch``: every rank evaluates the same
    function of the gathered tensor; its gradient is the own slab's."""
    n, X, Wt = 4, _rng_tensor(4, 4, 3, 8, 5), _rng_tensor(5, 4, 3, 8, 5)
    dim = -2 if axis == "space" else 0

    def rank(mesh, i):
        x = _slab(X, i, n, dim).clone().requires_grad_()
        full = sh.gather_rows(x, mesh) if axis == "space" else sh.gather_batch(x, mesh)
        (Wt * torch.sin(full)).sum().backward()
        return x.grad

    got = torch.cat(_simulate(monkeypatch, n, rank, axis), dim=dim)
    Xg = X.clone().requires_grad_()
    (Wt * torch.sin(Xg)).sum().backward()
    assert torch.equal(got, Xg.grad)


def test_sum_space_adjoint_is_the_identity(monkeypatch):
    """Every rank evaluates the same loss of the summed total: each slab's
    gradient is the total's, not n_space times it."""
    n, X = 4, _rng_tensor(6, 4, 3, 5)

    def rank(mesh, i):
        x = X[i].clone().requires_grad_()
        torch.sum(torch.exp(sh.sum_space(x, mesh)) * 0.5).backward()
        return x.grad

    got = torch.stack(_simulate(monkeypatch, n, rank))
    Xg = X.clone().requires_grad_()
    torch.sum(torch.exp(Xg.sum(0)) * 0.5).backward()
    assert torch.allclose(got, Xg.grad, rtol=1e-12, atol=0)


def test_sharded_reduce_adjoint(monkeypatch):
    """``sharded_reduce`` (``ReduceSlab`` and the row exchange) differentiated
    on every rank against autograd of the whole level's ``reduce_plain``."""
    n = 4
    X = torch.from_numpy(np.random.RandomState(8).rand(1, 2, 1, 192, 260).astype(np.float32))
    Wt = torch.from_numpy(np.random.RandomState(9).randn(1, 2, 1, 96, 130).astype(np.float32))

    def rank(mesh, i):
        x = _slab(X, i, n).clone().requires_grad_()
        (_slab(Wt, i, n) * sh.sharded_reduce(x, mesh, use_kernel=True)).sum().backward()
        return x.grad

    got = torch.cat(_simulate(monkeypatch, n, rank), dim=-2)
    Xg = X.clone().requires_grad_()
    (Wt * pyr.reduce_plain(Xg)).sum().backward()
    assert float((got - Xg.grad).abs().max()) <= 1e-6 * float(Xg.grad.abs().max())


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("gn_sharded", [True, False], ids=["gn-sharded", "gn-replicated"])
@pytest.mark.parametrize("coding", ["weber_g1_ref", "log"])
def test_halo_band_adjoint(monkeypatch, tmp_path, coding, gn_sharded, use_kernel):
    """A halo band end to end: ``halo_rows`` of gi and ``halo_gn`` of gn (a
    row-sharded one, or a replicated one gathered from the slabs, whose
    halo reads go through ``_Partial``) into ``BandPooledHalo``, the sums
    over the space group, the same loss on every rank; the slabs' gradients
    of gi and gn against autograd of the whole band's plain chain. With
    ``use_kernel`` the backward takes the card's route (the CSF LUT's and
    the blur's Functions, the blur over the whole slab), here on their
    plain versions."""
    n = N_SPACE
    k, luts, gi, gn = _coding_band(coding, 11, tmp_path)
    g_w = torch.from_numpy(np.random.RandomState(12).rand(1, B1, C, F1).astype(np.float32))
    slab_h, hn_loc = HB // n, gn.shape[-2] // n

    def rank(mesh, i):
        x = _slab(gi, i, n).clone().requires_grad_()
        y = _slab(gn, i, n).clone().requires_grad_()
        xs = sh.halo_rows(x, mesh)
        level = (sh.Level(y, True, gn.shape[-2]) if gn_sharded
                 else sh.Level(sh.gather_rows(y, mesh), False, gn.shape[-2]))
        ys, row0 = sh.halo_gn(level, mesh)
        sums = bp.band_pooled_halo_sums([xs], [ys], luts[1:2], [2.0], k,
                                        [(i * slab_h, HB, row0)], use_kernel=use_kernel)
        total = sh.sum_space(sums, mesh)
        torch.sum(torch.sqrt(total) * g_w).backward()
        return x.grad, y.grad

    out = _simulate(monkeypatch, n, rank)
    gig, gng = gi.clone().requires_grad_(), gn.clone().requires_grad_()
    whole = bp.band_pooled_sums([gig], [gng], luts[1:2], [2.0], k, use_kernel=False)
    torch.sum(torch.sqrt(whole) * g_w).backward()
    for i, (dx, dy) in enumerate(out):
        want_x = _slab(gig.grad, i, n)
        want_y = gng.grad[..., i * hn_loc:(i + 1) * hn_loc, :]
        assert float((dx - want_x).abs().max()) <= 1e-4 * float(gig.grad.abs().max())
        assert float((dy - want_y).abs().max()) <= 1e-4 * float(gng.grad.abs().max())


def test_sharded_block_gradient(monkeypatch):
    """``_process_block`` under a (1, 2) mesh of threads, differentiated on
    every rank (the slab reduce at level 0, halo bands 0 and 1, band 0's gn
    row-sharded and band 1's replicated, the whole bands and the baseband
    from gathered levels), against autograd of single-device
    ``_process_block`` on the whole block."""
    n, h, w = 2, 128, 256
    R = torch.from_numpy((np.random.RandomState(23).rand(1, 6, 1, h, w) * 50 + 1)
                         .astype(np.float32))
    m = ct.cvvdp(display_name="standard_fhd", device="cpu")
    m._ensure_pyramids(w, h)
    wq = torch.from_numpy(np.random.RandomState(24).rand(1, 3, 1, m.lpyr.get_band_count())
                          .astype(np.float32))
    Rg = R.clone().requires_grad_()
    (m._process_block(Rg, temp_ch=1, is_image=True)[0] * wq).sum().backward()

    def rank(mesh, i):
        x = _slab(R, i, n).clone().requires_grad_()
        Q = m._process_block(x, temp_ch=1, is_image=True, mesh=mesh)[0]
        (Q * wq).sum().backward()
        return x.grad, dict(m.sharded_route)

    out = _simulate(monkeypatch, n, rank)
    assert out[0][1]["levels"] == [0, 1] and out[0][1]["halo_bands"] == [0, 1]
    got = torch.cat([g for g, _ in out], dim=-2)
    assert float((got - Rg.grad).abs().max()) <= 1e-5 * float(Rg.grad.abs().max())
