"""The halo mode of the one-pass band kernel (``ops/kernels/band_pooled.py``
``band_pooled_halo``), the sharded route's halo bands, against the previous
halo route and the JAX package.

On CPU tensors the port runs the plain version, ``band_pooled_halo_plain``:
the expand of the next level's rows at each slab row's reflected global row,
stage A, then the halo'd stages B and C. It must give, bit for bit, the
previous route's sums: ``band_masking_halo_plain`` fed ``halo_rows`` of
``expand_slab``. The slabs come from ``parallel/sharding.py`` itself, with
its row exchange between ranks replaced by slices of the whole arrays. Then
two gloo ranks on the CPU score an image whose halo bands take a sharded and
a replicated gn, against single-device scoring and JAX.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402
from colorvideovdp_tpu_torch.parallel import run_ranks  # noqa: E402
from colorvideovdp_tpu_torch.parallel import sharding as sh  # noqa: E402

# A band of 64 rows split over 4 ranks (16-row slabs), its next level 32.
C, B, F, H, W, N_SPACE = 4, 1, 2, 64, 150, 4


def _mesh(s):
    mesh = sh.Mesh.__new__(sh.Mesh)
    mesh.n_space, mesh.s = N_SPACE, s
    return mesh


def _exchange_from(full):
    """``exchange_rows`` of a rank whose slab is cut from ``full``: the
    neighbours' edge rows, zeros past a global edge."""
    def exchange(x, r, mesh):
        h_loc = x.shape[-2]
        lo, hi = mesh.s * h_loc, (mesh.s + 1) * h_loc
        assert torch.equal(x, full[..., lo:hi, :])
        z = x.new_zeros(x.shape[:-2] + (r, x.shape[-1]))
        above = full[..., lo - r:lo, :] if mesh.s > 0 else z
        below = full[..., hi:hi + r, :] if mesh.s < mesh.n_space - 1 else z
        return above, below
    return exchange


def _band(seed):
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    m._ensure_pyramids(W, H)
    k, luts = m._band_tables(C)
    rng = np.random.RandomState(seed)
    gi = torch.from_numpy((30 + 20 * rng.rand(B, 2 * C, F, H, W)).astype(np.float32))
    return k, luts, gi, pyr.reduce_plain(gi)


@pytest.mark.parametrize("gn_sharded", [True, False], ids=["gn-sharded", "gn-replicated"])
@pytest.mark.parametrize("s", [0, 1, N_SPACE - 1], ids=["first", "middle", "last"])
def test_halo_mode_plain_is_the_previous_route(monkeypatch, s, gn_sharded):
    """The halo mode's plain version (and the wrapper on CPU tensors) from
    ``halo_rows(gi)`` and ``halo_gn(gn)`` gives, bit for bit,
    ``band_masking_halo_plain`` fed ``halo_rows(expand_slab(gn))``; the gn
    rows handed over are the rank's slab with 5 rows of each neighbour, or
    the replicated level whole."""
    k, luts, gi, gn = _band(seed=3 + s)
    mesh, h_loc = _mesh(s), H // N_SPACE
    monkeypatch.setattr(sh, "exchange_rows", _exchange_from(gi))
    x = sh.halo_rows(gi[..., s * h_loc:(s + 1) * h_loc, :], mesh)
    if gn_sharded:
        hn_loc = gn.shape[-2] // N_SPACE
        level = sh.Level(gn[..., s * hn_loc:(s + 1) * hn_loc, :], True, gn.shape[-2])
        monkeypatch.setattr(sh, "exchange_rows", _exchange_from(gn))
    else:
        level = sh.Level(gn, False, gn.shape[-2])
    y, row0 = sh.halo_gn(level, mesh)
    E = sh.expand_slab(level, mesh, H, W)
    if gn_sharded:
        assert (y.shape[-2], row0) == (hn_loc + 2 * bp.GN_HALO_ROWS,
                                       s * hn_loc - bp.GN_HALO_ROWS)
    else:
        assert y is gn and row0 == 0
    monkeypatch.setattr(sh, "exchange_rows",
                        _exchange_from(pyr.gausspyr_expand(gn, (H, W))))
    E_h = sh.halo_rows(E, mesh)
    args = ([x], [y], luts[1:2], [2.0], k)
    slab = (s * h_loc, H, row0)
    got = bp.band_pooled_halo_plain(*args, [slab])
    assert torch.equal(got, bm.band_masking_halo_plain([x], [E_h], luts[1:2], [2.0], k, [h_loc]))
    assert torch.equal(bp.band_pooled_halo(*args, [slab]), got)
    assert got.shape == (1, B, C, F) and bool((got > 0).all())


def test_halo_mode_guards():
    """gn rows that do not hold what the slab's expand reads, a slab without
    its halo rows and a contrast-band coding are refused."""
    k, luts, gi, gn = _band(seed=1)
    r, h_loc = bm.HALO_ROWS, H // N_SPACE
    x = gi[..., :h_loc + 2 * r, :]
    with pytest.raises(ValueError, match="rows"):
        bp.band_pooled_halo([x], [gn[..., 4:, :]], luts[:1], [1.0], k, [(h_loc, H, 4)])
    with pytest.raises(ValueError, match="HALO_ROWS"):
        bp.band_pooled_halo([x[..., :2 * r, :]], [gn], luts[:1], [1.0], k, [(0, H, 0)])
    import dataclasses

    with pytest.raises(ValueError, match="raw codings"):
        bp.band_pooled_halo([x], [gn], luts[:1], [1.0], dataclasses.replace(k, coding="log"),
                            [(h_loc, H, 0)])


def test_sharded_image_1x2_hands_gn_rows_to_the_halo_mode(tmp_path):
    """A 128x256 image on a (1, 2) mesh of gloo ranks: level 1 is
    slab-reduced, so band 0's halo launch takes 5 rows of each neighbour of
    its sharded gn, and band 1's its replicated gn whole; the JOD equals
    single-device scoring's and JAX's within 1e-4."""
    rng = np.random.RandomState(13)
    ref = rng.randint(0, 255, (128, 256, 3), dtype=np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(128, 256, 3) * 12).astype(np.int16),
                   0, 255).astype(np.uint8)
    paths = [str(tmp_path / f"{n}.npy") for n in ("t", "r")]
    for p, a in zip(paths, (test, ref)):
        np.save(p, a)
    spec = dict(test=paths[0], reference=paths[1], dim_order="HWC", fps=0,
                display_name="standard_4k", batch=1)
    res = run_ranks(sh.score_rank, 2, (spec,), timeout_s=600, device="cpu")
    q_single, _ = ct.cvvdp(display_name="standard_4k", device="cpu").predict(
        test, ref, dim_order="HWC")
    q_jax, _ = cj.cvvdp(display_name="standard_4k", quiet=True).predict(
        test, ref, dim_order="HWC")
    g = bp.GN_HALO_ROWS
    for r in res:
        route = r["route"]
        assert route["levels"] == [0, 1] and route["halo_bands"] == [0, 1]
        assert route["halo_gn_rows"] == [(32 + 2 * g, r["s"] * 32 - g), (32, 0)]
        assert abs(float(r["jod"]) - float(q_single)) <= 1e-4, (float(r["jod"]), float(q_single))
        assert abs(float(r["jod"]) - float(q_jax)) <= 1e-4, (float(r["jod"]), float(q_jax))
