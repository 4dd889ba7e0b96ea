"""The blur's adjoint and the blur kernel's index maps (CPU).

``blur_adjoint_plain`` (the plain version of the blur kernel's adjoint mode)
against ``jax.vjp`` of the JAX package's blur, both its XLA plain blur and
``blur_tpu`` (through the custom VJP the JAX metric uses, the Pallas forward
in interpret mode), and against autograd of ``blur_plain``, within 1e-6 of
max|x_bar|. Then a numpy model of ``csrc/blur.cu``: its strips, runs, chunks,
shared-memory ring slots, reflected (or, in the adjoint mode, zeroed) rows
and columns, tap order and edge folds, each ring read checked to find the
row it expects, held bit for bit against ``blur_plain`` and
``blur_adjoint_plain`` at odd sizes. Inputs are seeded numpy arrays.
"""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from colorvideovdp_tpu.ops import blur as blur_j  # noqa: E402
from colorvideovdp_tpu.ops.kernels.blur_halo import can_blur_tpu  # noqa: E402
from colorvideovdp_tpu_torch.ops.blur import (  # noqa: E402
    blur_adjoint_plain, blur_plain, gaussian_kernel1d)
from colorvideovdp_tpu_torch.ops.kernels import blur as blr  # noqa: E402

# (taps, sigma, shape): the calibrated phase-uncertainty blur, a plane of
# H = r + 1 rows (both folds reach every row), the texture models' 33 taps.
CASES = [(13, 3.0, (2, 17, 129)), (13, 3.0, (3, 40, 200)), (13, 3.0, (2, 7, 50)),
         (33, 8.0, (1, 40, 70))]


def _xla_blur(k):
    return lambda x: blur_j._blur_1d(blur_j._blur_1d(x, k, -2), k, -1)


def _vjp(fn, x, g):
    return np.asarray(jax.jit(lambda a, b: jax.vjp(fn, a)[1](b)[0])(jnp.asarray(x),
                                                                     jnp.asarray(g)))


@pytest.mark.parametrize("n, sigma, shape", CASES)
def test_blur_adjoint_plain_matches_jax_vjp(n, sigma, shape):
    rng = np.random.RandomState(21)
    k = gaussian_kernel1d(n, sigma)
    x = rng.rand(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    ours = blur_adjoint_plain(torch.from_numpy(g), k).numpy()
    xt = torch.from_numpy(x).requires_grad_()
    (auto,) = torch.autograd.grad(blur_plain(xt, k), xt, torch.from_numpy(g))
    refs = {"autograd": auto.numpy()}
    refs["xla"] = _vjp(_xla_blur(k), x, g)
    if can_blur_tpu(shape, n):
        refs["blur_tpu"] = _vjp(blur_j._blur_tpu_diff(n, sigma), x, g)
    assert ("blur_tpu" in refs) == (n == 13 and shape[-2] >= 16)
    for name, ref in refs.items():
        assert np.abs(ref).max() > 0
        assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max(), name


def test_blur_adjoint_is_the_transpose():
    """<blur(x), g> == <x, blur_adjoint(g)> in float64 on a plane whose
    folds overlap, and the wrapper takes the plain version on the CPU."""
    rng = np.random.RandomState(22)
    k = gaussian_kernel1d(9, 2.0)
    x = torch.from_numpy(rng.rand(2, 5, 9)).double()
    g = torch.from_numpy(rng.randn(2, 5, 9)).double()
    lhs = float((blur_plain(x, k) * g).sum())
    rhs = float((x * blur_adjoint_plain(g, k)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    gf = g.float()
    before = blr.blur_adjoint.launches
    assert torch.equal(blr.blur_adjoint(gf, k), blur_adjoint_plain(gf, k))
    assert blr.blur_adjoint.launches == before


# csrc/blur.cu's geometry: threads a block (= staged columns a ring row), rows
# a chunk, chunks in flight, and the blocks below which a shorter run is taken.
BT, CM, AHEAD, MIN_BLOCKS = 256, 16, 2, 900


def _choose_run(P, H, strips):
    """blur.cu launch_blur's run length (run = 0)."""
    for cand in (128, 64, 32):
        if P * strips * math.ceil(H / cand) >= MIN_BLOCKS:
            return cand
    return CM


def _reflect(i, n):
    """common.cuh reflect_clamp."""
    i = np.where(i < 0, -i, i)
    i = np.where(i >= n, 2 * n - 2 - i, i)
    return np.clip(i, 0, n - 1)


def _fold_edges(acc, j, n, t, s):
    """blur.cu fold_edges: the left fold, then the right, in tap order."""
    r = (len(t) - 1) // 2
    if 1 <= j <= r:
        f = t[r - j] * s(0)
        for q in range(1, r - j + 1):
            f = f + t[r - j - q] * s(q)
        acc = acc + f
    if n - 1 - r <= j <= n - 2:
        q0 = 2 * n - 2 - j - r
        f = t[2 * r] * s(q0)
        for kk in range(1, j + r + 2 - n):
            f = f + t[2 * r - kk] * s(q0 + kk)
        acc = acc + f
    return acc


def _kernel_model(x, taps, adjoint, RUN=None):
    """The blur kernel's blocks, ring and passes in float32 numpy, with the
    kernel's own run length or ``RUN`` rows a block."""
    P, H, W = x.shape
    t = np.asarray(taps, np.float32)
    r = (len(t) - 1) // 2
    halo = (r + 3) // 4 * 4
    SW, RING = BT - 2 * halo, AHEAD * CM + 2 * r
    RUN = RUN or _choose_run(P, H, math.ceil(W / SW))
    tap = [t[2 * r - k] if adjoint else t[k] for k in range(2 * r + 1)]
    y = np.full_like(x, np.nan)
    zero = np.zeros(BT, np.float32)
    for p in range(P):
        for run in range(math.ceil(H / RUN)):
            for strip in range(math.ceil(W / SW)):
                c0, i0 = strip * SW, run * RUN
                n_rows = min(RUN, H - i0)
                n_chunks = math.ceil(n_rows / CM)
                cols = c0 - halo + np.arange(BT)
                inside = (cols >= 0) & (cols < W)
                src = np.where(inside, cols, 0) if adjoint else _reflect(cols, W)
                ring = np.full((RING, BT), np.nan, np.float32)
                tag = np.full(RING, -1)

                def load_group(g):
                    if g >= n_chunks:
                        return
                    t_lo = 0 if g == 0 else g * CM + 2 * r
                    t_hi = min(CM + 2 * r if g == 0 else t_lo + CM, n_rows + 2 * r)
                    for tt in range(t_lo, t_hi):
                        q = i0 - r + tt
                        if adjoint and not 0 <= q < H:
                            row = zero
                        else:
                            row = x[p, int(_reflect(np.array(q), H))][src]
                            if adjoint:
                                row = np.where(inside, row, np.float32(0))
                        ring[tt % RING], tag[tt % RING] = row, tt

                def ring_row(tt, needed):
                    if needed:
                        assert tag[tt % RING] == tt, (tt, tag[tt % RING])
                    return ring[tt % RING]

                for g in range(AHEAD):
                    load_group(g)
                for c in range(n_chunks):
                    acc = [None] * CM
                    for w in range(CM + 2 * r):
                        used = [m for m in range(CM) if 0 <= w - m <= 2 * r]
                        v = ring_row(c * CM + w, any(c * CM + m < n_rows for m in used))
                        for m in used:
                            k = w - m
                            acc[m] = tap[k] * v if k == 0 else acc[m] + tap[k] * v
                    if adjoint:
                        for m in range(CM):
                            if c * CM + m < n_rows:
                                acc[m] = _fold_edges(acc[m], i0 + c * CM + m, H, t,
                                                     lambda q: ring_row(q - i0 + r, True))
                    vs = np.stack(acc)
                    load_group(c + AHEAD)
                    for m in range(CM):
                        if c * CM + m >= n_rows:
                            continue
                        j = i0 + c * CM + m
                        for cb in range(c0, min(c0 + SW, W), 4):
                            base = cb - c0
                            for e in range(4):
                                if cb + e >= W:
                                    continue
                                o = tap[0] * vs[m, base + e + halo - r]
                                for k in range(1, 2 * r + 1):
                                    o = o + tap[k] * vs[m, base + e + halo - r + k]
                                if adjoint:
                                    o = _fold_edges(o, cb + e, W, t,
                                                    lambda q: vs[m, q - c0 + halo])
                                y[p, j, cb + e] = o
    return y


@pytest.mark.parametrize("n, shape", [(13, (1, 70, 500)), (13, (2, 17, 129)), (13, (1, 7, 30)),
                                      (33, (1, 40, 70)), (3, (1, 9, 251)), (1, (1, 3, 5)),
                                      (25, (1, 13, 13))])
@pytest.mark.parametrize("adjoint", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("run", [None, 32], ids=["own-run", "run32"])
def test_blur_kernel_model_matches_plain(n, shape, adjoint, run):
    """Several strips and runs (the kernel's own run length, and 32 rows: two
    chunks a run), W % 4 != 0, H = r + 1, both edge folds in one strip,
    radius 0 and 16."""
    rng = np.random.RandomState(23)
    k = gaussian_kernel1d(n, max(1.0, (n - 1) / 4))
    x = rng.randn(*shape).astype(np.float32)
    model = _kernel_model(x, k, adjoint, run)
    plain = (blur_adjoint_plain if adjoint else blur_plain)(torch.from_numpy(x), k).numpy()
    assert np.array_equal(model, plain)
