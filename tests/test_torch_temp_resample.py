"""``temp_resample``: the frame-axis resampling of Q_per_ch to a nominal
frame rate, and the interpolation it uses, against the JAX package (CPU)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import interp as interp_j  # noqa: E402
from colorvideovdp_tpu_torch.ops import interp as interp_t  # noqa: E402

JOD_TOL = 1e-4


@pytest.mark.parametrize("stop,num", [(0.25, 6), (6 / 24, 60), (1.0, 1), (3.7, 241),
                                      (61 / 240, 61)])
def test_linspace32_matches_jnp_linspace(stop, num):
    got = interp_t.linspace32(stop, num)
    assert got.dtype == np.float32 and got[0] == 0 and got.shape == (num,)
    assert num == 1 or got[-1] == np.float32(stop)
    # XLA's division by the constant num - 1 and the product round apart
    # from numpy's: one ulp each.
    np.testing.assert_array_max_ulp(got, np.asarray(jnp.linspace(0.0, stop, num)), maxulp=2)


def test_interp1_and_interp1dim2_match_jax():
    rng = np.random.RandomState(0)
    x = np.sort(rng.rand(9)).astype(np.float32)
    x_q = np.concatenate([rng.rand(40) * 1.4 - 0.2, x[:3]]).astype(np.float32)
    v = rng.randn(9).astype(np.float32)
    a = np.asarray(interp_j.interp1(jnp.asarray(x), jnp.asarray(v), jnp.asarray(x_q)))
    b = interp_t.interp1(torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(x_q))
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7)
    V = rng.randn(2, 9, 3, 5).astype(np.float32)
    a = np.asarray(interp_j.interp1dim2(jnp.asarray(x), jnp.asarray(V), jnp.asarray(x_q)))
    b = interp_t.interp1dim2(torch.from_numpy(x), torch.from_numpy(V), torch.from_numpy(x_q))
    assert b.shape == (2, len(x_q), 3, 5)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def video():
    rng = np.random.RandomState(2)
    ref = (rng.rand(6, 3, 40, 64) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + rng.randint(-25, 25, ref.shape), 0, 255)
    return test.astype(np.uint8), ref


@pytest.mark.parametrize("nominal_fps", [240, 60])
def test_temp_resample_matches_jax(video, nominal_fps):
    test, ref = video
    mj = cj.cvvdp(display_name="standard_4k", temp_resample=True, nominal_fps=nominal_fps,
                  quiet=True)
    mt = ct.cvvdp(display_name="standard_4k", temp_resample=True, nominal_fps=nominal_fps,
                  device="cpu")
    qj, sj = mj.predict(test, ref, dim_order="FCHW", frames_per_second=24)
    qt, st = mt.predict(test, ref, dim_order="FCHW", frames_per_second=24)
    n_res = int(np.ceil(6 / 24 * nominal_fps))
    assert st["N_frames"] == sj["N_frames"] == n_res
    assert st["frames_per_second"] == sj["frames_per_second"] == nominal_fps
    assert st["Q_per_ch"].shape == sj["Q_per_ch"].shape == (1, 4, n_res, mt.lpyr.get_band_count())
    assert np.abs(st["Q_per_ch"] - sj["Q_per_ch"]).max() <= 1e-4 * np.abs(sj["Q_per_ch"]).max()
    assert abs(float(qt) - float(qj)) <= JOD_TOL
    # Resampling moves the JOD: the pooling runs over n_res frames.
    q0, _ = ct.cvvdp(display_name="standard_4k", device="cpu").predict(
        test, ref, dim_order="FCHW", frames_per_second=24)
    assert float(q0) != float(qt)
