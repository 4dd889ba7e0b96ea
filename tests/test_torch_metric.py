"""The whole PyTorch slice against JAX ``cvvdp.predict`` on seeded videos and
an image pair (CPU): |dJOD| <= 1e-4 and Q_per_ch within 1e-4 relative."""

import numpy as np
import pytest

pytest.importorskip("jax")

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu_torch.convert import params_from_jax  # noqa: E402

H, W, N, FPS = 48, 256, 12, 30.0
# Port-side gpu_mem (GB) that gives 5-frame blocks at 48x256 under the
# reference memory model (a=1.6e9, b=16, c=320): blocks of 5, 5 and 2(+3).
SMALL_GPU_MEM = 1.6225


def _video(dtype, seed):
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    ref = (rng.rand(H, W, 3, N) * 0.8 * top).astype(dtype)
    noise = rng.randn(H, W, 3, N) * 0.04 * top
    test = np.clip(ref.astype(np.float64) + noise, 0, top).astype(dtype)
    return test, ref


def _compare(mj, mt, test, ref, **kw):
    Qj, sj = mj.predict(test, ref, **kw)
    Qt, st = mt.predict(test, ref, **kw)
    qj, qt = sj["Q_per_ch"], st["Q_per_ch"]
    assert qt.shape == qj.shape
    assert abs(float(Qj) - float(Qt)) <= 1e-4, (float(Qj), float(Qt))
    assert np.abs(qt - qj).max() <= 1e-4 * np.abs(qj).max()
    return st


@pytest.mark.parametrize("display,padding,dtype,gpu_mem", [
    ("standard_4k", "replicate", np.uint8, None),
    ("standard_hdr_pq", "symmetric", np.uint16, None),
    ("standard_4k", "replicate", np.uint8, SMALL_GPU_MEM),
], ids=["sdr-replicate", "hdr-symmetric", "multi-block"])
def test_video_matches_jax(display, padding, dtype, gpu_mem):
    test, ref = _video(dtype, 7)
    mj = cj.cvvdp(display_name=display, quiet=True, temp_padding=padding)
    mt = ct.cvvdp(display_name=display, device="cpu", temp_padding=padding, gpu_mem=gpu_mem)
    st = _compare(mj, mt, test, ref, dim_order="HWCF", frames_per_second=FPS)
    if gpu_mem is not None:
        assert st["block_N_frames"] == 5  # several blocks and a trailing partial one


@pytest.mark.parametrize("case", ["batch2-float32", "luminance-uint8"])
def test_batch_float_and_luminance_match_jax(case):
    """The inputs the ingest kernel takes besides one 3-channel integer
    video: a batch of two float32 videos, and luminance-only content."""
    test, ref = _video(np.uint8, 17)
    if case == "batch2-float32":
        test = np.stack([test, test[::-1]]).astype(np.float32) / 255
        ref = np.stack([ref, ref]).astype(np.float32) / 255
        dims = "BHWCF"
    else:
        test, ref = test[:, :, :1], ref[:, :, :1]
        dims = "HWCF"
    mj = cj.cvvdp(display_name="standard_4k", quiet=True)
    mt = ct.cvvdp(display_name="standard_4k", device="cpu")
    Qj, sj = mj.predict(test, ref, dim_order=dims, frames_per_second=FPS)
    Qt, st = mt.predict(test, ref, dim_order=dims, frames_per_second=FPS)
    assert np.asarray(Qt).shape == np.asarray(Qj).shape
    assert np.abs(np.asarray(Qt, np.float64) - np.asarray(Qj)).max() <= 1e-4
    qj, qt = sj["Q_per_ch"], st["Q_per_ch"]
    assert qt.shape == qj.shape and qt.shape[0] == (2 if dims[0] == "B" else 1)
    assert np.abs(qt - qj).max() <= 1e-4 * np.abs(qj).max()


def test_image_matches_jax():
    test, ref = _video(np.uint8, 11)
    mj = cj.cvvdp(display_name="standard_fhd", quiet=True)
    mt = ct.cvvdp(display_name="standard_fhd", device="cpu")
    st = _compare(mj, mt, test[..., 0], ref[..., 0], dim_order="HWC")
    assert st["Q_per_ch"].shape[1] == 3


def test_perturbed_parameters_carry_over():
    """mask_p and beta_t perturbed on the JAX metric reach the port through
    params_from_jax and move both packages alike."""
    test, ref = _video(np.uint8, 13)
    mj = cj.cvvdp(display_name="standard_4k", quiet=True)
    mj.mask_p = mj.mask_p * 1.15
    mj.beta_t = 3.0
    mt = ct.cvvdp(display_name="standard_4k", device="cpu")
    d = params_from_jax(mj)
    assert d["mask_p"] == pytest.approx(mj.mask_p) and d["beta_t"] == 3.0
    # Plain values only: numbers, arrays, the configuration strings and flags.
    assert all(isinstance(v, (float, np.ndarray, str, bool)) for v in d.values())
    assert (d["contrast"], d["masking_model"], d["dclamp_type"], d["do_xchannel_masking"]) == (
        "weber_g1", "mult-mutual", "soft", True)
    mt.load_parameters(d)
    _compare(mj, mt, test, ref, dim_order="HWCF", frames_per_second=FPS)
