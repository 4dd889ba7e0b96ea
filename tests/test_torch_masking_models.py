"""Every masking model, difference clamp and the cross-channel mix off, in the
PyTorch port against the JAX package (CPU).

``apply_masking_model`` on seeded contrast and sensitivity tensors for the
13 models of the JAX package (``ops/masking.py:186-311``), the three other
clamps and the mix off, then ``predict`` on an image and a multi-block video
for each of those configurations, written as copies of the default
``cvvdp_parameters.json`` and passed as ``config_paths``. ``ce_g`` and
``k_c``, which the default file lacks, are set for the models that read them.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu.ops import masking as mk_j  # noqa: E402
from colorvideovdp_tpu_torch.ops import masking as mk_t  # noqa: E402
from test_torch_contrast import FPS, SMALL_GPU_MEM, _clip, write_config  # noqa: E402

MODELS = ["mult-none", "add-transducer", "mult-transducer", "add-mutual", "mult-mutual",
          "mult-mutual-old", "add-similarity", "mult-similarity", "mult-transducer-texture",
          "add-transducer-texture", "smooth_clamp_cont", "min_mutual_masking_perc_norm2",
          "fvvdp_ch_gain"]
CONFIGS = ([dict(masking_model=m, ce_g=0.9, k_c=0.5) for m in MODELS]
           + [dict(dclamp_type="hard"), dict(dclamp_type="none"),
              dict(dclamp_type="per_channel", d_max=[2.4, 2.5, 2.6, 2.7]),
              dict(xchannel_masking="off"),
              dict(masking_model="fvvdp_ch_gain", xchannel_masking="off")])
IDS = [MODELS[i] if i < len(MODELS) else "-".join(str(v) for v in c.values())[:24]
       for i, c in enumerate(CONFIGS)]


def _params(metric, over):
    for key, value in over.items():
        if key == "xchannel_masking":
            metric.do_xchannel_masking = value == "on"
        else:
            setattr(metric, key, value if np.isscalar(value) else np.asarray(value, np.float32))
    return metric._masking_params()


@pytest.mark.parametrize("over", CONFIGS, ids=IDS)
def test_masking_model_matches_jax(over):
    """D within 1e-5 of max(1, max|D|), 1e-4 for the texture models (their
    33-tap blur of responses up to 1e4 adds float32 rounding)."""
    rng = np.random.RandomState(0)
    T = ((rng.rand(1, 4, 2, 40, 48) - 0.5) * 2).astype(np.float32)
    R = T + ((rng.rand(1, 4, 2, 40, 48) - 0.5) * 0.2).astype(np.float32)
    S = (rng.rand(1, 4, 2, 40, 48) * 100 + 1).astype(np.float32)
    pj = _params(cj.cvvdp(display_name="standard_4k", quiet=True), over)
    pt = _params(ct.cvvdp(display_name="standard_4k", device="cpu"), over)
    for f in pj.__dataclass_fields__:
        assert np.array_equal(np.asarray(getattr(pt, f)), np.asarray(getattr(pj, f))), f
    D_j = np.asarray(mk_j.apply_masking_model(jnp.asarray(T), jnp.asarray(R), jnp.asarray(S), pj))
    D_t = mk_t.apply_masking_model(torch.from_numpy(T), torch.from_numpy(R),
                                   torch.from_numpy(S), pt).numpy()
    assert D_t.shape == D_j.shape and np.isfinite(D_t).all()
    tol = 1e-4 if "texture" in pt.masking_model else 1e-5
    assert np.abs(D_t - D_j).max() <= tol * max(1.0, np.abs(D_j).max())


@pytest.mark.parametrize("over", CONFIGS, ids=IDS)
def test_predict_matches_jax(tmp_path, over):
    """An image and a 7-frame video (port blocks 3 + 3 + 1) with symmetric
    temporal padding: replicate padding leaves the first frames' transient
    channel at rounding noise around 0, where the add-* models' sign(T)
    jumps by 2 on a last-ulp difference. The JOD within
    1e-4 of max(1, |10 - JOD|): near 10 that is 1e-4; the transducer and
    similarity models give distortions up to 1e5 under the default
    calibration and JODs far below 0, where a float32 pooling sum moves the
    JOD by about 1e-6 of 10 - JOD. Q_per_ch within 1e-4 relative."""
    cp = write_config(tmp_path, **over)
    mj = cj.cvvdp(display_name="standard_4k", quiet=True, config_paths=cp,
                  temp_padding="symmetric")
    mt = ct.cvvdp(display_name="standard_4k", device="cpu", config_paths=cp,
                  gpu_mem=SMALL_GPU_MEM, temp_padding="symmetric")
    assert mt._masking_params().fusable() == (over.get("masking_model") == "mult-mutual")
    test, ref = _clip(5)
    for t, r, kw in ((test[..., 0], ref[..., 0], dict(dim_order="HWC")),
                     (test, ref, dict(dim_order="HWCF", frames_per_second=FPS))):
        Qj, sj = mj.predict(t, r, **kw)
        Qt, st = mt.predict(t, r, **kw)
        qj = float(Qj)
        assert abs(qj - float(Qt)) <= 1e-4 * max(1.0, abs(10.0 - qj)), (qj, float(Qt))
        assert np.abs(st["Q_per_ch"] - sj["Q_per_ch"]).max() <= 1e-4 * np.abs(sj["Q_per_ch"]).max()
    assert st["block_N_frames"] == 3
