"""The port's reporting and host API against the JAX package: the metric
names and info strings, the features and configuration files, checkpoint
updates, the ``debug`` check, ``use_checkpoints``, and the TF32 flags, which
the metric sets off only inside its own calls."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu_torch.metrics import base as base_t  # noqa: E402
from colorvideovdp_tpu_torch.ops import masking as mk_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402


def _image(seed=0, H=32, W=64):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(H, W, 3) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(H, W, 3) * 8).astype(np.int16),
                   0, 255).astype(np.uint8)
    return test, ref


@pytest.mark.parametrize("display", ["standard_4k", "standard_hdr_pq", "sdr_fhd_24"])
def test_names_and_info_string_match_jax(display):
    m_j = cj.cvvdp(display_name=display, quiet=True)
    m_t = ct.cvvdp(display_name=display, device="cpu")
    for name in ("full_name", "short_name", "quality_unit", "get_info_string"):
        assert getattr(m_t, name)() == getattr(m_j, name)(), name
    assert m_t.short_name() == "cvvdp" and m_t.quality_unit() == "JOD"
    assert ct.vq_metric_dict["cvvdp"] is ct.cvvdp


@pytest.mark.parametrize("cls", ["cvvdp_ml_saliency", "cvvdp_ml_transformer"])
def test_ml_names_and_info_string_match_jax(cls):
    from colorvideovdp_tpu.metrics import ml as ml_j

    m_j = getattr(ml_j, cls)(display_name="standard_4k", quiet=True, random_init=True)
    m_t = getattr(ct, cls)(display_name="standard_4k", device="cpu", random_init=True)
    for name in ("full_name", "short_name", "quality_unit", "get_info_string"):
        assert getattr(m_t, name)() == getattr(m_j, name)(), name
    with pytest.raises(ct.vq_exception, match="do not export distograms"):
        m_t.export_distogram({}, "unused.png")


def test_base_class_defaults_match_jax():
    from colorvideovdp_tpu.metrics import base as base_j

    class my_metric_t(base_t.vq_metric):
        pass

    class my_metric_j(base_j.vq_metric):
        pass

    a, b = my_metric_t(), my_metric_j()
    assert (a.full_name(), a.short_name(), a.quality_unit(), a.get_info_string()) == \
        ("my_metric_t", "my-metric-t", "", None)
    assert (b.full_name(), b.short_name(), b.quality_unit(), b.get_info_string()) == \
        ("my_metric_j", "my-metric-j", "", None)
    a.set_base_fname("out/base")
    assert a.base_fname == "out/base"
    a.train(False)
    with pytest.raises(base_t.vq_exception) as e_t:
        a.export_distogram({}, "unused.png")
    with pytest.raises(base_j.vq_exception) as e_j:
        b.export_distogram({}, "unused.png")
    assert str(e_t.value) == str(e_j.value).replace("my-metric-j", "my-metric-t")


def _stats(seed=3, B=1, C=4, F=3, bands=6):
    rng = np.random.RandomState(seed)
    return {"Q_per_ch": rng.rand(B, C, F, bands).astype(np.float32),
            "rho_band": rng.rand(bands) * 30, "frames_per_second": 30.0, "width": 64,
            "height": 32, "N_frames": F}


def test_write_features_to_json_matches_jax(tmp_path):
    """The same stats give the same file; the port's ``block_N_frames`` key is
    left out. Then the files of a real prediction in each package: the same
    keys, values within 1e-4."""
    stats = _stats()
    m_j = cj.cvvdp(display_name="standard_4k", quiet=True)
    m_t = ct.cvvdp(display_name="standard_4k", device="cpu")
    m_j.write_features_to_json(stats, str(tmp_path / "j.json"))
    m_t.write_features_to_json(dict(stats, block_N_frames=3), str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()

    rng = np.random.RandomState(9)
    ref = (rng.rand(32, 64, 3, 3) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + 9, 0, 255).astype(np.uint8)
    kw = dict(dim_order="HWCF", frames_per_second=30)
    m_j.write_features_to_json(m_j.predict(test, ref, **kw)[1], str(tmp_path / "j2.json"))
    m_t.write_features_to_json(m_t.predict(test, ref, **kw)[1], str(tmp_path / "t2.json"))
    fj, ft = (json.loads((tmp_path / f).read_text()) for f in ("j2.json", "t2.json"))
    assert sorted(ft) == sorted(fj)
    for key in fj:
        np.testing.assert_allclose(np.asarray(ft[key], np.float64),
                                   np.asarray(fj[key], np.float64), rtol=1e-4, atol=1e-6)


def test_save_to_config_matches_jax(tmp_path):
    """Recalibrated attributes written back: the same file as JAX's, except
    the date."""
    out = {}
    for pkg, kw in ((cj, dict(quiet=True)), (ct, dict(device="cpu"))):
        m = pkg.cvvdp(display_name="standard_4k", **kw)
        m.mask_p = 2.5
        m.mask_q = np.asarray([1.25, 2.5, 3.0, 3.5], np.float32)
        m.xcm_weights = np.asarray(m.xcm_weights) * np.float32(0.5)
        m.baseband_weight = np.asarray([0.5, 1.5, 4.0, 25.0], np.float32)
        path = tmp_path / f"{pkg.__name__}.json"
        m.save_to_config(str(path), "recalibrated")
        d = json.loads(path.read_text())
        assert d["calibration_date"] != "10/01/2024"
        d.pop("calibration_date")
        out[pkg.__name__] = d
        with pytest.raises(AssertionError):
            m.save_to_config(str(tmp_path / "x.txt"), "not json")
    assert out["colorvideovdp_tpu_torch"] == out["colorvideovdp_tpu"]
    assert out["colorvideovdp_tpu_torch"]["mask_p"] == 2.5


def test_update_from_checkpoint_matches_jax(tmp_path):
    state = {"params.mask_p": torch.tensor(2.4), "params.beta": torch.tensor(2.5),
             "params.mask_q": torch.tensor([1.2, 2.7, 3.5, 3.4]),
             "feature_net.weight": torch.zeros(2)}
    torch.save({"state_dict": state}, tmp_path / "ckpt.pt")
    test, ref = _image(4)
    jods = []
    for pkg, kw in ((cj, dict(quiet=True)), (ct, dict(device="cpu"))):
        m = pkg.cvvdp(display_name="standard_4k", **kw)
        q0 = float(m.predict(test, ref, dim_order="HWC")[0])
        m.update_from_checkpoint(str(tmp_path / "ckpt.pt"))
        assert m.mask_p == pytest.approx(2.4) and m.beta == pytest.approx(2.5)
        assert isinstance(m.mask_p, float) and m.mask_q.shape == (4,)
        assert not hasattr(m, "weight")
        q1 = float(m.predict(test, ref, dim_order="HWC")[0])
        assert q1 != q0
        jods.append(q1)
    assert abs(jods[0] - jods[1]) <= 1e-4, jods


@pytest.mark.parametrize("case", ["image", "video"])
def test_debug_nonfinite_error_matches_jax(case):
    rng = np.random.RandomState(0)
    ref = rng.rand(32, 64, 3).astype(np.float32)
    kw = dict(dim_order="HWC")
    if case == "video":
        ref = np.repeat(ref[..., None], 3, axis=3)
        kw = dict(dim_order="HWCF", frames_per_second=30)
    test = ref.copy()
    test[5, 5, 0] = np.nan
    msgs = []
    for m in (cj.cvvdp(display_name="standard_4k", quiet=True),
              ct.cvvdp(display_name="standard_4k", device="cpu")):
        assert m.debug is False
        m.debug = True
        with pytest.raises(RuntimeError) as e:
            m.predict(test, ref, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == \
        "Non-finite Q_per_ch in block at frame 0 (masking produced NaN/Inf)"


def test_use_checkpoints_and_train_match_jax():
    m_j = cj.cvvdp(display_name="standard_4k", quiet=True, use_checkpoints=True)
    m_t = ct.cvvdp(display_name="standard_4k", device="cpu", use_checkpoints=True)
    assert m_t.use_checkpoints is m_j.use_checkpoints is True
    assert m_t.training_mode is m_j.training_mode is False
    for m in (m_j, m_t):
        m.train()
    assert m_t.training_mode is m_j.training_mode is True
    test, ref = _image(1)
    assert abs(float(m_t.predict(test, ref, dim_order="HWC")[0])
               - float(m_j.predict(test, ref, dim_order="HWC")[0])) <= 1e-4


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _record(monkeypatch, module, name, seen):
    orig = getattr(module, name)

    def hook(*args, **kwargs):
        seen.append(_flags())
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, hook)


def test_tf32_scoped_to_metric_calls(monkeypatch, tf32_on):
    """With both TF32 flags on beforehand: constructing a metric leaves them
    on; inside ``_process_block`` (in ``predict``, in a loss forward and in
    the loss backward, where the band chain is recomputed) they read off;
    after ``predict``, after a loss backward and after an exception inside a
    call they are on again."""
    seen = []
    _record(monkeypatch, mk_t, "lp_norm", seen)  # inside _process_block
    _record(monkeypatch, bm, "_band_sums_plain", seen)  # the band backward's recompute
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    assert _flags() == (True, True)
    test, ref = _image(2)
    m.predict(test, ref, dim_order="HWC")
    assert seen and set(seen) == {(False, False)} and _flags() == (True, True)

    seen.clear()
    fn = m.get_loss_fn(32, 64)
    x = torch.rand(1, 3, 1, 32, 64, requires_grad=True)
    v = fn(x, torch.rand(1, 3, 1, 32, 64))
    assert _flags() == (True, True)
    n_forward = len(seen)
    v.backward()
    assert len(seen) > n_forward and set(seen) == {(False, False)}
    assert _flags() == (True, True) and x.grad.abs().max() > 0

    seen.clear()
    m._process_block(torch.rand(1, 6, 1, 32, 64), temp_ch=1, is_image=True)
    assert seen and set(seen) == {(False, False)} and _flags() == (True, True)

    m.debug = True
    bad = ref.astype(np.float32) / 255
    with pytest.raises(RuntimeError):
        m.predict(np.where(np.arange(64)[None, :, None] == 3, np.nan, bad), bad, dim_order="HWC")
    assert _flags() == (True, True)

    seen.clear()
    ml = ct.cvvdp_ml_saliency(display_name="standard_4k", device="cpu", random_init=True)
    assert _flags() == (True, True)
    ml.predict(test, ref, dim_order="HWC")
    assert _flags() == (True, True)
