"""The port's ML checkpoint converter (``colorvideovdp_tpu_torch/tools/
convert_ml_ckpt.py``) against the JAX package's ``tools/convert_ml_ckpt.py``
(CPU): the same arrays from one Lightning-style checkpoint of each family,
the same family and the same errors, a manifest byte for byte the JAX
tool's, and the converted npz scoring as the weights it came from."""

import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu_torch.tools import convert_ml_ckpt as conv_t  # noqa: E402
from test_torch_ml import seeded_weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = {"cvvdp_ml_saliency": ct.cvvdp_ml_saliency,
           "cvvdp_ml_transformer": ct.cvvdp_ml_transformer}


@pytest.fixture(scope="module")
def conv_j():
    spec = importlib.util.spec_from_file_location(
        "jax_convert_ml_ckpt", os.path.join(REPO, "tools", "convert_ml_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def seeded():
    """{family: (metric with seeded weights, its checkpoint-layout weights)}:
    a ``random_init`` metric, the saliency head given the ML tests' seeded
    weights (its random initialisation scores 10 JOD; the transformer's
    responds on this input, the seeded weights' do not)."""
    out = {}
    for family, cls in METRICS.items():
        m = cls(display_name="standard_fhd", device="cpu", random_init=True)
        if family == "cvvdp_ml_saliency":
            m.load_weights(seeded_weights("saliency", 14))
        out[family] = (m, m.ml_weights())
    return out


def _lightning_ckpt(path, weights):
    """A checkpoint as Lightning writes one: the weights as tensors under
    ``state_dict`` beside the trainer's bookkeeping."""
    torch.save({"epoch": 3, "global_step": 120, "pytorch-lightning_version": "2.1.0",
                "state_dict": {k: torch.from_numpy(v) for k, v in weights.items()},
                "hyper_parameters": {"lr": 1e-4}}, path)


def _load(npz):
    with np.load(npz) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("family", sorted(METRICS))
def test_converter_matches_jax_tool(tmp_path, capsys, conv_j, seeded, family):
    weights = seeded[family][1]
    ckpt = str(tmp_path / "cvvdp.ckpt")
    _lightning_ckpt(ckpt, weights)
    conv_t.convert(ckpt, str(tmp_path / "port.npz"))
    conv_j.convert(ckpt, str(tmp_path / "jax.npz"))
    got, want = _load(tmp_path / "port.npz"), _load(tmp_path / "jax.npz")
    assert sorted(got) == sorted(want) == sorted(weights)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], weights[k])
    manifest = conv_t.load_manifest()
    assert conv_t.identify_family(got, manifest) == family
    assert conv_j.identify_family(got, conv_j.load_manifest()) == family
    assert conv_t.validate(got) == conv_j.validate(got) == family
    capsys.readouterr()
    conv_t.main(["--validate", str(tmp_path / "port.npz"), family])
    assert f"valid '{family}' layout, {len(got)} tensors" in capsys.readouterr().out


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_validate_names_the_problem_as_jax_does(conv_j, seeded, fault):
    arrays = dict(seeded["cvvdp_ml_saliency"][1])
    key = sorted(arrays)[0]
    if fault == "missing":
        del arrays[key]
        problem = f"missing key: {key}"
    elif fault == "extra":
        arrays["feature_net.99.weight"] = np.zeros(3, np.float32)
        problem = "unexpected key: feature_net.99.weight"
    else:
        arrays[key] = np.zeros(arrays[key].shape + (2,), np.float32)
        problem = f"shape mismatch: {key} is {list(arrays[key].shape)}"
    with pytest.raises(ValueError) as got:
        conv_t.validate(arrays)
    with pytest.raises(ValueError) as want:
        conv_j.validate(arrays)
    assert problem in str(got.value)
    assert "'cvvdp_ml_saliency' checkpoint layout" in str(got.value)
    assert str(got.value) == str(want.value)


def test_manifest_is_the_jax_tools_byte_for_byte():
    with open(conv_t.MANIFEST, "rb") as f, \
            open(os.path.join(REPO, "tools", "cvvdp_ml_manifest.json"), "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("family", sorted(METRICS))
def test_converted_npz_scores_as_the_seeded_metric(tmp_path, seeded, family):
    m_seed, weights = seeded[family]
    ckpt = str(tmp_path / "cvvdp.ckpt")
    _lightning_ckpt(ckpt, weights)
    conv_t.main([ckpt, str(tmp_path / "cvvdp_ml.npz")])
    m = METRICS[family](display_name="standard_fhd", device="cpu", config_paths=[str(tmp_path)])
    rng = np.random.RandomState(4)
    ref = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + rng.randint(-20, 21, ref.shape), 0, 255).astype(np.uint8)
    got = float(m.predict(test, ref, dim_order="HWC")[0])
    want = float(m_seed.predict(test, ref, dim_order="HWC")[0])
    assert 0.0 < want < 10.0 and got == want
