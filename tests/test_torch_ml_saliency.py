"""``cvvdp_ml_saliency`` of the PyTorch port end to end against the JAX package
(CPU), on a seeded image pair and a seeded multi-block video with replicate
and symmetric padding; the helpers are in ``test_torch_ml.py``."""

import pytest

pytest.importorskip("jax")

from test_torch_ml import check_matches_jax, jax_metric, weights_dir  # noqa: E402,F401


@pytest.fixture(scope="module")
def mj(weights_dir):  # noqa: F811
    return jax_metric("saliency", weights_dir)


@pytest.mark.parametrize("case", ["image", "replicate", "symmetric"])
def test_ml_saliency_matches_jax(mj, weights_dir, case):  # noqa: F811
    check_matches_jax(mj, weights_dir, "saliency", case)
