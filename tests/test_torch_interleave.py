"""The interleave micro-benchmark's plain versions
(``colorvideovdp_tpu_torch/ops/kernels/interleave.py``) against the Pallas
kernels of the JAX package's ``tools/interleave_bench.py`` (interpret mode),
bit for bit, at the tool's ``--cpu-check`` shape (2, 128, 512); and the port's
tool in its ``--cpu-check`` mode."""

import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from colorvideovdp_tpu_torch.ops.kernels import interleave as il  # noqa: E402
from colorvideovdp_tpu_torch.tools import interleave_bench as ib  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_interleave_bench", os.path.join(REPO, "tools", "interleave_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def halves():
    ev, od, x = ib.make_inputs(*ib.CPU_SHAPE, "cpu")
    return ev, od, x


def test_interleave_matches_pallas(jax_bench, halves):
    ev, od, _ = halves
    want = np.asarray(jax_bench.pallas_interleave(jnp.asarray(ev.numpy()),
                                                  jnp.asarray(od.numpy()), interpret=True))
    got = il.interleave(ev, od).numpy()
    assert got.shape == want.shape == ib.CPU_SHAPE
    assert np.array_equal(got, want)
    assert np.array_equal(il.library_interleave(ev, od).numpy(), want)


def test_concat_matches_pallas(jax_bench, halves):
    ev, od, _ = halves
    want = np.asarray(jax_bench.pallas_concat(jnp.asarray(ev.numpy()), jnp.asarray(od.numpy()),
                                              interpret=True))
    got = il.concat(ev, od).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(il.library_concat(ev, od).numpy(), want)


def test_deinterleave_matches_pallas(jax_bench, halves):
    ev, od, x = halves
    want = [np.asarray(a) for a in jax_bench.pallas_deinterleave(jnp.asarray(x.numpy()),
                                                                 interpret=True)]
    got = [a.numpy() for a in il.deinterleave(x)]
    lib = [a.numpy() for a in il.library_deinterleave(x)]
    for g, lb, w, h in zip(got, lib, want, (ev, od)):
        assert np.array_equal(g, w) and np.array_equal(lb, w) and np.array_equal(g, h.numpy())


def test_interleave_tool_cpu_check(capsys):
    assert ib.main(["--cpu-check"]) == 0
    assert "correctness ok" in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(3, 5, 14), (1, 1, 2)])
def test_interleave_plain_round_trip(shape):
    """Element paths of any size: interleave then de-interleave is exact."""
    P, H, W = shape
    ev, od = (torch.rand(P, H, W // 2) for _ in range(2))
    e2, o2 = il.deinterleave(il.interleave(ev, od))
    assert torch.equal(e2, ev) and torch.equal(o2, od)
    with pytest.raises(ValueError):
        il.deinterleave(torch.rand(P, H, W + 1))
