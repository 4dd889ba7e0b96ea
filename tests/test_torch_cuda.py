"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc; without a card they skip. They do
not import jax, so on a machine without it run them as
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import colorvideovdp_tpu_torch as ct
from colorvideovdp_tpu_torch.ops import pyramid as pyr
from colorvideovdp_tpu_torch.ops.kernels import csf_lut as lut
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm
from colorvideovdp_tpu_torch.ops.kernels.pyramid_reduce import pyramid_reduce
from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rel_planes(a, b):
    """The worst relative error over the (batch, channel) planes, so that a
    small channel is held to its own scale."""
    a, b = a.flatten(0, 1).flatten(1), b.flatten(0, 1).flatten(1)
    return float(((a - b).abs().amax(1) / b.abs().amax(1)).max())


@pytest.mark.parametrize("shape", [(2, 57, 256), (1, 66, 301), (3, 5, 7), (16, 270, 481)])
def test_reduce_kernel(dev, shape):
    x = torch.rand(shape, device=dev)
    y = pyramid_reduce(x)
    ref = pyr.reduce_plain(x)
    assert y.shape == ref.shape
    assert float((y - ref).abs().max()) <= 1e-6 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("display,dtype", [("standard_4k", np.uint8),
                                           ("standard_hdr_pq", np.uint16),
                                           ("standard_hdr_hlg", np.uint16),
                                           ("standard_hdr_linear", np.uint16)])
def test_ingest_kernel(dev, display, dtype):
    m = ct.cvvdp(display_name=display, device="cuda")
    F, _ = get_temporal_filters(30, m.sigma_tf, m.beta_tf)
    filt = np.stack([f[::-1] for f in F])
    fl = filt.shape[1]
    rng = np.random.RandomState(0)
    raws = [m._upload((rng.rand(1, 5, 3, 67, 300) * np.iinfo(dtype).max).astype(dtype))
            for _ in range(2)]
    tails = [torch.rand(1, 3, fl - 1, 67, 300, device=dev) * 50 for _ in range(2)]
    before = ing.ingest.launches
    out = ing.ingest(*tails, *raws, m.display_photometry, filt)
    ref = ing.ingest_plain(*tails, *raws, m.display_photometry, filt)
    assert ing.ingest.launches == before + 1
    for a, b in zip(out, ref):
        assert _rel_planes(a, b) <= 1e-5


@pytest.mark.parametrize("B,C,dtype", [(2, 3, np.float32), (1, 1, np.uint8),
                                       (2, 1, np.float16)])
def test_ingest_kernel_batch_channels_float(dev, B, C, dtype):
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda")
    F, _ = get_temporal_filters(30, m.sigma_tf, m.beta_tf)
    filt = np.stack([f[::-1] for f in F])
    fl = filt.shape[1]
    rng = np.random.RandomState(1)
    scale = 255 if dtype == np.uint8 else 1.0
    raws = [m._upload((rng.rand(B, 4, C, 40, 136) * scale).astype(dtype)) for _ in range(2)]
    tails = [torch.rand(B, 3, fl - 1, 40, 136, device=dev) * 50 for _ in range(2)]
    before = ing.ingest.launches
    out = ing.ingest(*tails, *raws, m.display_photometry, filt)
    ref = ing.ingest_plain(*tails, *raws, m.display_photometry, filt)
    assert ing.ingest.launches == before + 1
    assert out[0].shape == (B, 8, 4, 40, 136)
    for a, b in zip(out, ref):
        assert _rel_planes(a, b) <= 1e-5


@pytest.mark.parametrize("C", [4, 3])
def test_band_masking_kernel(dev, C):
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    m._ensure_pyramids(512, 96)
    consts, luts = m._band_tables(C)
    shapes = [(96, 512), (48, 256), (16, 64), (8, 32), (5, 16)]
    gis = [torch.rand(1, 2 * C, 3, h, w, device=dev) * 20 + 30 for h, w in shapes]
    Es = [g + torch.randn_like(g) for g in gis]
    for sel in ([0], [1], [2, 3, 4]):
        args = ([gis[i] for i in sel], [Es[i] for i in sel], luts[sel[0]:sel[-1] + 1],
                [2.0] * len(sel), consts)
        assert _rel(bm.band_masking(*args), bm.band_masking_plain(*args)) <= 1e-4


def test_csf_lut_kernel(dev):
    m = ct.cvvdp(display_name="standard_4k", device="cuda")
    x0, x1 = m.csf.lut_range()
    luts = torch.as_tensor(np.stack([m.csf.logS_of_logL(2.0, 0, c) for c in range(3)]
                                    + [m.csf.logS_of_logL(2.0, 5, 0)]), device=dev)
    logL = torch.linspace(x0 - 1, x1 + 1, 100003, device=dev).reshape(1, 1, -1, 1, 1)
    a = lut.csf_lut(logL, luts, x0, x1)
    b = lut.csf_lut_plain(logL, luts, x0, x1)
    assert float(((a - b).abs() / b).max()) <= 1e-5


@pytest.mark.parametrize("case", ["uint8", "batch2-float32"])
def test_metric_kernels_match_plain(dev, case):
    rng = np.random.RandomState(3)
    ref = (rng.rand(270, 480, 3, 12) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * 10).astype(np.int16),
                   0, 255).astype(np.uint8)
    dims = "HWCF"
    if case == "batch2-float32":
        test = np.stack([test, ref]).astype(np.float32) / 255
        ref = np.stack([ref, ref]).astype(np.float32) / 255
        dims = "BHWCF"
    jods = []
    for fused in (True, False):
        m = ct.cvvdp(display_name="standard_hdr_pq", device="cuda")
        m.enable_fused_kernels = fused
        before = ing.ingest.launches
        Q, _ = m.predict(test, ref, dim_order=dims, frames_per_second=30)
        assert (ing.ingest.launches > before) == fused
        jods.append(Q.double().cpu().numpy())
    assert np.abs(jods[0] - jods[1]).max() <= 1e-4, jods
