"""The block-length model of the port (``cvvdp.estimate_block_N``) by route,
with the card's memory queries patched: what counts as free device memory
and which (a, b, c) each route takes."""

import pytest
import torch

import colorvideovdp_tpu_torch as ct
from colorvideovdp_tpu_torch.dump_channels import DumpChannels
from colorvideovdp_tpu_torch.metrics.ml import cvvdp_ml_transformer
from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters
from colorvideovdp_tpu_torch.utils.config import write_parameters

PIX_4K = 2160 * 3840
# An H100 80GB as a 4K clip leaves it: the caching allocator holds 11 GB
# unused beside 0.3 GB in use, and mem_get_info reports 57 GB free.
H100_AFTER_CLIP = dict(free=57.0e9, total=85.0e9, reserved=11.0e9, allocated=0.3e9)


@pytest.fixture
def card(monkeypatch):
    """Patches the CUDA memory queries to report ``mem`` (bytes)."""
    def use(mem):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev=None: (mem["free"], mem["total"]))
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: mem["reserved"])
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: mem["allocated"])
    return use


def route_metric(route, tmp_path):
    """(metric as if on the card, keywords of its route for
    ``estimate_block_N``) for one route of the block loop."""
    kw = {}
    if route == "heatmap":
        kw["heatmap"] = "raw"
    elif route == "dumps":
        kw["dump_channels"] = DumpChannels()
    elif route == "generic":
        kw["config_paths"] = write_parameters(str(tmp_path),
                                              masking_model="mult-transducer-texture")
    elif route in ("log", "weber_g0_ref", "weber_g1_ref"):
        kw["config_paths"] = write_parameters(str(tmp_path), contrast=route)
    cls = cvvdp_ml_transformer if route == "ml" else ct.cvvdp
    if route == "ml":
        kw["random_init"] = True
    m = cls(display_name="standard_hdr_pq", device="cpu", **kw)
    m.device = torch.device("cuda")
    m.enable_fused_kernels = route != "plain"
    m.filter_len = len(get_temporal_filters(30.0, m.sigma_tf, m.beta_tf, m.temp_filter)[0][0])
    return m, dict(reference_model=route in ("mesh", "per-frame"))


@pytest.mark.parametrize("route", ["pooled", "ml"])
def test_device_free_counts_the_allocator_cache(card, route, tmp_path):
    """Free memory is what mem_get_info reports free plus what the caching
    allocator holds unused, for the pooled and the ML metric alike."""
    card(H100_AFTER_CLIP)
    m, _ = route_metric(route, tmp_path)
    assert m._device_free() == 57.0e9 + 11.0e9 - 0.3e9


# Frames per block of a 32-frame 4K clip on the card of H100_AFTER_CLIP: the
# pooled route's measured model gives one block in every contrast coding;
# every other route keeps the reference metric's model (c = 320: 23 frames),
# the ML trunk its own (29).
BLOCKS_BY_ROUTE = {"pooled": 32, "weber_g1_ref": 32, "weber_g0_ref": 32, "log": 32,
                   "heatmap": 23, "dumps": 23, "mesh": 23, "per-frame": 23, "generic": 23,
                   "plain": 23, "ml": 29}


@pytest.mark.parametrize("route", sorted(BLOCKS_BY_ROUTE))
def test_block_length_by_route(card, route, tmp_path):
    card(H100_AFTER_CLIP)
    m, kw = route_metric(route, tmp_path)
    want = (1.6e9, 16, 250) if route == "ml" else (
        (0.1e9, 48, 12) if BLOCKS_BY_ROUTE[route] == 32 else (1.6e9, 16, 320))
    assert m._block_mem_model(**kw) == want
    assert m.estimate_block_N(PIX_4K, 32, **kw) == BLOCKS_BY_ROUTE[route]
    # A user's gpu_mem still caps the free memory.
    m.gpu_mem = m.block_gpu_mem(PIX_4K, 6, 30.0, **kw)
    assert m.estimate_block_N(PIX_4K, 32, **kw) == 6


# Frames per block of long 4K clips on the card of H100_AFTER_CLIP. The
# pooled route holds up to 129 frames and spreads a clip evenly over the
# blocks it needs (160 frames: 2 x 80, 240: 2 x 120, 300: 3 x 100, none
# padded); every other route keeps its largest block and pads the trailing
# one. A user's gpu_mem pins the largest block that memory holds.
LONG_CLIPS = {160: 80, 240: 120, 300: 100}


@pytest.mark.parametrize("route", ["pooled", "log", "heatmap", "mesh", "per-frame", "ml"])
@pytest.mark.parametrize("N", sorted(LONG_CLIPS))
def test_long_clip_blocks_by_route(card, route, N, tmp_path):
    card(H100_AFTER_CLIP)
    m, kw = route_metric(route, tmp_path)
    pooled = m._block_mem_model(**kw) == (0.1e9, 48, 12)
    want = LONG_CLIPS[N] if pooled else BLOCKS_BY_ROUTE[route]
    assert m.estimate_block_N(PIX_4K, N, **kw) == want
    m.gpu_mem = m.block_gpu_mem(PIX_4K, 100, 30.0, **kw)
    assert m.estimate_block_N(PIX_4K, N, **kw) == (100 if pooled else want)
