"""The port's one block producer (``cvvdp._raw_blocks``) as its three callers
use it, on the CPU: ``cvvdp``, the ML metrics and the mesh
(``parallel/sharding.py``). The first block pads inside the ingest kernel's
first-block modes (their plain versions here), later blocks carry tails, and
the next block is read on the prefetch worker.
"""

import threading

import numpy as np
import pytest
import torch

import colorvideovdp_tpu_torch as ct
from colorvideovdp_tpu_torch.metrics import ml as ml_t
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing
from colorvideovdp_tpu_torch.parallel import sharding as sh

# standard_fhd at 64x128, 5 frames at 30 fps (a 9-tap temporal filter).
H, W, N, FPS = 64, 128, 5, 30.0
ML = {"saliency": ct.cvvdp_ml_saliency, "transformer": ct.cvvdp_ml_transformer}


def _clip(seed=11):
    rng = np.random.RandomState(seed)
    ref = (rng.rand(H, W, 3, N) * 0.8 * 255).astype(np.uint8)
    test = np.clip(ref + rng.randn(H, W, 3, N) * 0.05 * 255, 0, 255).astype(np.uint8)
    return test, ref


def _source(m, test, ref):
    return ct.video_source_array(test, ref, FPS, dim_order="HWCF",
                                 display_photometry=m.display_photometry)


def _ml_gpu_mem(blk, fl=9):
    """gpu_mem (GB) that gives ``blk``-frame blocks under the ML metrics'
    memory model."""
    a, b, c = ml_t.cvvdp_ml_base.mem_model
    return (a + H * W * (fl - 1) * b + H * W * (b + c) * (blk + 0.5)) / 1e9


def _responding(m):
    """The seeded random weights with each MLP's last layer made positive,
    so that the saliency head's ReLU outputs respond."""
    with torch.no_grad():
        for name in m.get_nets_to_load():
            net = getattr(m, name)
            if isinstance(net, ml_t.MLP):
                net.linears()[-1].weight.abs_()
                net.linears()[-1].bias.fill_(0.1)
    return m


@pytest.mark.parametrize("padding", ["replicate", "symmetric"])
@pytest.mark.parametrize("family", sorted(ML))
def test_ml_video_in_blocks_equals_one_block(family, padding):
    """An ML metric scores a 5-frame clip in blocks of 3 (3 + 2, the second
    padded) as in one block: the JOD and every band's delta within float
    rounding."""
    test, ref = _clip()
    out = []
    for gpu_mem in (None, _ml_gpu_mem(3)):
        m = _responding(ML[family](display_name="standard_fhd", device="cpu", random_init=True,
                                   temp_padding=padding, gpu_mem=gpu_mem))
        Q, st = m.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)
        out.append((float(Q), st["delta_per_band"], st["block_N_frames"]))
    (q1, d1, n1), (q3, d3, n3) = out
    assert (n1, n3) == (N, 3)
    assert abs(10.0 - q1) > 1e-3  # the heads respond
    assert abs(q3 - q1) <= 1e-5 * max(1.0, abs(10.0 - q1)), (q3, q1)
    assert d3.shape == d1.shape and np.abs(d3 - d1).max() <= 1e-5 * np.abs(d1).max()


def test_ml_next_block_is_read_on_the_prefetch_worker():
    """The ML metric's first block is read on the calling thread and the
    next one on the producer's worker thread."""
    test, ref = _clip()
    m = ct.cvvdp_ml_transformer(display_name="standard_fhd", device="cpu", random_init=True,
                                gpu_mem=_ml_gpu_mem(3))
    vs = _source(m, test, ref)
    reads = []
    read = vs.get_raw_block

    def spy(which, start, count, **kw):
        reads.append((start, threading.get_ident()))
        return read(which, start, count, **kw)

    vs.get_raw_block = spy
    m.predict_video_source(vs)
    main = threading.get_ident()
    assert sorted({s for s, _ in reads}) == [0, 3]
    assert all(t == main for s, t in reads if s == 0)
    assert all(t != main for s, t in reads if s == 3)


def _ingest_spies(monkeypatch):
    """Count the producer's calls of each ingest entry and of ``raw_to_met``
    made outside them: the padding frames are the ingest kernel's to
    convert."""
    seen = {"ingest": 0, "ingest_replicate": 0, "ingest_head": 0, "raw_to_met": 0}
    inside = [0]

    def entry(name):
        fn = getattr(ing, name)

        def run(*a, **kw):
            seen[name] += 1
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return run

    for name in ("ingest", "ingest_replicate", "ingest_head"):
        monkeypatch.setattr(ing, name, entry(name))
    raw_to_met = ing.raw_to_met

    def spy_raw_to_met(*a, **kw):
        if not inside[0]:
            seen["raw_to_met"] += 1
        return raw_to_met(*a, **kw)

    monkeypatch.setattr(ing, "raw_to_met", spy_raw_to_met)
    return seen


def _cvvdp_gpu_mem(blk, fl=9):
    """gpu_mem (GB) that gives ``blk``-frame blocks under the reference
    memory model (the CPU's)."""
    a, b, c = ct.cvvdp.mem_model
    return (a + H * W * (fl - 1) * b + H * W * (b + c) * (blk + 0.5)) / 1e9


@pytest.mark.parametrize("padding", ["replicate", "symmetric"])
def test_first_block_pads_in_the_ingest_kernel_modes(monkeypatch, padding):
    """``cvvdp``'s first block goes through ``ingest_replicate`` (replicate
    padding) or ``ingest_head`` (symmetric), the second through ``ingest``
    with the carried tails, and the producer converts no padding frame with
    the plain ``raw_to_met``."""
    seen = _ingest_spies(monkeypatch)
    test, ref = _clip()
    m = ct.cvvdp(display_name="standard_fhd", device="cpu", temp_padding=padding,
                 gpu_mem=_cvvdp_gpu_mem(3))
    Q, st = m.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)
    assert st["block_N_frames"] == 3 and np.isfinite(float(Q))
    first = "ingest_replicate" if padding == "replicate" else "ingest_head"
    want = {"ingest": 1, "ingest_replicate": 0, "ingest_head": 0, "raw_to_met": 0}
    want[first] = 1
    assert seen == want


def test_mesh_first_block_repeats_frame_0(monkeypatch):
    """Under a mesh the first block repeats frame 0 whatever
    ``temp_padding`` says, as the JAX package's sharded step does: with
    symmetric padding, a one-rank mesh gives the single-device replicate
    scores, through ``ingest_replicate``."""
    test, ref = _clip()
    m = ct.cvvdp(display_name="standard_fhd", device="cpu", temp_padding="symmetric",
                 gpu_mem=_cvvdp_gpu_mem(3))
    seen = _ingest_spies(monkeypatch)
    Q_mesh, st = sh.predict_video_source(m, _source(m, test, ref), sh.make_mesh())
    assert st["block_N_frames"] == 3
    assert (seen["ingest_replicate"], seen["ingest_head"]) == (1, 0)
    single = {}
    for padding in ("replicate", "symmetric"):
        m.temp_padding = padding
        single[padding] = m.predict(test, ref, dim_order="HWCF", frames_per_second=FPS)[1]
    want, other = single["replicate"]["Q_per_ch"], single["symmetric"]["Q_per_ch"]
    assert np.abs(st["Q_per_ch"] - want).max() <= 1e-6 * np.abs(want).max()
    assert np.abs(st["Q_per_ch"] - other).max() > 1e-3 * np.abs(want).max()
    assert np.isfinite(float(Q_mesh))
