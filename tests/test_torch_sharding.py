"""Multi-device scoring of the port (``colorvideovdp_tpu_torch/parallel``)
over gloo on the CPU, against the JAX package on the same seeded arrays.

The ranks are spawned processes (``run_ranks``); one spawn of 4 ranks serves
every 4-rank case and one of 2 ranks the video. The JAX package's own
sharded tests hold JAX sharded to JAX single-device (``tests/test_sharding.py``);
these hold the port's sharded path to JAX single-device ``predict`` with the
same bounds: 1e-5 for the sharded reduce, 2e-4 JOD for images, 1e-4 for the
video with the ingest route.
"""

import inspect
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu_torch.dump_channels import DumpChannels  # noqa: E402
from colorvideovdp_tpu.ops.kernels.masking_fused import fused_blur_transducer  # noqa: E402
from colorvideovdp_tpu_torch.ops import pyramid as pyr  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import masking_fused as bm  # noqa: E402
from colorvideovdp_tpu_torch.ops.temporal import get_temporal_filters  # noqa: E402
from colorvideovdp_tpu_torch.parallel import launch, run_ranks  # noqa: E402
from colorvideovdp_tpu_torch.parallel import sharding as sh  # noqa: E402

REDUCE_CASES = [(1, (2, 6, 1, 256, 512)), (2, (2, 6, 1, 256, 512))]  # (batch groups, shape)
EXPAND_CASE = ((1, 4, 1, 64, 150), (128, 299))  # gn rows sharded 4 ways -> (h, w)


def _spec(d, name, test, ref, dim_order, fps, display, batch, **kw):
    np.save(d / f"{name}_t.npy", test)
    np.save(d / f"{name}_r.npy", ref)
    return dict(test=str(d / f"{name}_t.npy"), reference=str(d / f"{name}_r.npy"),
                dim_order=dim_order, fps=fps, display_name=display, batch=batch, **kw)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One 4-rank spawn: the sharded reduce on (1, 4) and (2, 2) meshes, the
    slab expand, a (1, 4) 192x512 image and a (2, 2) B = 2 64x192 batch."""
    d = tmp_path_factory.mktemp("world4")
    rng = np.random.RandomState(7)
    xs = [rng.rand(*shape).astype(np.float32) for _, shape in REDUCE_CASES]
    gn = rng.rand(*EXPAND_CASE[0]).astype(np.float32)
    rng = np.random.RandomState(5)
    img = [rng.randint(0, 255, (192, 512, 3), dtype=np.uint8) for _ in range(2)]
    rng = np.random.RandomState(3)
    batch = [rng.randint(0, 255, (2, 64, 192, 3), dtype=np.uint8) for _ in range(2)]
    jobs = [(sh.reduce_rank, (x, b, False)) for x, (b, _) in zip(xs, REDUCE_CASES)]
    jobs.append((sh.expand_rank, (gn, *EXPAND_CASE[1], 1)))
    jobs.append((sh.score_rank, (_spec(d, "img", *img, "HWC", 0, "standard_4k", 1),)))
    jobs.append((sh.score_rank, (_spec(d, "bat", *batch, "BHWC", 0, "standard_4k", 2),)))
    res = run_ranks(launch.run_jobs, 4, (jobs,), timeout_s=600, device="cpu")
    return {"xs": xs, "gn": gn, "img": img, "batch": batch,
            "res": [[r[j] for r in res] for j in range(len(jobs))]}


@pytest.mark.parametrize("case", range(len(REDUCE_CASES)))
def test_sharded_reduce_matches_reduce_plain(world4, case):
    x = world4["xs"][case]
    want = pyr.reduce_plain(torch.from_numpy(x)).numpy()
    got = np.empty_like(want)
    for r in world4["res"][case]:
        bl, hl = r["y"].shape[0], r["y"].shape[-2]
        got[r["b"] * bl:(r["b"] + 1) * bl, ..., r["s"] * hl:(r["s"] + 1) * hl, :] = r["y"]
    assert np.abs(got - want).max() <= 1e-5


def test_expand_slab_is_the_full_expand_bit_for_bit(world4):
    (h, w), gn = EXPAND_CASE[1], world4["gn"]
    want = pyr.gausspyr_expand(torch.from_numpy(gn), (h, w)).numpy()
    got = np.concatenate([r["E"] for r in sorted(world4["res"][2], key=lambda r: r["s"])], -2)
    assert np.array_equal(got, want)


def test_expand_slab_from_a_replicated_level_bit_for_bit():
    """A replicated gn is read where the rows lie; an odd slab height starts
    on an odd row of E."""
    gn = torch.from_numpy(np.random.RandomState(2).rand(1, 2, 135, 77).astype(np.float32))
    h, w, n = 270, 153, 2
    want = pyr.gausspyr_expand(gn, (h, w))
    for s in range(n):
        mesh = sh.Mesh.__new__(sh.Mesh)
        mesh.n_space, mesh.s = n, s
        got = sh.expand_slab(sh.Level(gn, False, gn.shape[-2]), mesh, h, w)
        assert torch.equal(got, want[..., s * (h // n):(s + 1) * (h // n), :])


def _jax_jod(test, ref, dim_order, display, fps=0):
    Q, _ = cj.cvvdp(display_name=display, quiet=True).predict(
        test, ref, dim_order=dim_order, frames_per_second=fps)
    return np.asarray(Q, np.float64).reshape(-1)


def test_sharded_image_1x4_matches_jax_predict(world4):
    """192x512 on a (1, 4) mesh: 48-row slabs, so level 0 takes the slab
    reduce (as ``tests/test_sharding.py:322-358``) and bands 0 and 1 the
    halo mode."""
    res = world4["res"][3]
    want = _jax_jod(*world4["img"], "HWC", "standard_4k")
    for r in res:
        assert r["route"]["levels"] == [0, 1] and r["route"]["halo_bands"] == [0, 1]
        assert abs(float(r["jod"]) - want[0]) <= 2e-4, (float(r["jod"]), want)


def test_sharded_batch_2x2_matches_jax_predict(world4):
    """B = 2 64x192 pairs on a (2, 2) mesh: each batch group scores one pair,
    its 32-row slabs take the halo mode at band 0, and Q is gathered."""
    res = world4["res"][4]
    want = _jax_jod(*world4["batch"], "BHWC", "standard_4k")
    assert want.shape == (2,)
    for r in res:
        assert r["route"]["levels"] == [0] and r["route"]["halo_bands"] == [0]
        np.testing.assert_allclose(np.asarray(r["jod"]).reshape(-1), want, rtol=0, atol=2e-4)
        np.testing.assert_array_equal(r["Q_per_ch"], res[0]["Q_per_ch"])


def test_sharded_video_1x2_matches_jax_predict(tmp_path):
    """A 2-block 128x256 video on a (1, 2) mesh with replicate padding on
    standard_hdr_pq: the first block through the ingest's replicate mode, the
    second through its tail mode, tails carried per rank."""
    H, W, N, fps = 128, 256, 8, 30.0
    rng = np.random.RandomState(11)
    V_test = (rng.rand(H, W, 3, N) * 255).astype(np.uint8)
    V_ref = np.clip(V_test.astype(np.int16) + (rng.randn(H, W, 3, N) * 10).astype(np.int16),
                    0, 255).astype(np.uint8)
    m = ct.cvvdp(display_name="standard_hdr_pq", device="cpu")
    # gpu_mem for 4-frame blocks, with the host's memory split by the 2 ranks.
    gpu_mem = m.block_gpu_mem((H // 2) * W, 4, fps, share=2, reference_model=True)
    spec = _spec(tmp_path, "vid", V_test, V_ref, "HWCF", fps, "standard_hdr_pq", 1,
                 gpu_mem=gpu_mem, temp_padding="replicate")
    res = run_ranks(sh.score_rank, 2, (spec,), timeout_s=600, device="cpu")
    want = _jax_jod(V_test, V_ref, "HWCF", "standard_hdr_pq", fps)
    for r in res:
        assert r["block_N"] == 4
        assert r["route"]["levels"] == [0, 1] and r["route"]["halo_bands"] == [0, 1]
        assert abs(float(r["jod"]) - want[0]) <= 1e-4, (float(r["jod"]), want)


def test_halo_band_mode_matches_fused_blur_transducer():
    """The halo mode's plain version against the JAX kernel's halo'd shard
    mode (``row_off=8``, ``h_valid=H_loc``, interpret) on the top, an
    interior and the bottom slab of a band split 4 ways: the same M_pre and
    diff slabs (neighbour rows, or the exclude-edge reflection, with zero
    diff rows in the halo as JAX builds them). Per-plane sums within 1e-5
    relative; the slabs' sums add up to the whole band's."""
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    m._ensure_pyramids(256, 64)
    C, B, F, H, W, n, r = 4, 1, 2, 64, 256, 4, bm.HALO_ROWS
    k, luts = m._band_tables(C)
    rng = np.random.RandomState(0)
    gi = torch.from_numpy((30 + 20 * rng.rand(B, 2 * C, F, H, W)).astype(np.float32))
    E = gi + torch.from_numpy(rng.randn(B, 2 * C, F, H, W).astype(np.float32))
    mp, df = bm.raw_stage_a_plain(gi, E, luts[0], 2.0, k)
    H_loc = H // n
    total = 0
    for s in range(n):
        lo, hi = s * H_loc, (s + 1) * H_loc

        def halo(x, edge):
            z = torch.zeros_like(x[..., :r, :])
            above = x[..., lo - r:lo, :] if s > 0 else (z if edge == "zero"
                                                         else x[..., 1:r + 1, :].flip(-2))
            below = x[..., hi:hi + r, :] if s < n - 1 else (z if edge == "zero"
                                                             else x[..., -r - 1:-1, :].flip(-2))
            return torch.cat([above, x[..., lo:hi, :], below], dim=-2)

        m_h, d_h = halo(mp, "reflect"), halo(df, "zero")
        got = bm.halo_pool_plain(m_h, d_h, k, H_loc)
        if s in (0, 1, n - 1):
            m4, d4 = (a.numpy().transpose(1, 0, 2, 3, 4).reshape(C, B * F, H_loc + 2 * r, W)
                      for a in (m_h, d_h))
            want = np.asarray(fused_blur_transducer(
                jnp.asarray(m4), jnp.asarray(d4), k.taps, k.blur_scale, k.qs, k.p, k.xcm,
                k.max_v, pool_beta=k.beta, row_off=r, h_valid=H_loc, interpret=True))
            g = got.numpy().transpose(1, 0, 2).reshape(C, B * F)
            assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), s
        # From gi and E, as the wrapper takes them: stage A on the halo rows.
        # Not to the bit: PyTorch's CPU log10/pow may differ by an ulp between
        # the vector body and the scalar tail of a thread's chunk, and the
        # chunks split a slab and the whole band at other elements.
        slab = bm.band_masking_halo_plain([halo(gi, "reflect")], [halo(E, "reflect")],
                                          luts[0:1], [2.0], k, [H_loc])[0]
        assert float((slab - got).abs().max() / got.abs().max()) <= 1e-6
        total = total + slab
    whole = bm.band_masking_plain([gi], [E], luts[0:1], [2.0], k)[0]
    assert float((total - whole).abs().max() / whole.abs().max()) <= 1e-5


def test_rank_failure_raises_within_timeout():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        run_ranks(launch.fail_rank, 2, (1,), timeout_s=120, device="cpu")
    assert time.time() - t0 < 60


@pytest.mark.parametrize("world,device,cards,want", [
    (2, "cpu", 0, "gloo"), (4, "cpu", 0, "gloo"), (2, "cuda", 1, "gloo"),
    (2, "cuda", 2, "nccl"), (4, "cuda", 8, "nccl"), (4, "cuda", 2, "gloo"),
])
def test_backend_choice(world, device, cards, want):
    assert launch.pick_backend(world, device, cards) == want
    assert launch.device_map(world, device, cards) == (
        [None] * world if device == "cpu" else [r % cards for r in range(world)])


def test_rank_device_has_one_source():
    """``run_ranks`` runs on the card unless asked for the CPU, and sets each
    rank's device itself: a spec that names one is refused, and
    ``rank_device`` answers only inside a rank."""
    assert inspect.signature(run_ranks).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no card"):
        launch.device_map(2, "cuda", 0)
    with pytest.raises(ValueError):
        run_ranks(launch.fail_rank, 2, (1,), device="gpu")
    with pytest.raises(RuntimeError, match="not inside a rank"):
        launch.rank_device()
    with pytest.raises(ValueError, match="run_ranks"):
        sh.score_rank(0, 1, {"device": "cpu"})


def test_block_gpu_mem_inverts_the_block_model(monkeypatch, tmp_path):
    """On every route: the CPU, and on a card (its memory queries patched to
    a large free memory) the pooled route, the heatmap's, the dumps', the
    mesh's, a per-frame source's, the generic chain's, the plain versions'
    and the ML trunk's."""
    from colorvideovdp_tpu_torch.metrics.ml import cvvdp_ml_transformer
    from colorvideovdp_tpu_torch.utils.config import write_parameters

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (1e12, 1e12))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: 0)
    texture = write_parameters(str(tmp_path), masking_model="mult-transducer-texture")
    routes = {"cpu": {}, "pooled": {}, "heatmap": dict(heatmap="raw"),
              "dumps": dict(dump_channels=DumpChannels()), "mesh": {}, "per-frame": {},
              "generic": dict(config_paths=texture), "plain": {}, "ml": {}}
    for route, kw in routes.items():
        cls = cvvdp_ml_transformer if route == "ml" else ct.cvvdp
        if route == "ml":
            kw = dict(random_init=True)
        m = cls(display_name="standard_hdr_pq", device="cpu", **kw)
        if route != "cpu":
            m.device = torch.device("cuda")
        m.enable_fused_kernels = route != "plain"
        kw = dict(reference_model=route in ("mesh", "per-frame"))
        m.filter_len = len(get_temporal_filters(30.0, m.sigma_tf, m.beta_tf, m.temp_filter)[0][0])
        for pix, blk, share in ((1080 * 3840, 16, 2), (64 * 256, 4, 1), (540 * 3840, 8, 4),
                                (2160 * 3840, 32, 1)):
            m.gpu_mem = m.block_gpu_mem(pix, blk, 30.0, share, **kw)
            assert m.estimate_block_N(pix, 64, share=share, **kw) == blk, route


def test_mesh_and_heatmap_guards():
    """A mesh needs the ranks it names; a video's heatmap and channel dumps
    take none (an image's heatmap does: shard_scoring_fn and
    predict_video_source return it beside Q)."""
    with pytest.raises(ValueError):
        sh.make_mesh(3)  # 1 rank does not split into 3 batch groups
    with pytest.raises(ValueError):
        sh.Mesh(1, 2)  # no process group: one rank
    mesh = sh.make_mesh()
    assert (mesh.n_batch, mesh.n_space, mesh.b, mesh.s) == (1, 1, 0, 0)
    m = ct.cvvdp(display_name="standard_4k", device="cpu", heatmap="raw")
    img = np.random.RandomState(0).randint(0, 255, (16, 64, 3), dtype=np.uint8)
    vs = ct.video_source_array(img, img, 0, dim_order="HWC",
                               display_photometry=m.display_photometry)
    clip = np.repeat(img[..., None], 4, axis=-1)
    vs_video = ct.video_source_array(clip, clip, 30, dim_order="HWCF",
                                     display_photometry=m.display_photometry)
    with pytest.raises(ValueError, match="heatmap"):
        sh.predict_video_source(m, vs_video, mesh)
    raws = [m._upload(vs.get_raw_block(s, 0, 1)) for s in ("test", "reference")]
    Q, hm = sh.shard_scoring_fn(m, vs, "DKLd65", (1, 1, 3, 16, 64), np.uint8, mesh)(*raws)
    assert hm.dtype == torch.float16 and tuple(hm.shape) == (1, 1, 1, 16, 64)
    Q_p, st = sh.predict_video_source(m, vs, mesh)
    assert torch.equal(Q_p, m.do_pooling_and_jods(Q))
    assert np.array_equal(st["heatmap"], hm.numpy())
    with pytest.raises(ValueError, match="dumps"):
        m._process_block(torch.zeros(1, 6, 1, 16, 64), temp_ch=1, is_image=True, mesh=mesh,
                         dump={})
    m = ct.cvvdp(display_name="standard_4k", device="cpu")
    assert sh.shard_scoring_fn(m, vs, "DKLd65", (1, 1, 3, 16, 64), np.uint8, mesh)(*raws)[1] is None
    m.dump_channels = DumpChannels()
    with pytest.raises(ValueError, match="dumps"):
        sh.predict_video_source(m, vs_video, mesh)
    with pytest.raises(ValueError, match="dumps"):
        sh.shard_loss_fn(m, 16, 64, mesh)
