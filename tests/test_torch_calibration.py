"""Calibration of the PyTorch port against the JAX package's
``calibration/`` scripts (CPU): the feature dataset, the differentiable
pooling and its gradients, the Adam refit loop against the ``optax`` loop,
the train/test split, the CSV header's precedence, worker sharding and
``--resume``, and the whole pipeline (extraction, then the refit) on four
PNG pairs against the JAX metric's features and the JAX trainer's config.
The JAX scripts are imported by path, as ``tests/test_calibration.py``
runs them."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
from colorvideovdp_tpu.io.video_source_file import video_source_file as vsf_j  # noqa: E402
from colorvideovdp_tpu_torch.calibration import data as data_t  # noqa: E402
from colorvideovdp_tpu_torch.calibration import extract_features as ef_t  # noqa: E402
from colorvideovdp_tpu_torch.calibration import train as tr_t  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAL = os.path.join(REPO, "calibration")


def _jax_module(name):
    """calibration/<name>.py of the JAX package, imported by path (its
    siblings importable as the script expects)."""
    spec = importlib.util.spec_from_file_location(f"jax_cal_{name}",
                                                  os.path.join(CAL, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, CAL)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(CAL)
    return mod


@pytest.fixture(scope="module")
def jax_cal():
    return {name: _jax_module(name) for name in ("data", "extract_features", "train")}


@pytest.fixture(scope="module")
def jax_metric():
    return cj.cvvdp(quiet=True, display_name="standard_fhd", temp_padding="replicate")


def _pool_kwargs(m):
    return dict(beta_sch=m.beta_sch, beta_tch=m.beta_tch, beta_t=m.beta_t, image_int=m.image_int)


def _params(m):
    """The trainable parameters' float32 values, as both trainers start."""
    return {k: np.asarray(getattr(m, k), np.float32) for k in tr_t.PARAMS}


def _features(rng, C, F, bands=7, B=1):
    """Seeded positive per-band features at the scale the extractor gives."""
    return (rng.rand(B, C, F, bands).astype(np.float32) ** 2) * 0.8 + 0.01


def _write_pairs(d, n, rng, H=40, W=56):
    """n seeded sRGB PNG pairs in ``d``, distortions growing with the index.
    Returns the CSV rows (test, reference, jod)."""
    rows = []
    for i in range(n):
        ref = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        tst = np.clip(ref.astype(np.int16) + rng.randn(*ref.shape) * (10 + 30 * i), 0,
                      255).astype(np.uint8)
        Image.fromarray(ref).save(os.path.join(d, f"ref{i}.png"))
        Image.fromarray(tst).save(os.path.join(d, f"tst{i}.png"))
        rows.append((f"tst{i}.png", f"ref{i}.png", round(9.0 - 1.5 * i, 2)))
    return rows


def _feature_files(root):
    return {split: sorted(os.listdir(os.path.join(root, split))) for split in ("train", "test")}


def _floats(cfg):
    """Every float of a cvvdp_parameters.json but its comment and date."""
    with open(cfg) as f:
        d = json.load(f)
    return {k: np.asarray(v, np.float64) for k, v in d.items()
            if k not in ("__comment", "calibration_date") and not isinstance(v, (str, int))}


# ---------------------------------------------------------------------------
# The feature dataset


@pytest.mark.parametrize("resample", [False, True])
@pytest.mark.parametrize("top_rho", [75.0, 37.5], ids=["in-grid", "extrapolate"])
def test_dataset_matches_jax(tmp_path, jax_cal, resample, top_rho):
    rng = np.random.RandomState(5)
    rows = []
    for split in ("train", "test"):
        os.makedirs(tmp_path / split)
    for i, (C, F) in enumerate([(4, 5), (3, 1), (4, 1), (3, 5), (4, 3)]):
        qpc = _features(rng, C, F, bands=8)
        rho = [top_rho / 2**b for b in range(7)] + [0.1]
        fmap = {"rho_band": rho, "Q_JOD": 8.5}
        for cc in range(C):
            for bb in range(8):
                fmap[f"t{cc}_b{bb}"] = qpc[:, cc, :, bb].tolist()
        name = f"seq/clip{i}.mp4"
        with open(tmp_path / ("train" if i % 2 == 0 else "test") / f"seq_clip{i}_fmap.json",
                  "w") as f:
            json.dump(fmap, f)
        rows.append((name, 9.0 - i))
    table = pd.DataFrame(rows, columns=["test", "jod"])
    for split in ("train", "test"):
        sub = table.iloc[[i for i in range(len(rows)) if (i % 2 == 0) == (split == "train")]]
        ds_t = data_t.VideoDataset(str(tmp_path), sub, split, resample)
        ds_j = jax_cal["data"].VideoDataset(str(tmp_path), sub, split, resample)
        assert len(ds_t) == len(ds_j)
        for idx in list(range(len(ds_t))) * 2:  # the second pass reads the cache
            (qt, rt, jt), (qj, rj, jj) = ds_t[idx], ds_j[idx]
            assert qt.dtype == qj.dtype == np.float32 and qt.shape == qj.shape
            np.testing.assert_array_equal(qt, qj)
            assert rt == rj and jt == jj
        if resample:
            assert ds_t[0][0].shape[-1] == 9
        for seed in (0, 4):
            bt = [[s[2] for s in b] for b in ds_t.iter_batches(2, shuffle=True, seed=seed)]
            bj = [[s[2] for s in b] for b in ds_j.iter_batches(2, shuffle=True, seed=seed)]
            assert bt == bj


# ---------------------------------------------------------------------------
# The pooling and the refit loop


@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("F", [1, 5])
def test_pooling_and_gradients_match_jax(jax_cal, jax_metric, C, F):
    rng = np.random.RandomState(10 * C + F)
    qpc = _features(rng, C, F)
    init = _params(jax_metric)
    pool = _pool_kwargs(jax_metric)

    def jod_j(p):
        return jnp.sum(jax_cal["train"].pooling_and_jods(p, jnp.asarray(qpc), **pool))

    want, g_j = jax.value_and_grad(jod_j)({k: jnp.asarray(v) for k, v in init.items()})
    p_t = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    got = tr_t.pooling_and_jods(p_t, torch.from_numpy(qpc), **pool)
    assert got.shape == ()
    g_t = torch.autograd.grad(got, [p_t[k] for k in tr_t.PARAMS])
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    for k, g in zip(tr_t.PARAMS, g_t):
        gj = np.asarray(g_j[k])
        assert g.shape == gj.shape
        assert np.abs(g.numpy() - gj).max() <= 1e-5 * max(np.abs(gj).max(), 1e-30), k
    if C == 3:  # the fourth baseband weight takes no part
        assert float(g_t[2][3]) == 0.0


def test_refit_loop_matches_optax(jax_cal, jax_metric):
    rng = np.random.RandomState(11)
    samples = []
    for i in range(8):
        C, F = (3 if i % 2 else 4), (1 if i % 3 == 0 else 5)
        samples.append((_features(rng, C, F), np.float32(0.1), 9.0 - 0.8 * i))
    batches = [[samples[i] for i in b] for b in ((0, 1, 2), (3, 4, 5), (6, 7))]
    pool = _pool_kwargs(jax_metric)
    init = _params(jax_metric)
    lr, epochs = 1e-3, 10

    # The JAX loop of calibration/train.py:192-210.
    pooling_j = jax_cal["train"].pooling_and_jods

    def loss_j(p, qpc, label):
        return jnp.mean((pooling_j(p, qpc, **pool) - label) ** 2)

    grad_j = jax.grad(loss_j)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    losses_j = []
    for _ in range(epochs):
        for batch in batches:
            grads, bl = None, []
            for qpc, _rho, q in batch:
                g = grad_j(params, jnp.asarray(qpc), jnp.float32(q))
                grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
                bl.append(float(loss_j(params, jnp.asarray(qpc), jnp.float32(q))))
            grads = jax.tree.map(lambda x: x / len(batch), grads)
            updates, opt_state = opt.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            losses_j += bl

    # The port's step.
    p_t = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt_t = torch.optim.Adam([p_t[k] for k in tr_t.PARAMS], lr=lr)
    losses_t = [x for _ in range(epochs) for batch in batches
                for x in tr_t.train_step(p_t, opt_t, batch, pool)]

    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert np.mean(losses_t[-8:]) < np.mean(losses_t[:8])
    assert max(np.abs(np.asarray(params[k]) - init[k]).max() for k in tr_t.PARAMS) > 1e-3
    for k in tr_t.PARAMS:
        np.testing.assert_allclose(p_t[k].detach().numpy(), np.asarray(params[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# Split, header, workers and resume


@pytest.mark.parametrize("seed", [0, 3])
def test_split_matches_jax(seed):
    table = pd.DataFrame({"reference": [f"ref{i % 10}" for i in range(30)],
                          "content": [i % 7 for i in range(30)]})
    state = np.random.get_state()
    try:
        for col, ratio in (("reference", 80), ("content", 67), ("reference", 35)):
            # calibration/extract_features.py:130-134 and train.py:155-159.
            np.random.seed(seed)
            want = np.random.permutation(table[col].unique())
            want = want[: (len(want) * ratio) // 100]
            got = ef_t.train_conditions(table, col, ratio, seed)
            np.testing.assert_array_equal(got, want)
    finally:
        np.random.set_state(state)
    with pytest.raises(ValueError, match="not found"):
        ef_t.train_conditions(table, "missing", 80, seed)


@pytest.mark.parametrize("script", ["extract_features", "train"])
def test_header_overrides_command_line(tmp_path, monkeypatch, jax_cal, script):
    csv = tmp_path / "q.csv"
    csv.write_text("# a comment\n\ntrain-ratio: 67\ndisplay: standard_fhd\nresume: true\n"
                   "seed: 3\nbogus-key: 1\ntest,reference,jod,display\na.png,b.png,8.5,x\n")
    argv = [str(csv), "--train-ratio", "50", "--seed", "1"]
    if script == "extract_features":
        argv += ["-d", "standard_4k"]
    given = list(argv)
    port = ef_t if script == "extract_features" else tr_t
    args_t, table_t = port.get_args(argv)
    assert argv == given  # the caller's list is left alone
    monkeypatch.setattr(sys, "argv", [script + ".py"] + argv)
    args_j, table_j = jax_cal[script].get_args()
    got = vars(args_t)
    assert got.pop("device") == "cuda"
    assert got == vars(args_j)
    assert args_t.train_ratio == 67 and args_t.seed == 3
    if script == "extract_features":
        assert args_t.display == "standard_fhd" and args_t.resume
    pd.testing.assert_frame_equal(table_t, table_j)


def _per_row_csv(d, rng, n=4):
    rows = _write_pairs(d, n, rng, H=32, W=48)
    lines = ["display: per-row", "split-column: content", "train-ratio: 50", "seed: 3",
             "test,reference,jod,display,content"]
    for i, (t, r, q) in enumerate(rows):
        lines.append(f"{t},{r},{q},{'standard_fhd' if i % 2 else 'standard_4k'},c{i % 3}")
    path = os.path.join(d, "q.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_workers_union_is_a_full_run_and_resume_rewrites_nothing(tmp_path, monkeypatch):
    csv = _per_row_csv(str(tmp_path), np.random.RandomState(2), n=5)
    common = [csv, "-p", str(tmp_path), "--device", "cpu"]
    monkeypatch.chdir(tmp_path)
    ef_t.main(common + ["-f", "full"])
    ef_t.main(common + ["-f", "shards", "-w", "1/2"])
    first = _feature_files("features_shards")
    ef_t.main(common + ["-f", "shards", "-w", "2/2"])
    full, shards = _feature_files("features_full"), _feature_files("features_shards")
    assert full == shards
    assert sum(map(len, full.values())) == 5
    # Worker 1 of 2 takes rows 0, 2 and 4.
    assert sorted(first["train"] + first["test"]) == ["tst0_fmap.json", "tst2_fmap.json",
                                                    "tst4_fmap.json"]
    # The split: contents c0..c2 under seed 3, 50 % of them train.
    table = pd.read_csv(csv, skiprows=4)
    train_cond = ef_t.train_conditions(table, "content", 50, 3)
    want_train = sorted(f"{os.path.splitext(t)[0]}_fmap.json"
                        for t, c in zip(table["test"], table["content"]) if c in train_cond)
    assert full["train"] == want_train
    for split, names in full.items():
        for name in names:
            with open(os.path.join("features_full", split, name)) as f, \
                    open(os.path.join("features_shards", split, name)) as g:
                assert json.load(f) == json.load(g), name

    def mtimes():
        return {(s, n): os.stat(os.path.join("features_full", s, n)).st_mtime_ns
                for s, names in _feature_files("features_full").items() for n in names}

    before = mtimes()
    ef_t.main(common + ["-f", "full", "--resume"])
    assert mtimes() == before
    os.remove(os.path.join("features_full", *sorted(before)[0]))
    ef_t.main(common + ["-f", "full", "--resume"])
    after = mtimes()
    assert sorted(after) == sorted(before)
    assert [k for k in before if after[k] != before[k]] == [sorted(before)[0]]


@pytest.mark.parametrize("script", ["extract_features", "train"])
def test_device_defaults_to_the_card(tmp_path, monkeypatch, script):
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card")
    monkeypatch.chdir(tmp_path)
    csv = _per_row_csv(str(tmp_path), np.random.RandomState(0), n=2)
    port = ef_t if script == "extract_features" else tr_t
    assert port.get_args([csv])[0].device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main([csv, "-o", str(tmp_path / "out")] if script == "train"
                  else [csv, "-p", str(tmp_path)])
    assert not os.path.exists(tmp_path / "features")


# ---------------------------------------------------------------------------
# End to end on four PNG pairs, as tests/test_calibration.py drives the JAX
# scripts


@pytest.fixture(scope="module")
def e2e(tmp_path_factory, jax_metric):
    """The port's extraction on the CPU in a directory of four pairs; the
    JAX metric's Q_per_ch for each pair and the keys its feature files
    hold."""
    d = tmp_path_factory.mktemp("calib_e2e")
    rows = _write_pairs(str(d), 4, np.random.RandomState(0))
    csv = d / "quality.csv"
    csv.write_text("test,reference,jod\n" + "".join(f"{t},{r},{q:.2f}\n" for t, r, q in rows))
    cwd = os.getcwd()
    os.chdir(d)
    try:
        ef_t.main([str(csv), "--display", "standard_fhd", "--path-prefix", str(d),
                   "--train-ratio", "50", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    dm = cj.vvdp_display_photometry.load("standard_fhd")
    geom = cj.vvdp_display_geometry.load("standard_fhd")
    want = {}
    for t, r, _ in rows:
        vs = vsf_j(str(d / t), str(d / r), display_photometry=dm,
                   resize_resolution=geom.resolution)
        _, st = jax_metric.predict_video_source(vs)
        want[os.path.splitext(t)[0]] = st
    jax_metric.write_features_to_json(st, str(d / "jax_fmap.json"))
    with open(d / "jax_fmap.json") as f:
        keys = sorted(json.load(f))
    return d, csv, rows, want, keys


def test_end_to_end_features_match_jax(e2e):
    d, csv, rows, want, keys = e2e
    # The split of calibration/extract_features.py:130-134 on the reference
    # column, 50 % train.
    state = np.random.get_state()
    try:
        np.random.seed(0)
        refs = np.random.permutation(pd.read_csv(csv)["reference"].unique())
    finally:
        np.random.set_state(state)
    train = {t for t, r, _ in rows if r in refs[:2]}
    files = _feature_files(str(d / "features"))
    assert files == {"train": sorted(f"{t[:-4]}_fmap.json" for t, _, _ in rows if t in train),
                     "test": sorted(f"{t[:-4]}_fmap.json" for t, _, _ in rows if t not in train)}
    for split, names in files.items():
        for name in names:
            with open(d / "features" / split / name) as f:
                got = json.load(f)
            assert sorted(got) == keys
            st = want[name[: -len("_fmap.json")]]
            Q = np.asarray(st["Q_per_ch"], np.float64)
            B, C, F, bands = Q.shape
            mine = np.array([[got[f"t{cc}_b{bb}"] for bb in range(bands)] for cc in range(C)])
            mine = mine.transpose(2, 0, 3, 1)  # (C, bands, B, F) -> (B, C, F, bands)
            # The metric tests' bound: float32 through the pyramid and the
            # masking leaves 1.2e-5 in the least distorted pair's band 3.
            assert np.abs(mine - Q).max() <= 1e-4 * np.abs(Q).max(), name
            np.testing.assert_allclose(got["rho_band"], np.asarray(st["rho_band"]), rtol=1e-6)


def test_end_to_end_refit_matches_jax_trainer(e2e, monkeypatch):
    d, csv, _, _, _ = e2e
    monkeypatch.chdir(d)
    common = [str(csv), "--num-epochs", "3", "--train-ratio", "50", "--batch", "2"]
    out = tr_t.main(common + ["--output-dir", str(d / "fitted_port"), "--device", "cpu"])
    assert len(out["epoch_s"]) == 3
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu")
    r = subprocess.run([sys.executable, os.path.join(CAL, "train.py"), *common,
                        "--output-dir", str(d / "fitted_jax")], cwd=str(d), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    got, want = _floats(out["config"]), _floats(d / "fitted_jax" / "cvvdp_parameters.json")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    init = _floats(os.path.join(REPO, "colorvideovdp_tpu", "vvdp_data", "cvvdp_parameters.json"))
    assert not np.allclose(got["jod_a"], init["jod_a"], rtol=0, atol=1e-5)
