"""The port's channel dumps against the JAX package's ``DumpChannels`` (CPU):
the temporal channels, the contrast pyramid and the per-band differences of
an image and a 5-frame video, and the JOD with dumps.

Tolerances: every dumped frame within 1 code value of the JAX package's
(8-bit frames drawn from float32 bands); the JOD with dumps within 1e-4 of
the JAX package's and of the port's pooled-only JOD."""

import numpy as np
import pytest

pytest.importorskip("jax")

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu import dump_channels as dc_j  # noqa: E402
from colorvideovdp_tpu_torch import dump_channels as dc_t  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import band_pooled as bp  # noqa: E402

import _torch_media as media  # noqa: E402

CODE_TOL = 1
JOD_TOL = 1e-4
MODES = ("temp_channels", "lpyr", "diff")


class _Recorder:
    """A writer that keeps the frames it is given, by file stem."""

    frames = {}

    def __init__(self, fname, fps=0, **kw):
        self.fname = fname
        self.stem = fname.replace("\\", "/").split("/")[-1].split(".")[0]
        _Recorder.frames[self.stem] = []

    def write_frame_rgb(self, rgb):
        _Recorder.frames[self.stem].append(np.array(rgb))

    def close(self):
        pass


def _inputs(kind):
    test, ref = media.content(64, 96, 5, seed=6)
    if kind == "image":
        return test[..., 0], ref[..., 0], "HWC", 0
    return test, ref, "HWCF", 30


def _dump(pkg, mod, kind, monkeypatch, **kw):
    """(JOD with all three dumps, {stem: (N, H, W, 3) frames})."""
    monkeypatch.setattr(mod, "VideoWriter", _Recorder)
    monkeypatch.setattr(mod, "ImageWriter", _Recorder)
    _Recorder.frames = {}
    test, ref, order, fps = _inputs(kind)
    m = pkg.cvvdp(display_name="standard_fhd", dump_channels=mod.DumpChannels(), **kw)
    q, _ = m.predict(test, ref, dim_order=order, frames_per_second=fps)
    return float(q), {k: np.stack(v) for k, v in _Recorder.frames.items()}


@pytest.fixture(scope="module")
def jax_dumps():
    with pytest.MonkeyPatch.context() as mp:
        return {kind: _dump(cj, dc_j, kind, mp) for kind in ("image", "video")}


@pytest.mark.parametrize("kind", ["image", "video"])
def test_dumps_match_jax(jax_dumps, monkeypatch, kind):
    calls = []
    band_pooled_d_plain = bp.band_pooled_d_plain
    monkeypatch.setattr(bp, "band_pooled_d_plain",
                        lambda *a: calls.append(len(a[0])) or band_pooled_d_plain(*a))
    q_t, frames_t = _dump(ct, dc_t, kind, monkeypatch, device="cpu")
    q_j, frames_j = jax_dumps[kind]
    assert calls, "the dumps did not take the D route"
    assert sorted(frames_t) == sorted(frames_j) == sorted(MODES)
    n = 1 if kind == "image" else 5
    for stem in MODES:
        a, b = frames_t[stem], frames_j[stem]
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape and a.shape[0] == n
        assert int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= CODE_TOL, stem
    test, ref, order, fps = _inputs(kind)
    q_pooled, _ = ct.cvvdp(display_name="standard_fhd", device="cpu").predict(
        test, ref, dim_order=order, frames_per_second=fps)
    assert abs(q_t - q_j) <= JOD_TOL and abs(q_t - float(q_pooled)) <= JOD_TOL


def test_dump_files_are_written(tmp_path):
    """An image's dumps through the real writers: three PNGs."""
    from PIL import Image

    test, ref, order, fps = _inputs("image")
    dump = dc_t.DumpChannels(output_dir=str(tmp_path))
    ct.cvvdp(display_name="standard_fhd", device="cpu", dump_channels=dump).predict(
        test, ref, dim_order=order)
    for stem, shape in (("temp_channels", (128, 192, 3)), ("lpyr", (136, 296, 3)),
                        ("diff", (136, 296, 3))):
        assert np.asarray(Image.open(tmp_path / f"{stem}.png")).shape == shape
