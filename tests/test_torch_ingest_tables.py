"""The ingest kernel's code-value tables (``ops/kernels/ingest.py``
``eotf_table_plain``, ``eotf_from_table``) against the JAX package's EOTF
and against the port's direct conversion.

The kernel builds the table of every code value on the card; its plain
version runs here. For sRGB, PQ, linear and gamma displays an entry is the
channel's luminance; for HLG it is the inverse OETF s(v), and the pixel's
OOTF follows the lookup. Codes go in as grey pixels (the three channels
equal), so that HLG's OOTF sees a whole pixel.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import colorvideovdp_tpu as cj  # noqa: E402
import colorvideovdp_tpu_torch as ct  # noqa: E402
from colorvideovdp_tpu_torch.ops.kernels import ingest as ing  # noqa: E402

DISPLAYS = ["standard_4k", "standard_hdr_pq", "standard_hdr_hlg", "gamma2.2"]
DTYPES = [torch.uint8, torch.int16, torch.float16]  # int16 carries uint16 bits


def _displays(name):
    if name == "gamma2.2":
        kw = dict(contrast=1000, source_colorspace="Adobe RGB (1998)", E_ambient=100)
        dj, dt = cj.vvdp_display_photo_eotf(200, **kw), ct.vvdp_display_photo_eotf(200, **kw)
        assert dt.EOTF == "2.2"
        return dj, dt
    return cj.vvdp_display_photometry.load(name), ct.vvdp_display_photometry.load(name)


def _codes(dtype):
    """Every code value of ``dtype`` as a raw tensor, and the same samples as
    float32 on the JAX side's dtype ladder (numpy's IEEE division)."""
    if dtype == torch.uint8:
        raw = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        return raw, raw.numpy().astype(np.float32) / np.float32(255)
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    if dtype == torch.float16:
        raw = bits.view(torch.float16)
        return raw, raw.numpy().astype(np.float32)
    return bits, bits.numpy().view(np.uint16).astype(np.float32) / np.float32(65535)


def _pq_exact(v):
    """Codes where XLA's two float32 PQ powers are correctly rounded (the
    port takes both in float64 and rounds once): there the two EOTFs give the
    same bits (``tests/test_torch_kernels.py::test_pq2lin_matches_jax``)."""
    y1, y2 = np.float32(1 / 78.84375), np.float32(1 / 0.1593017578125)
    vc = np.clip(v, 0.0, 1.0)
    im = np.asarray(jnp.power(jnp.asarray(vc), 1.0 / 78.84375))
    q = np.asarray(jnp.clip(jnp.asarray(im) - 0.8359375, 0.0, None)
                   / (18.8515625 - 18.6875 * jnp.asarray(im)))
    return ((im == (vc.astype(np.float64) ** np.float64(y1)).astype(np.float32))
            & (np.asarray(jnp.power(jnp.asarray(q), 1.0 / 0.1593017578125))
               == (q.astype(np.float64) ** np.float64(y2)).astype(np.float32)))


@pytest.mark.parametrize("display", DISPLAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["uint8", "uint16", "float16"])
def test_eotf_table_matches_jax(display, dtype):
    """The table of every code value, looked up for grey pixels, against the
    JAX package's EOTF of the same samples: within 1e-6 relative; PQ to the
    bit wherever XLA's powers are correctly rounded, and within 1e-4
    relative elsewhere (the bound of ``test_pq2lin_matches_jax``).
    float16 codes that are not finite are left out (both give NaN or clamp
    them)."""
    dj, dt = _displays(display)
    table = ing.eotf_table_plain(dt, dtype)
    raw, v = _codes(dtype)
    assert table.shape == (raw.numel(),) and table.dtype == torch.float32
    grey = raw.reshape(1, 1, 1, 1, -1).expand(-1, -1, 3, -1, -1).contiguous()
    L_t = ing.eotf_from_table(dt, table, grey)[0, 0, 0, 0].numpy()
    L_j = np.asarray(dj.forward(jnp.asarray(np.broadcast_to(v, (3, 1, 1, v.size)))))[0, 0, 0]
    keep = np.isfinite(v)
    L_t, L_j, v = L_t[keep], L_j[keep], v[keep]
    rel = np.abs(L_t.astype(np.float64) - L_j) / np.abs(L_j)
    if dt.EOTF == "PQ":
        exact = _pq_exact(v)
        assert exact.mean() > 0.99
        assert np.array_equal(L_t[exact], L_j[exact])
        assert float(rel.max()) <= 1e-4
    else:
        assert float(rel.max()) <= 1e-6
    if dt.EOTF != "HLG":  # the entry is the channel's luminance itself
        assert torch.equal(table[torch.from_numpy(np.flatnonzero(keep))], torch.from_numpy(L_t))


@pytest.mark.parametrize("display", DISPLAYS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["uint8", "uint16", "float16"])
@pytest.mark.parametrize("channels", [3, 1])
def test_table_route_is_the_direct_conversion(display, dtype, channels):
    """Seeded frames through the table and through the port's plain chain
    (``dm.forward`` of ``raw_to_float``): the same bits, colour and
    luminance-only content (HLG's OOTF weighs the one channel three times in
    both). The frames hold a multiple of 16 samples per row, so PyTorch's
    CPU kernels take every sample through the same vector path in both."""
    _, dt = _displays(display)
    rng = np.random.RandomState(7)
    shape = (1, 2, channels, 8, 16)
    if dtype == torch.uint8:
        raw = torch.from_numpy((rng.rand(*shape) * 256).astype(np.uint8))
    elif dtype == torch.int16:
        raw = torch.from_numpy((rng.rand(*shape) * 65536).astype(np.uint16).view(np.int16))
    else:
        raw = torch.from_numpy((rng.rand(*shape) * 1.2 - 0.1).astype(np.float16))
    via_table = ing.eotf_from_table(dt, ing.eotf_table_plain(dt, dtype), raw)
    direct = dt.forward(ing.raw_to_float(raw).transpose(1, 2))
    assert via_table.shape == direct.shape == (1, channels, 2, 8, 16)
    assert torch.equal(via_table, direct)
