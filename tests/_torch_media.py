"""Seeded media files for the port's file-driven tests (the CLI, the channel
dumps, the preview metrics and the clip-list runner): PNG pairs and
sequences, 10-bit 4:2:0 BT.2020 .yuv pairs and 8-bit mp4 files, all made
from a seed in a test's temporary directory."""

import os

import numpy as np


def content(H, W, N, seed, noise=8.0):
    """A (test, reference) pair of uint8 (H, W, 3, N) frames: a smooth
    pattern with noise, and the same with added noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 0.5 + 0.3 * np.sin(xx / 7.0 + rng.rand() * 6)[..., None, None] * np.cos(
        yy / 5.0)[..., None, None]
    ref = (np.clip(base + rng.rand(H, W, 3, N) * 0.1, 0, 1) * 255).astype(np.uint8)
    test = np.clip(ref.astype(np.int16) + (rng.randn(*ref.shape) * noise).astype(np.int16),
                   0, 255).astype(np.uint8)
    return test, ref


def write_png_pair(dirname, H=64, W=96, seed=0, tag=""):
    from PIL import Image

    test, ref = content(H, W, 1, seed)
    names = []
    for name, a in ((f"test{tag}.png", test), (f"ref{tag}.png", ref)):
        path = os.path.join(dirname, name)
        Image.fromarray(a[..., 0]).save(path)
        names.append(path)
    return names


def write_png_sequences(dirname, H=64, W=96, N=5, seed=1):
    """%04d-numbered PNG sequences; returns the two patterns and the frames."""
    from PIL import Image

    test, ref = content(H, W, N, seed)
    patterns = []
    for tag, a in (("t", test), ("r", ref)):
        pattern = os.path.join(dirname, f"{tag}_%04d.png")
        for i in range(N):
            Image.fromarray(a[..., i]).save(pattern % i)
        patterns.append(pattern)
    return patterns, test, ref


def write_yuv_pair(dirname, H=64, W=96, N=5, seed=2, fps=24):
    """A 10-bit 4:2:0 BT.2020 limited-range .yuv pair (2x2 chroma means) of
    ``content``'s frames, named for the .yuv reader."""
    test, ref = content(H, W, N, seed)
    kr, kb = 0.2627, 0.0593
    luma = np.array([kr, 1.0 - kr - kb, kb])
    rows = [luma, (np.array([0.0, 0.0, 1.0]) - luma) / (2.0 * (1.0 - kb)),
            (np.array([1.0, 0.0, 0.0]) - luma) / (2.0 * (1.0 - kr))]
    names = []
    for tag, V in (("test", test), ("ref", ref)):
        name = os.path.join(dirname, f"{tag}_{W}x{H}p{fps}_420_10b_2020.yuv")
        with open(name, "wb") as f:
            for i in range(N):
                rgb = V[:, :, :, i].astype(np.float64) / 255.0
                planes = [rgb @ rows[0] * 219.0 + 16.0]
                for row in rows[1:]:
                    c = (rgb @ row).reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))
                    planes.append(c * 224.0 + 128.0)
                for plane in planes:
                    np.clip(np.round(plane * 4.0), 0, 1023).astype("<u2").tofile(f)
        names.append(name)
    return names


def write_mp4(path, frames, fps):
    """8-bit 4:2:0 libx264 mp4 of uint8 (H, W, 3, N) frames through the native
    codec core (BT.601 limited range)."""
    from colorvideovdp_tpu_torch.io.ffcodec import CodecVideoWriter, rgb_to_ycbcr_coeffs

    H, W, _, N = frames.shape
    rows = rgb_to_ycbcr_coeffs("601")
    w = CodecVideoWriter(str(path), W, H, fps, bit_depth=8, codec="libx264")
    for i in range(N):
        rgb = frames[..., i].astype(np.float64) / 255.0
        y = rgb @ rows[0] * 219.0 + 16.0
        u, v = ((rgb @ r).reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3)) * 224.0 + 128.0
                for r in rows[1:])
        w.write_frame_yuv(*(np.clip(np.round(p), 0, 255).astype(np.uint8) for p in (y, u, v)))
    w.close()
    return str(path)
