"""Seeded test content, made on the device from the run's seed.

Reference frames are band-limited noise (white noise on a grid 16 times
coarser, upsampled bilinearly) under an oriented sinusoidal grating that
moves across the frames; each channel gets its own mix of the two. A test
frame is its reference blurred by a seeded Gaussian (or not at all) plus
seeded white noise of a seeded amplitude. Every draw comes from a
``torch.Generator`` on the device, seeded from the run's seed and a stream
number, so the same seed gives the same content on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLUR_SIGMAS = (0.0, 0.8, 1.6, 2.4)  # pixels; 0 leaves the frame sharp
NOISE_RANGE = (0.004, 0.03)  # display-encoded units


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


class Scene:
    """One seeded scene of H x W pixels: ``frames(t0, n)`` renders frames
    t0 .. t0 + n - 1 as float32 (n, 3, H, W) in [0, 1]."""

    def __init__(self, g, H, W, device, mean=0.45, noise_amp=0.12, grating_amp=0.12):
        self.H, self.W, self.dev = H, W, device
        u = torch.rand(6, generator=g, device=device).tolist()
        coarse = torch.randn(1, 3, H // 16 + 2, W // 16 + 2, generator=g, device=device)
        field = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                                align_corners=False)[0]
        self.noise = field / field.std() * noise_amp
        self.theta = u[0] * math.pi
        self.freq = 1 / 64 + u[1] * (1 / 16 - 1 / 64)  # cycles per pixel
        self.speed = 0.5 + 1.5 * u[2]  # pixels per frame
        self.colour = torch.tensor([1.0, 0.6 + 0.4 * u[3], 0.6 + 0.4 * u[4]],
                                   device=device).reshape(3, 1, 1)
        self.mean, self.grating_amp = mean, grating_amp
        y = torch.arange(H, device=device, dtype=torch.float32).reshape(H, 1)
        x = torch.arange(W, device=device, dtype=torch.float32).reshape(1, W)
        self.proj = x * math.cos(self.theta) + y * math.sin(self.theta)

    def frames(self, t0: int, n: int) -> torch.Tensor:
        t = torch.arange(t0, t0 + n, device=self.dev, dtype=torch.float32).reshape(n, 1, 1, 1)
        phase = 2 * math.pi * self.freq * (self.proj - self.speed * t)
        out = self.mean + self.noise + self.grating_amp * self.colour * torch.sin(phase)
        return out.clamp(0.0, 1.0)


def blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of the last two axes, reflected at the edges."""
    if sigma <= 0:
        return x
    r = int(math.ceil(3 * sigma))
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, device=x.device, dtype=x.dtype) / sigma) ** 2)
    k = k / k.sum()
    for dim in (-2, -1):
        pad = [0, 0, r, r] if dim == -2 else [r, r, 0, 0]
        xp = torch.nn.functional.pad(x.reshape(-1, 1, *x.shape[-2:]), pad, mode="reflect")
        xp = xp.reshape(*x.shape[:-2], *xp.shape[-2:])
        n = x.shape[dim]
        x = sum(k[i] * xp.narrow(dim, i, n) for i in range(2 * r + 1))
    return x


def distort(g, ref: torch.Tensor) -> torch.Tensor:
    """Each frame of ``ref`` (n, 3, H, W) blurred by a seeded sigma of
    ``BLUR_SIGMAS`` plus seeded noise of a seeded amplitude."""
    n = ref.shape[0]
    u = torch.rand(2, n, generator=g, device=ref.device).tolist()
    out = torch.empty_like(ref)
    for i in range(n):
        sigma = BLUR_SIGMAS[min(int(u[0][i] * len(BLUR_SIGMAS)), len(BLUR_SIGMAS) - 1)]
        amp = NOISE_RANGE[0] + u[1][i] * (NOISE_RANGE[1] - NOISE_RANGE[0])
        noise = torch.randn(ref.shape[1:], generator=g, device=ref.device)
        out[i] = (blur(ref[i], sigma) + amp * noise).clamp(0.0, 1.0)
    return out


def quantise(x: torch.Tensor, dtype) -> torch.Tensor:
    """[0, 1] values -> uint8 or uint16 codes (uint16 as its int16 bits, which
    the host array reads back as uint16)."""
    if dtype == np.uint8:
        return torch.round(x * 255.0).to(torch.uint8)
    if dtype == np.uint16:
        return torch.round(x * 65535.0).to(torch.int32).to(torch.int16)
    raise ValueError(f"no quantisation to {dtype}")


def to_host(x: torch.Tensor, dtype) -> np.ndarray:
    a = x.cpu().numpy()
    return a.view(np.uint16) if dtype == np.uint16 else a
