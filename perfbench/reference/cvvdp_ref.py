"""Plain PyTorch ColorVideoVDP: the benchmark's frozen reference.

The calibrated default configuration of ColorVideoVDP v0.5.6, as
``data/cvvdp_parameters.json`` states it: Weber contrast ``weber_g1`` on a
decimated Laplacian pyramid, the castleCSF lookup table ``weber_fixed_size``,
``mult-mutual`` masking with the cross-channel mix and the soft clamp, the
four temporal channels of a video (sustained Y, rg, yv and transient Y), and
the pooling to JOD. The display models are those of ``data/
display_models.json`` (photometry and viewing geometry). Every data file it
reads is its own copy under ``data/``.

It imports nothing of the measured program, and takes nothing the program
made: frames and parameters in, JOD, the per-band quality ``Q_per_ch`` and,
for the loss, the gradient out. Arithmetic is float32 (``dtype``) element by
element, in plain tensor operations: no matrix product and no convolution,
so the TF32 switches change no bit of it. Clipping keeps the convention of
the metric it stands for: a value equal to a bound passes half of its
gradient (``torch.maximum``/``torch.minimum``, not ``torch.clamp``).

Videos are scored in blocks of frames, the fl - 1 frames of the temporal
filter carried between blocks, so that a 4K clip fits beside the program;
the loss is taken one image of the batch at a time (its gradient is the sum
of theirs). ``dtype=torch.bfloat16`` computes every step in bfloat16: the
benchmark's control of a lower precision.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

XYZ_TO_LMS2006 = np.array([[0.187596268556126, 0.585168649077728, -0.026384263306304],
                           [-0.133397430663221, 0.405505777260049, 0.034502127690364],
                           [0.000244379021663, -0.000542995890619, 0.019406849066323]],
                          np.float32)
LMS2006_TO_DKLD65 = np.array([[1.0, 1.0, 0.0], [1.0, -2.311130179947035, 0.0],
                              [-1.0, -1.0, 50.977571328718781]], np.float32)
PQ_N, PQ_M = 0.15930175781250000, 78.843750000000000
PQ_C1, PQ_C2, PQ_C3 = 0.83593750000000000, 18.851562500000000, 18.687500000000000
K5 = np.array([0.05, 0.25, 0.4, 0.25, 0.05], np.float32)  # reduce/expand taps, a = 0.4
EPS = 1e-5
RHO_BASEBAND = 0.1  # cpd of the baseband's CSF


def _json(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def spow(x, p):
    """(x + eps)^p - eps^p; small integer and root exponents as products."""
    x = x + EPS
    if p == 2.0:
        y = x * x
    elif p == 4.0:
        y = (x * x) * (x * x)
    elif p == 0.5:
        y = torch.sqrt(x)
    elif p == 0.25:
        y = torch.sqrt(torch.sqrt(x))
    else:
        y = x ** p
    return y - EPS ** p


def lp_norm(x, p, dim, normalize, keepdim=False):
    n = 1
    for d in (dim if isinstance(dim, tuple) else (dim,)):
        n *= x.shape[d]
    s = torch.sum(spow(x, float(p)), dim=dim, keepdim=keepdim) / float(n if normalize else 1)
    return spow(s, 1.0 / float(p))


class Display:
    """Photometry (display-encoded values -> cd/m^2) and geometry (pixels
    per degree) of one entry of ``display_models.json``."""

    def __init__(self, name):
        m = _json("display_models.json")[name]
        space = _json("color_spaces.json")[m.get("colorspace", "sRGB")]
        self.eotf = space["EOTF"]
        self.rgb2xyz = np.array([space["RGB2X"], space["RGB2Y"], space["RGB2Z"]], np.float32)
        self.y_peak = float(m["max_luminance"])
        contrast = (self.y_peak / m["min_luminance"] if "min_luminance" in m
                    else m.get("contrast", 500))
        self.y_black = self.y_peak / contrast
        self.y_refl = m.get("E_ambient", 0) / math.pi * m.get("k_refl", 0.005)
        if m.get("exposure", 1) != 1:
            raise ValueError("the reference takes displays of exposure 1")
        W, H = m["resolution"]
        ar = W / H
        height_mm = math.sqrt((m["diagonal_size_inches"] * 25.4) ** 2 / (1 + ar ** 2))
        width_m = ar * height_mm / 1000
        pix_deg = 2 * math.degrees(math.atan(0.5 * width_m / W / m["viewing_distance_meters"]))
        self.ppd = 1 / pix_deg

    def luminance(self, V):
        """Display-encoded V in [0, 1] -> emitted cd/m^2 (sRGB or PQ)."""
        V = clip(V, 0.0, 1.0)
        if self.eotf == "sRGB":
            lin = torch.where(V > 0.04045, ((V + 0.055) / 1.055) ** 2.4, V / 12.92)
            return (self.y_peak - self.y_black) * lin + self.y_black + self.y_refl
        if self.eotf == "PQ":
            # Each power correctly rounded: taken in float64, rounded once.
            im_t = torch.pow(V.double(), float(np.float32(1 / PQ_M))).to(V.dtype)
            frac = clip(im_t - PQ_C1, 0.0) / (PQ_C2 - PQ_C3 * im_t)
            L = 10000.0 * torch.pow(frac.double(), float(np.float32(1 / PQ_N))).to(V.dtype)
            return clip(L, 0.005, self.y_peak) + self.y_black + self.y_refl
        raise ValueError(f"the reference takes sRGB and PQ displays, not {self.eotf}")

    def rgb2dkl(self):
        return (LMS2006_TO_DKLD65 @ XYZ_TO_LMS2006 @ self.rgb2xyz).astype(np.float32)


def color_matrix(img, M):
    """3x3 matrix along the colour axis (-4) as weighted channel sums."""
    rows = []
    for r in range(3):
        w = torch.as_tensor(M[r], dtype=img.dtype, device=img.device).reshape(3, 1, 1, 1)
        rows.append(torch.sum(img * w, dim=-4, keepdim=True))
    return torch.cat(rows, dim=-4)


def temporal_filters(fps, sigma_tf, beta_tf):
    """The four FIR filters (sustained x3, transient), length ceil(fps / 8) * 2 + 1."""
    N = int(math.ceil(0.250 * fps / 2) * 2) + 1
    omega = np.linspace(0.0, fps / 2.0, N // 2 + 1, dtype=np.float32)[None, :]
    s, b = np.asarray(sigma_tf, np.float32), np.asarray(beta_tf, np.float32)
    R = np.empty((4, N // 2 + 1), np.float32)
    R[0:3] = np.exp(-(omega ** b[0:3, None]) / s[0:3, None])
    R[3:4] = np.exp(-((omega ** b[3] - np.float32(5.0) ** b[3]) ** 2) / s[3])
    return np.stack([np.fft.fftshift(np.real(np.fft.irfft(r, n=N))).astype(np.float32)
                     for r in R])


def _sl(x, dim, a, b, step=1):
    return x[..., a:b:step] if dim == -1 else x[..., a:b:step, :]


def _reduce_1d(x, dim, odd):
    n = x.shape[dim]
    n_out = (n + 1) // 2
    xp = torch.nn.functional.pad(x, [2, 2] if dim == -1 else [0, 0, 2, 2])
    y = None
    for t in range(5):
        term = float(K5[t]) * _sl(xp, dim, t, t + 2 * n_out - 1, 2)
        y = term if y is None else y + term
    first = _sl(y, dim, 0, 1) + _sl(x, dim, 0, 1) * float(K5[1]) + _sl(x, dim, 1, 2) * float(K5[0])
    if odd:
        last = (_sl(y, dim, n_out - 1, n_out) + _sl(x, dim, n - 1, n) * float(K5[3])
                + _sl(x, dim, n - 2, n - 1) * float(K5[4]))
    else:
        last = _sl(y, dim, n_out - 1, n_out) + _sl(x, dim, n - 1, n) * float(K5[4])
    mid = [_sl(y, dim, 1, n_out - 1)] if n_out > 2 else []
    return torch.cat([first, *mid, last], dim=dim)


def reduce(x):
    """Gaussian reduce of the last two axes. Both passes key their last-sample
    correction on the parity of the row count (as the reference metric does)."""
    odd = x.shape[-2] % 2 == 1
    return _reduce_1d(_reduce_1d(x, -2, odd), -1, odd)


def _expand_1d(x, dim, size):
    n = x.shape[dim]
    xp = torch.cat([_sl(x, dim, 0, 1), x, _sl(x, dim, n - 1, n)], dim=dim)
    n_ev, n_od = (size + 1) // 2, size // 2
    ev = (2 * float(K5[0]) * _sl(xp, dim, 0, n_ev) + 2 * float(K5[2]) * _sl(xp, dim, 1, 1 + n_ev)
          + 2 * float(K5[4]) * _sl(xp, dim, 2, 2 + n_ev))
    od = 2 * float(K5[1]) * _sl(xp, dim, 1, 1 + n_od) + 2 * float(K5[3]) * _sl(xp, dim, 2, 2 + n_od)
    ax = dim % x.ndim
    shape = list(x.shape)
    shape[ax] = 2 * n_od
    out = torch.stack([_sl(ev, dim, 0, n_od), od], dim=ax + 1).reshape(shape)
    if n_ev > n_od:
        out = torch.cat([out, _sl(ev, dim, n_ev - 1, n_ev)], dim=dim)
    return out


def expand(x, size):
    return _expand_1d(_expand_1d(x, -2, size[0]), -1, size[1])


def band_freqs(W, H, ppd):
    """Peak frequency (cpd) of each band, the baseband's last, down to 0.2 cpd."""
    max_levels = int(np.floor(np.log2(min(H, W)))) - 1
    bands = np.concatenate([[1.0], np.power(2.0, -np.arange(0.0, 14.0)) * 0.3228]) * ppd / 2.0
    invalid = np.nonzero(bands <= 0.2)[0]
    height = int(np.clip((max_levels if invalid.size == 0 else invalid[0]) + 1, 0, max_levels))
    return np.array([1.0] + [0.3228 * 2.0 ** (-f) for f in range(height)]) * ppd / 2.0


def _blur_1d(x, k, dim):
    r, n = (len(k) - 1) // 2, x.shape[dim]
    idx = torch.as_tensor(np.pad(np.arange(n), (r, r), mode="reflect"), device=x.device)
    xp = x.index_select(dim, idx)
    y = None
    for i in range(len(k)):
        term = float(k[i]) * xp.narrow(dim, i, n)
        y = term if y is None else y + term
    return y


class CVVDPReference:
    """ColorVideoVDP of one display on ``device``, computed in ``dtype``."""

    def __init__(self, display_name, device="cpu", dtype=torch.float32, block_pixels=1 << 28):
        self.dev, self.dt = torch.device(device), dtype
        self.display = Display(display_name)
        p = _json("cvvdp_parameters.json")
        if (p["contrast"], p["masking_model"], p["dclamp_type"], p["xchannel_masking"]) != (
                "weber_g1", "mult-mutual", "soft", "on"):
            raise ValueError("the reference computes the default configuration only")
        self.p = p
        self.sens_corr = 10.0 ** (p["sensitivity_correction"] / 20.0)
        self.mask_q = [float(q) for q in p["mask_q"]]
        self.xcm = np.power(2.0, np.asarray(p["xcm_weights"], np.float32)).reshape(4, 4)
        self.ch_w = np.array([1.0, p["ch_chrom_w"], p["ch_chrom_w"], p["ch_trans_w"]], np.float32)
        r = float(p["pu_dilate"])
        half = int(r * 4) // 2
        x = np.linspace(-half, half, 2 * half + 1, dtype=np.float32)
        pdf = np.exp(-0.5 * (x / r) ** 2)
        self.taps = pdf / pdf.sum()
        self.pad = int(r * 2)
        lut = _json(f"csf_lut_{p['csf']}.json")
        self.log_L = np.log10(np.asarray(lut["L_bkg"], np.float32))
        self.log_rho = np.log10(np.asarray(lut["rho"], np.float32))
        self.logS = {(o, c): np.asarray(lut[f"o{o}_c{c + 1}"], np.float32)
                     for o, c in ((0, 0), (0, 1), (0, 2), (5, 0))}
        self.block_pixels = block_pixels

    # -- front end -------------------------------------------------------

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.dev).to(self.dt)

    def to_dkl(self, V):
        """Display-encoded (B, 3, F, H, W) -> DKL cd/m^2."""
        return color_matrix(self.display.luminance(V.to(self.dt)), self.display.rgb2dkl())

    def _frames(self, a, dim_order, f0, f1):
        """Frames [f0, f1) of the host array ``a`` as (1, 3, F, H, W) in [0, 1]."""
        order = dim_order.upper()
        if "F" in order:
            a = np.take(a, np.arange(f0, f1), axis=order.index("F"))
        else:
            a, order = a[..., None], order + "F"
        perm = [order.index(d) for d in "CFHW"]
        x = torch.from_numpy(np.ascontiguousarray(a.view(np.int16) if a.dtype == np.uint16 else a))
        x = x.to(self.dev).permute(perm)[None]
        if x.dtype == torch.uint8:
            return x.to(torch.float32) / 255.0
        if x.dtype == torch.int16:
            return (x.to(torch.int32) & 0xFFFF).to(torch.float32) / 65535.0
        return x.to(torch.float32)

    # -- one block of frames -------------------------------------------------

    def csf_rows(self, rho, n_ch):
        """log10 S over the LUT's log L grid for each channel at ``rho``."""
        q = np.log10(np.float32(rho))
        rows = []
        for cc in range(n_ch):
            S = self.logS[(0, cc) if cc < 3 else (5, 0)]
            i = int(np.clip(np.searchsorted(self.log_rho, q) - 1, 0, len(self.log_rho) - 2))
            x0, x1 = self.log_rho[i], self.log_rho[i + 1]
            rows.append(S[:, i] + (S[:, i + 1] - S[:, i]) / (x1 - x0) * (q - x0))
        return np.stack(rows).astype(np.float32)

    def csf(self, logL, rows):
        """S (C, *logL.shape): 10 ^ the lerp of ``rows`` at logL on the uniform
        log-L grid, clamped to its ends."""
        nk = rows.shape[1]
        x0, x1 = float(self.log_L[0]), float(self.log_L[-1])
        ind = torch.clamp((logL - x0) * ((nk - 1) / (x1 - x0)), 0.0, float(nk - 1))
        f0 = torch.floor(ind)
        i0 = torch.clamp(f0, max=nk - 2).long()
        t = self._t(rows)
        v = t[:, i0] + (ind - f0) * (t[:, i0 + 1] - t[:, i0])
        v = torch.where(f0 >= nk - 1, t[:, nk - 1].reshape((-1,) + (1,) * logL.ndim), v)
        return torch.pow(10.0, v)

    def band_D(self, gi, gn, rho, mul):
        """D (B, C, F, h, w) of an interior band from its level gi and the next
        level gn, (B, 2C, F, ., .) with test channels even, reference odd."""
        E = expand(gn, gi.shape[-2:])
        L_t, L_r = clip(E[:, 0:1], 0.01), clip(E[:, 1:2], 0.01)
        T = clip((gi[:, 0::2] - E[:, 0::2]) / L_t, hi=1000.0) * mul
        R = clip((gi[:, 1::2] - E[:, 1::2]) / L_r, hi=1000.0) * mul
        del E
        C = T.shape[1]
        S = self.csf(torch.log10(L_r[:, 0]), self.csf_rows(rho, C)).movedim(0, 1) * self.sens_corr
        g = self._t([1.0, 1.45, 1.0, 1.0][:C]).reshape(1, C, 1, 1, 1)
        T_p, R_p = T * S * g, R * S * g
        del T, R, S
        M = torch.minimum(torch.abs(T_p), torch.abs(R_p))
        if gi.shape[-2] > self.pad and gi.shape[-1] > self.pad:
            M = _blur_1d(_blur_1d(M, self.taps, M.ndim - 2), self.taps, M.ndim - 1)
        M = M * 10.0 ** self.p["mask_c"]
        q = self._t(self.mask_q[:C]).reshape(C, 1, 1, 1)
        Mq = (torch.abs(M) + EPS) ** q - EPS ** q
        del M
        mix = torch.cat([sum(float(self.xcm[c, d]) * Mq[:, c:c + 1] for c in range(C))
                         for d in range(C)], dim=1)
        D = spow(torch.abs(T_p - R_p), float(self.p["mask_p"])) / (1.0 + mix)
        max_v = 10.0 ** self.p["d_max"]
        return max_v * D / (max_v + D)

    def block_Q(self, R, freqs):
        """Q (B, C, F, bands) of an interleaved block R (B, 2C, F, H, W)."""
        levels = [R]
        for _ in range(len(freqs) - 1):
            levels.append(reduce(levels[-1]))
        beta = float(self.p["beta"])
        Q = []
        for b in range(len(freqs) - 1):
            # Interior bands above the first are read at double gain.
            D = self.band_D(levels[b], levels[b + 1], freqs[b], 1.0 if b == 0 else 2.0)
            Q.append(lp_norm(D, beta, (-2, -1), True))
            del D
        g = levels[-1]
        L_bkg = torch.mean(clip(g[:, 0:2], 0.01), dim=(-1, -2), keepdim=True)
        T = clip(g[:, 0::2] / L_bkg[:, 0:1], hi=1000.0)
        Rb = clip(g[:, 1::2] / L_bkg[:, 1:2], hi=1000.0)
        C = T.shape[1]
        S = self.csf(torch.log10(L_bkg[:, 1]), self.csf_rows(RHO_BASEBAND, C)).movedim(0, 1)
        Q.append(lp_norm(torch.abs(T - Rb) * (S * self.sens_corr), beta, (-2, -1), True))
        return torch.stack(Q, dim=-1)

    # -- pooling -------------------------------------------------------------

    def jod(self, Q):
        """JOD (B,) of Q (B, C, F, bands)."""
        p = self.p
        B, C, F, nb = Q.shape
        w = self._t(self.ch_w[:C]).reshape(1, C, 1, 1)
        wb = np.ones((1, C, 1, nb), np.float32)
        wb[:, :, 0, -1] = np.asarray(p["baseband_weight"], np.float32)[:C]
        Q_sc = lp_norm(Q * w * self._t(wb), p["beta_sch"], 3, False, keepdim=True)
        Q_tc = lp_norm(Q_sc, p["beta_tch"], 1, False, keepdim=True)
        Q = Q_tc * p["image_int"] if F == 1 else lp_norm(Q_tc, p["beta_t"], 2, True, keepdim=True)
        Q = Q.reshape(B)
        a, e = p["jod_a"], p["jod_exp"]
        a_lin = a * 0.1 ** (e - 1.0)
        return torch.where(Q <= 0.1, 10.0 - a_lin * Q, 10.0 - a * clip(Q, 0.1) ** e)

    # -- entry points --------------------------------------------------------

    @torch.no_grad()
    def score(self, test, ref, dim_order, fps=0.0):
        """(JOD, Q_per_ch (1, C, F, bands) float32) of a test/reference pair of
        host arrays (uint8, uint16 or float32) laid out as ``dim_order``, a
        permutation of "FCHW" or "CHW"/"HWC" (an image) with no batch axis."""
        order = dim_order.upper()
        N = test.shape[order.index("F")] if "F" in order else 1
        H, W = test.shape[order.index("H")], test.shape[order.index("W")]
        freqs = band_freqs(W, H, self.display.ppd)
        if N == 1:
            T, R = (self.to_dkl(self._frames(a, dim_order, 0, 1)) for a in (test, ref))
            Q = self.block_Q(torch.stack([T, R], dim=2).reshape(1, 6, 1, H, W), freqs)
            return float(self.jod(Q)[0]), Q.float().cpu().numpy()
        filt = self._t(temporal_filters(fps, self.p["sigma_tf"], self.p["beta_tf"])[:, ::-1].copy())
        fl = filt.shape[1]
        blk = max(1, self.block_pixels // (H * W * 8))
        tails, Qs = [None, None], []
        for f0 in range(0, N, blk):
            f1 = min(N, f0 + blk)
            chans = []
            for s, a in enumerate((test, ref)):
                new = self.to_dkl(self._frames(a, dim_order, f0, f1))
                if tails[s] is None:
                    tails[s] = new[:, :, :1].expand(-1, -1, fl - 1, -1, -1)
                buf = torch.cat([tails[s], new], dim=2)
                tails[s] = buf[:, :, f1 - f0:].contiguous()
                buf4 = torch.cat([buf, buf[:, 0:1]], dim=1)
                out = None
                for t in range(fl):
                    term = buf4[:, :, t:t + f1 - f0] * filt[:, t].reshape(1, 4, 1, 1, 1)
                    out = term if out is None else out + term
                chans.append(out)
                del new, buf, buf4
            R = torch.stack(chans, dim=2).reshape(1, 8, f1 - f0, H, W)
            del chans
            Qs.append(self.block_Q(R, freqs))
            del R
        Q = torch.cat(Qs, dim=2)
        return float(self.jod(Q)[0]), Q.float().cpu().numpy()

    def loss_grad(self, test, ref):
        """(mean over the batch of 10 - JOD, its gradient in ``test``) of
        display-encoded (B, 3, 1, H, W) float32 image pairs."""
        B, _, _, H, W = test.shape
        freqs = band_freqs(W, H, self.display.ppd)
        total, grads = 0.0, []
        for b in range(B):
            t = test[b:b + 1].detach().to(self.dev, self.dt).requires_grad_(True)
            with torch.enable_grad():
                T, R = self.to_dkl(t), self.to_dkl(ref[b:b + 1].to(self.dev, self.dt))
                Q = self.block_Q(torch.stack([T, R], dim=2).reshape(1, 6, 1, H, W), freqs)
                loss = (10.0 - self.jod(Q)[0]) / B
                (g,) = torch.autograd.grad(loss, t)
            total += float(loss.detach())
            grads.append(g.float())
        return total, torch.cat(grads)

    def loss(self, test, ref):
        """The differentiable mean of 10 - JOD over a display-encoded (B, 3, 1,
        H, W) batch, whole: what the control puts in the program's place."""
        B, _, _, H, W = test.shape
        T, R = self.to_dkl(test.to(self.dt)), self.to_dkl(ref.to(self.dt))
        C = T.shape[1]
        Q = self.block_Q(torch.stack([T, R], dim=2).reshape(B, 2 * C, 1, H, W),
                         band_freqs(W, H, self.display.ppd))
        return torch.mean(10.0 - self.jod(Q)).float()
