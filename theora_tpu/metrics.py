"""Quality metrics: PSNR and SSIM.

The reference ships only PSNR tooling (examples/dump_psnr.c), but its
default activity masking (analyze.c:1152-1300) is perceptually
motivated and deliberately PSNR-suboptimal -- adjudicating masking
defaults on PSNR alone is circular.  SSIM
(Wang et al. 2004) is the standard HVS-weighted structural metric: an
11x11 Gaussian-weighted (sigma 1.5) local comparison of luminance,
contrast and structure, averaged over the image.

Implementation is pure numpy, vectorized as 11 shifted multiply-adds
per axis (separable Gaussian, 'valid' support) -- no scipy dependency.
"""
from __future__ import annotations

import numpy as np

_K1, _K2 = 0.01, 0.03
_WIN = 11
_SIGMA = 1.5


def _gaussian_kernel(n: int = _WIN, sigma: float = _SIGMA) -> np.ndarray:
    r = np.arange(n) - (n - 1) / 2.0
    w = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return w / w.sum()


_G = _gaussian_kernel()


def _filt_valid(x: np.ndarray) -> np.ndarray:
    """Separable Gaussian filter, 'valid' support (H-10, W-10)."""
    k = len(_G)
    h = x.shape[0] - k + 1
    w = x.shape[1] - k + 1
    # Rows.
    t = np.zeros((h, x.shape[1]), np.float64)
    for i, g in enumerate(_G):
        t += g * x[i : i + h]
    # Columns.
    out = np.zeros((h, w), np.float64)
    for i, g in enumerate(_G):
        out += g * t[:, i : i + w]
    return out


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float((d * d).mean())
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Mean SSIM over one plane (Wang et al. 2004 reference settings:
    11x11 Gaussian window sigma=1.5, K1=0.01, K2=0.03, valid support)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1 = (_K1 * peak) ** 2
    c2 = (_K2 * peak) ** 2
    mu_a = _filt_valid(a)
    mu_b = _filt_valid(b)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _filt_valid(a * a) - mu_aa
    var_b = _filt_valid(b * b) - mu_bb
    cov = _filt_valid(a * b) - mu_ab
    num = (2.0 * mu_ab + c1) * (2.0 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return float((num / den).mean())


def clip_luma_ssim(frames_a, frames_b) -> float:
    """Mean per-frame luma SSIM over a clip (each item: [y, u, v])."""
    vals = [ssim(fa[0], fb[0]) for fa, fb in zip(frames_a, frames_b)]
    return float(np.mean(vals)) if vals else float("nan")


def clip_luma_psnr(frames_a, frames_b) -> float:
    """Global luma PSNR over a clip (SSE pooled across frames, the
    dump_psnr.c convention)."""
    se = 0.0
    n = 0
    for fa, fb in zip(frames_a, frames_b):
        d = fa[0].astype(np.float64) - fb[0].astype(np.float64)
        se += float((d * d).sum())
        n += d.size
    if se == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 * n / se)
