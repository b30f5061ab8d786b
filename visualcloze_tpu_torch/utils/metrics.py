"""Image-quality metrics of the eval harness (a copy of
visualcloze_tpu/utils/metrics.py): PSNR, MAE and a global SSIM, numpy only.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_value: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB. Arrays of any shape, same dtype
    domain (uint8 images or [0,1] floats with max_value=1)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_value ** 2 / mse)


def mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def ssim(a: np.ndarray, b: np.ndarray, max_value: float = 255.0) -> float:
    """Global SSIM (single-window variant — adequate for regression gating;
    use a strided implementation for paper-grade numbers)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * max_value) ** 2
    c2 = (0.03 * max_value) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    )
