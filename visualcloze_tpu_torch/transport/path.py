"""Coupling plans for flow matching (counterpart of visualcloze_tpu/transport/path.py).

Data-time convention, as in JAX and the reference: t = 1 is data, x_t =
alpha_t * x1 + sigma_t * x0. Pure functions of (t, x): alpha_t, sigma_t and
their derivatives, x_t and the path velocity u_t (training), and the drift,
diffusion and score / noise / velocity conversions of the SDE samplers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def expand_t(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape (B,) time to broadcast against (B, ...) data."""
    return t.reshape(t.shape[0], *([1] * (x.dim() - 1)))


@dataclass(frozen=True)
class ICPlan:
    """Linear coupling: alpha_t = t, sigma_t = 1 - t."""

    sigma: float = 0.0

    def compute_alpha_t(self, t):
        return t, torch.ones_like(t)

    def compute_sigma_t(self, t):
        return 1 - t, -torch.ones_like(t)

    def compute_d_alpha_alpha_ratio_t(self, t):
        return 1 / t

    def compute_drift(self, x, t):
        """Score-parametrized SDE drift: returns (-drift_mean, diffusion)."""
        t = expand_t(t, x)
        alpha_ratio = self.compute_d_alpha_alpha_ratio_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        drift = alpha_ratio * x
        diffusion = alpha_ratio * (sigma_t ** 2) - sigma_t * d_sigma_t
        return -drift, diffusion

    def compute_diffusion(self, x, t, form: str = "constant", norm: float = 1.0):
        t = expand_t(t, x)
        if form == "constant":
            return torch.full_like(t, norm)
        if form == "SBDM":
            return norm * self.compute_drift(x, t.reshape(-1))[1]
        if form == "sigma":
            return norm * self.compute_sigma_t(t)[0]
        if form == "linear":
            return norm * (1 - t)
        if form == "decreasing":
            return 0.25 * (norm * torch.cos(math.pi * t) + 1) ** 2
        if form == "increasing-decreasing":
            return norm * torch.sin(math.pi * t) ** 2
        raise NotImplementedError(f"diffusion form {form!r}")

    def get_score_from_velocity(self, velocity, x, t):
        t = expand_t(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = sigma_t ** 2 - reverse_alpha_ratio * d_sigma_t * sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_noise_from_velocity(self, velocity, x, t):
        t = expand_t(t, x)
        alpha_t, d_alpha_t = self.compute_alpha_t(t)
        sigma_t, d_sigma_t = self.compute_sigma_t(t)
        reverse_alpha_ratio = alpha_t / d_alpha_t
        var = reverse_alpha_ratio * d_sigma_t - sigma_t
        return (reverse_alpha_ratio * velocity - x) / var

    def get_velocity_from_score(self, score, x, t):
        drift, var = self.compute_drift(x, t)
        return var * score - drift

    def compute_xt(self, t, x0, x1):
        t = expand_t(t, x1)
        alpha_t, _ = self.compute_alpha_t(t)
        sigma_t, _ = self.compute_sigma_t(t)
        return alpha_t * x1 + sigma_t * x0

    def compute_ut(self, t, x0, x1):
        t = expand_t(t, x1)
        _, d_alpha_t = self.compute_alpha_t(t)
        _, d_sigma_t = self.compute_sigma_t(t)
        return d_alpha_t * x1 + d_sigma_t * x0

    def plan(self, t, x0, x1):
        return t, self.compute_xt(t, x0, x1), self.compute_ut(t, x0, x1)


@dataclass(frozen=True)
class VPCPlan(ICPlan):
    """Variance-preserving path."""

    sigma_min: float = 0.1
    sigma_max: float = 20.0

    def _log_mean_coeff(self, t):
        return -0.25 * ((1 - t) ** 2) * (self.sigma_max - self.sigma_min) - 0.5 * (1 - t) * self.sigma_min

    def _d_log_mean_coeff(self, t):
        return 0.5 * (1 - t) * (self.sigma_max - self.sigma_min) + 0.5 * self.sigma_min

    def compute_alpha_t(self, t):
        alpha_t = torch.exp(self._log_mean_coeff(t))
        return alpha_t, alpha_t * self._d_log_mean_coeff(t)

    def compute_sigma_t(self, t):
        p = 2 * self._log_mean_coeff(t)
        sigma_t = torch.sqrt(1 - torch.exp(p))
        d_sigma_t = torch.exp(p) * (2 * self._d_log_mean_coeff(t)) / (-2 * sigma_t)
        return sigma_t, d_sigma_t

    def compute_d_alpha_alpha_ratio_t(self, t):
        return self._d_log_mean_coeff(t)

    def compute_drift(self, x, t):
        t = expand_t(t, x)
        beta_t = self.sigma_min + (1 - t) * (self.sigma_max - self.sigma_min)
        return -0.5 * beta_t * x, beta_t / 2


@dataclass(frozen=True)
class GVPCPlan(ICPlan):
    """Trigonometric (GVP) path."""

    def compute_alpha_t(self, t):
        return torch.sin(t * math.pi / 2), math.pi / 2 * torch.cos(t * math.pi / 2)

    def compute_sigma_t(self, t):
        return torch.cos(t * math.pi / 2), -math.pi / 2 * torch.sin(t * math.pi / 2)

    def compute_d_alpha_alpha_ratio_t(self, t):
        return math.pi / (2 * torch.tan(t * math.pi / 2))
