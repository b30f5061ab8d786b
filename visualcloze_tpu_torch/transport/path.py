"""Coupling plans for flow matching (counterpart of visualcloze_tpu/transport/path.py).

Data-time convention, as in JAX and the reference: t = 1 is data, x_t =
alpha_t * x1 + sigma_t * x0. Only what training needs is ported: alpha_t,
sigma_t and their derivatives, x_t and the path velocity u_t; the score and
noise conversions of the SDE samplers wait for those samplers.
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


@dataclass(frozen=True)
class GVPCPlan(ICPlan):
    """Trigonometric (GVP) path."""

    def compute_alpha_t(self, t):
        return torch.sin(t * math.pi / 2), math.pi / 2 * torch.cos(t * math.pi / 2)

    def compute_sigma_t(self, t):
        return torch.cos(t * math.pi / 2), -math.pi / 2 * torch.sin(t * math.pi / 2)
