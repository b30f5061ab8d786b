"""Rectified-flow timestep schedules and embeddings (counterpart of
visualcloze_tpu/ops/schedule.py).

Time convention: `t` is flux time everywhere, t=1 is pure noise and t=0 is
data. Schedules are host-side numpy; the embedding runs on tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def timestep_embedding(
    t: torch.Tensor, dim: int, max_period: int = 10_000, time_factor: float = 1000.0
) -> torch.Tensor:
    """Sinusoidal embedding of (N,) timesteps, scaled by 1000 first -> (N, dim) fp32."""
    t = time_factor * t.to(torch.float32)
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def time_shift(mu: float, sigma: float, t):
    """Resolution shift in flux time: exp(mu) / (exp(mu) + (1/t - 1)^sigma)."""
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def get_lin_function(x1: float = 256, y1: float = 0.5, x2: float = 4096, y2: float = 1.15):
    """Linear map seq_len -> mu through (256, 0.5) and (4096, 1.15)."""
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def get_schedule(
    num_steps: int,
    image_seq_len: int,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
    shift: bool = True,
) -> np.ndarray:
    """BFL schedule: num_steps + 1 points from 1 to 0, optionally mu-shifted."""
    timesteps = np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float64)
    if shift:
        mu = get_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
        with np.errstate(divide="ignore"):
            timesteps = time_shift(mu, 1.0, timesteps)
        timesteps[-1] = 0.0
    return timesteps.astype(np.float32)


def ode_timesteps(
    num_points: int,
    image_seq_len: int,
    do_shift: bool = True,
    strength: float | None = None,
    time_shifting_factor: float | None = None,
) -> np.ndarray:
    """The sampling grid in flux time, descending: `num_points` points give
    num_points - 1 Euler steps; `strength` (SDEdit) starts at 1 - strength;
    `time_shifting_factor` f warps t -> t / (t + f - f t); `do_shift` applies
    the mu(seq_len) resolution shift."""
    t0, t1 = 0.0, 1.0
    if strength is not None:
        t0 = (t1 - t0) * strength + t0
    t_ode = np.linspace(t0, t1, num_points, dtype=np.float64)
    if time_shifting_factor:
        f = time_shifting_factor
        t_ode = t_ode / (t_ode + f - f * t_ode)
    s = 1.0 - t_ode
    if do_shift:
        mu = get_lin_function(y1=0.5, y2=1.15)(image_seq_len)
        with np.errstate(divide="ignore"):
            s = time_shift(mu, 1.0, s)
        s[np.isnan(s)] = 0.0
        s[-1] = 0.0
    return s.astype(np.float32)
