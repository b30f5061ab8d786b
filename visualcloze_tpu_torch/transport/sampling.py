"""The Euler rectified-flow sampler (counterpart of
visualcloze_tpu/transport/sampling.py:denoise_ode, method="euler").

Flux time (t = 1 noise); the model predicts flux-time velocity; each step is
x += (t_next - t_cur) * v in x's dtype. N grid points give N - 1 steps.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def denoise_ode(
    model_fn: Callable[..., torch.Tensor],
    x: torch.Tensor,
    timesteps: np.ndarray,
    cond: torch.Tensor | None = None,
    method: str = "euler",
) -> torch.Tensor:
    """Integrate dx/dt = model_fn(concat(x, cond), timesteps=(B,)) over a
    descending flux-time grid (from ops.schedule.ode_timesteps)."""
    if method != "euler":
        raise NotImplementedError(f"solver {method!r} is not ported yet (euler only)")
    ts = torch.as_tensor(np.asarray(timesteps, dtype=np.float32))
    b = x.shape[0]
    for i in range(len(ts) - 1):
        t_vec = torch.full((b,), float(ts[i]), dtype=x.dtype, device=x.device)
        inp = torch.cat([x, cond.to(x.dtype)], dim=-1) if cond is not None else x
        v = model_fn(inp, timesteps=t_vec)
        dt = (ts[i + 1] - ts[i]).to(x.dtype).to(x.device)  # fp32 difference, then x's dtype
        x = x + dt * v.to(x.dtype)
    return x
