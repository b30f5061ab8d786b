"""ODE samplers of the rectified flow (counterpart of
visualcloze_tpu/transport/sampling.py: solver_arg, denoise_ode and
denoise_ode_adaptive).

Flux time (t = 1 noise); the model predicts flux-time velocity. N grid points
give N - 1 integrator steps. Where JAX runs one compiled lax.scan (or
while_loop), the port runs a Python loop over the same arithmetic: the times
and step sizes are fp32 scalars (numpy float32 here, as JAX's traced fp32
scalars), euler and heun carry x in its own dtype, ab2, cached[:K] and dopri5
integrate in fp32. The model sees t rounded to x's dtype and x cast to it.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch

ModelFn = Callable[..., torch.Tensor]
F32 = np.float32

_SOLVER_RE = re.compile(r"euler|heun|ab2|dopri5|cached(?::[1-9]\d*)?")


def solver_arg(name: str) -> str:
    """argparse ``type=`` validator for --solver: euler, heun, ab2, dopri5 or
    cached[:K] for any K >= 1."""
    if not _SOLVER_RE.fullmatch(name):
        raise ValueError(
            f"unknown solver {name!r}; expected euler, heun, ab2, dopri5, "
            "or cached[:K] with integer K >= 1"
        )
    return name


def _velocity_fn(model_fn: ModelFn, x: torch.Tensor, cond: torch.Tensor | None):
    """v(x_any, t): the model on concat(x in x's dtype, cond) at t (B,) in x's dtype."""
    b, dtype = x.shape[0], x.dtype

    def velocity(xc: torch.Tensor, t) -> torch.Tensor:
        t_vec = torch.full((b,), float(t), dtype=dtype, device=x.device)
        xi = xc.to(dtype)
        inp = torch.cat([xi, cond.to(dtype)], dim=-1) if cond is not None else xi
        return model_fn(inp, timesteps=t_vec)

    return velocity


def cached_fresh_schedule(n_steps: int, k_every: int) -> np.ndarray:
    """Which of the n_steps integrator steps of cached:K evaluate the model:
    the first two (so extrapolation never holds a single velocity), every
    K-th from the second, and the last."""
    fresh = np.zeros((n_steps,), dtype=bool)
    fresh[: min(2, n_steps)] = True
    fresh[1::k_every] = True
    fresh[-1] = True
    return fresh


def denoise_ode(
    model_fn: ModelFn,
    x: torch.Tensor,
    timesteps: np.ndarray,
    cond: torch.Tensor | None = None,
    method: str = "euler",
) -> torch.Tensor:
    """Integrate dx/dt = model_fn(concat(x, cond), timesteps=(B,)) over a
    descending flux-time grid (from ops.schedule.ode_timesteps).

    method: "euler"; "heun" (2 evaluations a step); "ab2" (Adams-Bashforth 2
    on the nonuniform grid, the first interval by Heun: N evaluations for N
    grid points); "cached[:K]" (the model on cached_fresh_schedule's steps
    only, the velocity extrapolated linearly in t from the last two
    evaluations in between). dopri5 is denoise_ode_adaptive."""
    ts = np.asarray(timesteps, dtype=F32)
    velocity = _velocity_fn(model_fn, x, cond)
    pairs = list(zip(ts[:-1], ts[1:]))
    dtype = x.dtype

    def dt_of(t_cur, t_next) -> torch.Tensor:  # the fp32 difference, rounded to x's dtype
        return torch.tensor(float(t_next - t_cur), dtype=torch.float32, device=x.device).to(dtype)

    if method == "euler":
        for t_cur, t_next in pairs:
            v = velocity(x, t_cur)
            x = x + dt_of(t_cur, t_next) * v.to(dtype)
        return x
    if method == "heun":
        for t_cur, t_next in pairs:
            dt = dt_of(t_cur, t_next)
            v1 = velocity(x, t_cur).to(dtype)
            x_mid = x + dt * v1
            v2 = velocity(x_mid, t_next).to(dtype)
            x = x + dt * 0.5 * (v1 + v2)
        return x
    if method == "ab2":
        # x_{n+1} = x_n + h_n [(1 + r/2) v_n - (r/2) v_{n-1}], r = h_n / h_{n-1}
        t0, t1 = pairs[0]
        h0 = F32(t1 - t0)
        v0 = velocity(x, t0).float()
        x32 = x.float()
        x_pred = x32 + float(h0) * v0
        v0b = velocity(x_pred, t1).float()
        x32 = x32 + float(F32(h0 * F32(0.5))) * (v0 + v0b)
        v_prev, h_prev = v0, h0  # v(t0): the first AB2 step pairs v(t1) with it
        for t_cur, t_next in pairs[1:]:
            h = F32(t_next - t_cur)
            v = velocity(x32, t_cur).float()
            r = F32(h / h_prev)
            x32 = x32 + float(h) * (float(F32(1.0) + F32(0.5) * r) * v - float(F32(0.5) * r) * v_prev)
            v_prev, h_prev = v, h
        return x32.to(dtype)
    m = re.fullmatch(r"cached(?::(\d+))?", method)
    if m is None:
        raise NotImplementedError(f"ODE method {method!r}")
    k_every = int(m.group(1) or 2)
    if k_every < 1:
        raise NotImplementedError(
            f"ODE method {method!r}: cached:K requires K >= 1 (K=1 is plain euler; K>=2 skips model evals)"
        )
    n_steps = len(pairs)
    fresh = cached_fresh_schedule(n_steps, k_every)
    t0 = F32(ts[0])
    v0 = velocity(x, ts[0]).float()
    x32 = x.float() + float(F32(ts[1]) - t0) * v0
    if n_steps == 1:
        return x32.to(dtype)
    # (v1, t1) the newest evaluation, (v2, t2) the one before; v2 = v1 at the
    # start makes the extrapolation slope exactly zero
    v1, t1, v2, t2 = v0, t0, v0, F32(t0 + F32(1.0))
    for (t_cur, t_next), is_fresh in zip(pairs[1:], fresh[1:]):
        t_cur, t_next = F32(t_cur), F32(t_next)
        if is_fresh:
            v = velocity(x32, t_cur).float()
            v1, t1, v2, t2 = v, t_cur, v1, t1
        else:
            v = v1 + (v1 - v2) * float(F32((t_cur - t1) / (t1 - t2)))
        x32 = x32 + float(F32(t_next - t_cur)) * v
    return x32.to(dtype)


# Dormand-Prince 5(4); FSAL: stage 7 is the next step's stage 1.
_DOPRI_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DOPRI_A = [
    np.array([1 / 5]),
    np.array([3 / 40, 9 / 40]),
    np.array([44 / 45, -56 / 15, 32 / 9]),
    np.array([19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]),
    np.array([9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]),
    np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]),
]
_DOPRI_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_DOPRI_B4 = np.array(
    [5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40]
)


def _combine(coeffs, ks):
    """sum(c * k) in the order of the JAX package's Python sum (starting at 0)."""
    return sum(float(c) * k for c, k in zip(coeffs, ks))


def denoise_ode_adaptive(
    model_fn: ModelFn,
    x: torch.Tensor,
    t_start: float,
    t_end: float,
    cond: torch.Tensor | None = None,
    atol: float = 1e-6,
    rtol: float = 1e-3,
    max_steps: int = 256,
    stats: dict | None = None,
) -> torch.Tensor:
    """Adaptive Dormand-Prince 5(4) from flux time t_start to t_end (I step
    control, FSAL). max_steps caps the trial steps, accepted and rejected; the
    last step is clamped onto t_end. If t_end is not reached (the cap, or a
    NaN model), the result is all NaN rather than a half-integrated latent.
    stats, if given, receives the evaluations and the accepted and rejected
    steps."""
    f_raw = _velocity_fn(model_fn, x, cond)

    def f(x32, t):
        return f_raw(x32, t).float()

    t_start, t_end = F32(t_start), F32(t_end)
    direction = F32(-1.0) if t_end < t_start else F32(1.0)
    span = abs(F32(t_end - t_start))
    x32 = x.float()
    t = t_start
    dt = F32(direction * span / F32(16.0))
    k1 = f(x32, t_start)
    n = accepted = 0
    while abs(F32(t - t_end)) > F32(1e-7) and n < max_steps:
        dt = F32(direction * min(abs(dt), abs(F32(t_end - t))))
        ks = [k1]
        for i, row in enumerate(_DOPRI_A):
            xi = x32 + float(dt) * _combine(row, ks)
            ks.append(f(xi, F32(t + F32(float(_DOPRI_C[i + 1])) * dt)))
        x5 = x32 + float(dt) * _combine(_DOPRI_B5, ks)
        err = float(dt) * _combine(_DOPRI_B5 - _DOPRI_B4, ks)
        tol = atol + rtol * torch.maximum(x32.abs(), x5.abs())
        err_norm = F32(torch.sqrt(torch.mean(torch.square(err / tol))).item())
        if err_norm <= 1.0:  # False on NaN: a NaN step is never accepted
            x32, t, k1 = x5, F32(t + dt), ks[-1]
            accepted += 1
        if np.isfinite(err_norm):
            factor = np.clip(F32(0.9) * np.power(max(err_norm, F32(1e-10)), F32(-0.2)), F32(0.2), F32(5.0))
        else:  # a non-finite error halves the step rather than poisoning it
            factor = F32(0.5)
        dt = F32(dt * F32(factor))
        n += 1
    if stats is not None:
        stats.update(evaluations=1 + 6 * n, accepted=accepted, rejected=n - accepted, t_final=float(t))
    if not abs(F32(t - t_end)) <= F32(1e-6):
        x32 = torch.full_like(x32, float("nan"))
    return x32.to(x.dtype)
