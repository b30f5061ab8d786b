"""Samplers of the rectified flow (counterpart of
visualcloze_tpu/transport/sampling.py): the ODE solvers (solver_arg,
denoise_ode, denoise_ode_adaptive), the SDE sampler (denoise_sde), the
likelihood ODE (sample_ode_likelihood) and the reference's Sampler API.

Flux time (t = 1 noise); the model predicts flux-time velocity. N grid points
give N - 1 integrator steps. Where JAX runs one compiled lax.scan (or
while_loop), the port runs a Python loop over the same arithmetic: the times
and step sizes are fp32 scalars (numpy float32 here, as JAX's traced fp32
scalars), euler and heun carry x in its own dtype, ab2, cached[:K], dopri5
and the SDE steps integrate in fp32. The model sees t rounded to x's dtype
and x cast to it. Random draws come from an explicit torch.Generator; the
SDE noise and the likelihood's probes can be handed in instead (the tests
hand in the values JAX drew).
"""

from __future__ import annotations

import functools
import math
import re
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops.schedule import ode_timesteps
from ..utils import tracing

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
    evaluations in between). dopri5 is denoise_ode_adaptive. Each state
    update between evaluations is a "solver.step" span."""
    ts = np.asarray(timesteps, dtype=F32)
    velocity = _velocity_fn(model_fn, x, cond)
    pairs = list(zip(ts[:-1], ts[1:]))
    dtype = x.dtype

    def dt_of(t_cur, t_next) -> torch.Tensor:  # the fp32 difference, rounded to x's dtype
        return torch.tensor(float(t_next - t_cur), dtype=torch.float32, device=x.device).to(dtype)

    if method == "euler":
        for t_cur, t_next in pairs:
            v = velocity(x, t_cur)
            with tracing.span("solver.step"):
                x = x + dt_of(t_cur, t_next) * v.to(dtype)
        return x
    if method == "heun":
        for t_cur, t_next in pairs:
            dt = dt_of(t_cur, t_next)
            v1 = velocity(x, t_cur).to(dtype)
            with tracing.span("solver.step"):
                x_mid = x + dt * v1
            v2 = velocity(x_mid, t_next).to(dtype)
            with tracing.span("solver.step"):
                x = x + dt * 0.5 * (v1 + v2)
        return x
    if method == "ab2":
        # x_{n+1} = x_n + h_n [(1 + r/2) v_n - (r/2) v_{n-1}], r = h_n / h_{n-1}
        t0, t1 = pairs[0]
        h0 = F32(t1 - t0)
        v0 = velocity(x, t0).float()
        with tracing.span("solver.step"):
            x32 = x.float()
            x_pred = x32 + float(h0) * v0
        v0b = velocity(x_pred, t1).float()
        with tracing.span("solver.step"):
            x32 = x32 + float(F32(h0 * F32(0.5))) * (v0 + v0b)
        v_prev, h_prev = v0, h0  # v(t0): the first AB2 step pairs v(t1) with it
        for t_cur, t_next in pairs[1:]:
            h = F32(t_next - t_cur)
            v = velocity(x32, t_cur).float()
            with tracing.span("solver.step"):
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
    with tracing.span("solver.step"):
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
        with tracing.span("solver.step"):
            if not is_fresh:
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


def _draws(given: Sequence[torch.Tensor] | None, n: int, make) -> list[torch.Tensor]:
    """`given` (n tensors), or n tensors from make()."""
    if given is not None:
        if len(given) != n:
            raise ValueError(f"{len(given)} draws handed in, {n} needed")
        return list(given)
    return [make() for _ in range(n)]


def denoise_sde(
    transport,
    model_fn: ModelFn,
    x: torch.Tensor,
    timesteps: np.ndarray,
    cond: torch.Tensor | None = None,
    diffusion_form: str = "SBDM",
    diffusion_norm: float = 1.0,
    last_step: str | None = "Mean",
    method: str = "Euler",
    generator: torch.Generator | None = None,
    noise: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Euler-Maruyama (or Heun) SDE sampler sharing its marginals with the
    flow ODE: with flux step ds < 0, dx = [v - w(t) score] ds + sqrt(2 w(t)
    |ds|) dW, w the path's diffusion of `diffusion_form` times
    `diffusion_norm`. Every step but the last is stochastic, the last one
    deterministic: "Mean" (the drift alone), "Euler" (the velocity alone),
    "Tweedie" (x / alpha + sigma^2 / alpha * score); last_step None makes
    every step stochastic. Heun draws its noise first, then averages the
    drift at both ends. noise: the N(0, 1) fp32 draws of the stochastic
    steps, one of x's shape each, instead of draws from `generator`."""
    b, dtype = x.shape[0], x.dtype
    plan = transport.path
    velocity = _velocity_fn(model_fn, x, cond)

    def diffusion_w(x_any, t):
        t_vec = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        return plan.compute_diffusion(x_any, 1.0 - t_vec, form=diffusion_form, norm=diffusion_norm)

    def drift_terms(xd, t):  # xd in x's dtype
        v = velocity(xd, t).float()
        t_vec = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        return v, transport.score_from_velocity(v, xd.float(), t_vec), diffusion_w(xd, t)

    def sde_drift(x32, t):
        v, score, w = drift_terms(x32.to(dtype), t)
        return v - w * score

    pairs = list(zip(np.asarray(timesteps, dtype=F32)[:-1], np.asarray(timesteps, dtype=F32)[1:]))
    if method not in ("Euler", "Heun"):
        raise NotImplementedError(f"SDE method {method!r}")
    if last_step not in (None, "Mean", "Euler", "Tweedie"):
        raise NotImplementedError(f"last_step {last_step!r}")
    stochastic = pairs if last_step is None else pairs[:-1]
    draws = _draws(noise, len(stochastic), lambda: torch.randn(
        x.shape, generator=generator, dtype=torch.float32, device=x.device))
    for (t_cur, t_next), dw in zip(stochastic, draws):
        ds = float(F32(t_next - t_cur))  # negative
        x32 = x.float()
        if method == "Euler":
            drift = sde_drift(x32, t_cur)
            x32 = x32 + drift * ds + torch.sqrt(2 * diffusion_w(x32, t_cur) * abs(ds)) * dw
        else:
            xhat = x32 + torch.sqrt(2 * diffusion_w(x32, t_cur) * abs(ds)) * dw
            k1 = sde_drift(xhat, t_cur)
            k2 = sde_drift(xhat + ds * k1, t_next)
            x32 = xhat + 0.5 * ds * (k1 + k2)
        x = x32.to(dtype)
    if last_step is None:
        return x
    t_cur, t_next = pairs[-1]
    dt = float(F32(t_next - t_cur))
    if last_step == "Mean":
        v, score, w = drift_terms(x, t_cur)
        return (x.float() + (v - w * score) * dt).to(dtype)
    if last_step == "Euler":
        return (x.float() + velocity(x, t_cur).float() * dt).to(dtype)
    _, score, _ = drift_terms(x, t_cur)  # Tweedie: alpha and sigma at transport time 1 - t
    t_tr = torch.full((b,), float(F32(F32(1.0) - t_cur)), dtype=torch.float32, device=x.device)
    alpha, sigma = plan.compute_alpha_t(t_tr)[0][0], plan.compute_sigma_t(t_tr)[0][0]
    return (x.float() / alpha + (sigma ** 2) / alpha * score).to(dtype)


def sample_ode_likelihood(
    model_fn: ModelFn,
    x: torch.Tensor,
    num_steps: int,
    cond: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    probes: Sequence[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The likelihood ODE with Hutchinson's divergence estimator: Euler from
    data to noise (flux time 0 -> 1, `num_steps` grid points), dx/dt = v,
    dlogp/dt = -div v, div v ~ eps^T J eps for a Rademacher probe eps each
    step. JAX takes J eps by forward mode (jvp); the port's kernels have
    backward rules only, so it takes eps^T J by one vector-Jacobian product
    (torch.autograd.grad): eps^T (J eps) = (eps^T J) eps, the same number.
    probes: the steps' probes (x's shape, +-1) instead of draws from
    `generator`. Returns (logp (B,) fp32, the terminal state)."""
    b, dtype = x.shape[0], x.dtype
    velocity = _velocity_fn(model_fn, x, cond)
    ts = np.linspace(0.0, 1.0, num_steps, dtype=F32)
    pairs = list(zip(ts[:-1], ts[1:]))
    eps_all = _draws(probes, len(pairs), lambda: (torch.randint(
        0, 2, x.shape, generator=generator, device=x.device) * 2 - 1).to(dtype))
    dims = tuple(range(1, x.dim()))
    logp = torch.zeros((b,), dtype=torch.float32, device=x.device)
    for (t_cur, t_next), eps in zip(pairs, eps_all):
        dt = float(F32(t_next - t_cur))
        eps = eps.to(dtype)
        x_in = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = velocity(x_in, t_cur)
            (vjp,) = torch.autograd.grad(v, x_in, eps.to(v.dtype))
        div_est = (vjp * eps).float().sum(dim=dims)
        x = x + dt * v.detach().to(dtype)
        logp = logp + dt * div_est
    n = math.prod(x.shape[1:])
    prior = -0.5 * n * math.log(2 * math.pi) - 0.5 * x.float().square().sum(dim=dims)
    return prior + logp, x


class Sampler:
    """The reference's Sampler API: sample_ode(...) and sample_sde(...)
    return a closure sample_fn(x, model_fn, model_kwargs) that builds the
    time grid from x's sequence length; model_kwargs' "cond" is the
    channel-concatenated conditioning, the rest go to model_fn."""

    def __init__(self, transport):
        self.transport = transport

    def sample_ode(
        self,
        *,
        sampling_method: str = "euler",
        num_steps: int = 50,
        atol: float = 1e-6,
        rtol: float = 1e-3,
        reverse: bool = False,
        do_shift: bool = True,
        time_shifting_factor: float | None = None,
        strength: float | None = None,
    ):
        if reverse:
            raise NotImplementedError("reverse sampling is unused by the pipeline")

        def sample_fn(x, model_fn, model_kwargs):
            kwargs = dict(model_kwargs)
            cond = kwargs.pop("cond", None)
            fn = functools.partial(model_fn, **kwargs)
            ts = ode_timesteps(num_steps, int(x.shape[1]), do_shift=do_shift, strength=strength,
                               time_shifting_factor=time_shifting_factor)
            if sampling_method == "dopri5":  # adaptive: integrate [ts[0], ts[-1]] directly
                return denoise_ode_adaptive(fn, x, float(ts[0]), float(ts[-1]), cond=cond, atol=atol, rtol=rtol)
            return denoise_ode(fn, x, ts, cond=cond, method=sampling_method)

        return sample_fn

    def sample_sde(
        self,
        *,
        sampling_method: str = "Euler",
        diffusion_form: str = "SBDM",
        diffusion_norm: float = 1.0,
        last_step: str | None = "Mean",
        last_step_size: float = 0.04,
        num_steps: int = 250,
    ):
        del last_step_size  # the grid's last interval is the last step, as in JAX

        def sample_fn(x, model_fn, model_kwargs, generator=None, noise=None):
            kwargs = dict(model_kwargs)
            cond = kwargs.pop("cond", None)
            # score-based diffusion forms diverge at the noise end (flux t = 1):
            # start 1e-3 inside it, as the reference's sample_eps
            eps = self.transport.sample_eps or (1e-3 if diffusion_form != "constant" else 0.0)
            ts = np.linspace(1.0 - eps, 0.0, num_steps, dtype=F32)
            return denoise_sde(self.transport, functools.partial(model_fn, **kwargs), x, ts, cond=cond,
                               diffusion_form=diffusion_form, diffusion_norm=diffusion_norm,
                               last_step=last_step, method=sampling_method, generator=generator, noise=noise)

        return sample_fn
