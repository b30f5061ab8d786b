"""The port's ODE solvers against the JAX package's.

The same fixed fp32 velocity field, written once in each framework, drives
`denoise_ode` (euler, heun, ab2, cached:K) and `denoise_ode_adaptive`
(dopri5) of both packages from the same numpy-seeded start, conditioning and
grid. Bounds: max |Δ| <= 1e-5 on the result (fp32 throughout; the two
frameworks' matmuls sum in other orders), and the same number of model
evaluations (counted in JAX by a debug callback inside the compiled loop, so
only the branches that run count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.ops.schedule import ode_timesteps
from visualcloze_tpu.transport import sampling as jsampling
from visualcloze_tpu_torch.ops.schedule import ode_timesteps as tode_timesteps
from visualcloze_tpu_torch.transport import sampling as tsampling

B, L, D, C = 2, 16, 8, 4
rng = np.random.default_rng(0)
X0 = rng.standard_normal((B, L, D)).astype(np.float32)
COND = rng.standard_normal((B, L, C)).astype(np.float32)
W = (rng.standard_normal((D + C, D)) / np.sqrt(D + C)).astype(np.float32)
TS = ode_timesteps(10, 256, do_shift=True)


def _jax_model(counter):
    w = jnp.asarray(W)

    def model_fn(inp, timesteps, **_):
        jax.debug.callback(lambda: counter.append(1))
        t = timesteps[:, None, None].astype(jnp.float32)
        x = inp[..., :D]
        return jnp.tanh(inp @ w) * (1.0 + t) - 0.3 * x

    return model_fn


def _torch_model(counter):
    w = torch.from_numpy(W)

    def model_fn(inp, timesteps):
        counter.append(1)
        t = timesteps[:, None, None].to(torch.float32)
        inp = inp.to(torch.float32)
        x = inp[..., :D]
        return torch.tanh(inp @ w) * (1.0 + t) - 0.3 * x

    return model_fn


def _run_jax(method, **kw):
    counter = []
    x, cond = jnp.asarray(X0), jnp.asarray(COND)
    if method == "dopri5":
        out = jsampling.denoise_ode_adaptive(_jax_model(counter), x, TS[0], TS[-1], {}, cond=cond, **kw)
    else:
        out = jsampling.denoise_ode(_jax_model(counter), x, jnp.asarray(TS), {}, cond=cond, method=method)
    out = np.asarray(jax.block_until_ready(out))
    jax.effects_barrier()
    return out, len(counter)


def _run_torch(method, **kw):
    counter = []
    x, cond = torch.from_numpy(X0), torch.from_numpy(COND)
    if method == "dopri5":
        stats = {}
        out = tsampling.denoise_ode_adaptive(_torch_model(counter), x, TS[0], TS[-1], cond=cond, stats=stats, **kw)
        assert stats["evaluations"] == len(counter)
        assert stats["accepted"] + stats["rejected"] == (len(counter) - 1) // 6
    else:
        out = tsampling.denoise_ode(_torch_model(counter), x, TS, cond=cond, method=method)
    return out.numpy(), len(counter)


@pytest.mark.parametrize("method", ["euler", "heun", "ab2", "cached:2", "cached:3", "dopri5"])
def test_solver_matches_jax(method):
    want, n_jax = _run_jax(method)
    got, n_port = _run_torch(method)
    assert n_port == n_jax, (n_port, n_jax)
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pairs = len(TS) - 1
    fresh = tsampling.cached_fresh_schedule(pairs, 3)
    expected = {"euler": pairs, "heun": 2 * pairs, "ab2": pairs + 1, "cached:3": 1 + int(fresh[1:].sum())}
    if method in expected:
        assert n_port == expected[method]
    if method == "cached:3":  # steps 0, 1, 4, 7 and the last of 9
        assert fresh.tolist() == [True, True, False, False, True, False, False, True, True]


def test_dopri5_step_cap_gives_nan_in_both():
    want, n_jax = _run_jax("dopri5", max_steps=2)
    got, n_port = _run_torch("dopri5", max_steps=2)
    assert n_port == n_jax == 1 + 6 * 2
    assert np.isnan(want).all() and np.isnan(got).all()


@pytest.mark.parametrize("method", ["euler", "heun", "ab2", "cached:2", "cached:3"])
def test_solver_on_bf16_latents_matches_jax_bit_for_bit(method):
    """On bf16 latents (the pipeline's) with a velocity field that computes
    in fp32 in both frameworks, the fixed-grid solvers round and carry
    exactly as JAX's: the same bf16 result, element for element."""
    w = jnp.asarray(W)

    def jax_model(inp, timesteps, **_):
        t = timesteps[:, None, None].astype(jnp.float32)
        inp = inp.astype(jnp.float32)
        return jnp.tanh(inp @ w) * (1.0 + t) - 0.3 * inp[..., :D]

    x = jnp.asarray(X0, jnp.bfloat16)
    want = jsampling.denoise_ode(jax_model, x, jnp.asarray(TS), {}, cond=jnp.asarray(COND), method=method)
    got = tsampling.denoise_ode(_torch_model([]), torch.from_numpy(X0).to(torch.bfloat16), TS,
                                cond=torch.from_numpy(COND), method=method)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_solver_in_the_latent_dtype():
    """heun carries x in its own dtype (bf16 here), ab2 integrates in fp32 and
    returns x's dtype, as in JAX."""
    x = torch.from_numpy(X0).to(torch.bfloat16)
    for method in ("heun", "ab2", "cached:2"):
        out = tsampling.denoise_ode(_torch_model([]), x, TS, cond=torch.from_numpy(COND), method=method)
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    with pytest.raises(NotImplementedError):
        tsampling.denoise_ode(_torch_model([]), x, TS, method="rk4")


@pytest.mark.parametrize("name", ["euler", "heun", "ab2", "dopri5", "cached", "cached:1", "cached:12",
                                  "cached:0", "cached:", "cached:01", "rk4", "Euler", "heun2", ""])
def test_solver_arg_accepts_what_jax_accepts(name):
    try:
        jsampling.solver_arg(name)
        jax_ok = True
    except ValueError:
        jax_ok = False
    if jax_ok:
        assert tsampling.solver_arg(name) == name
    else:
        with pytest.raises(ValueError, match="unknown solver"):
            tsampling.solver_arg(name)


def _per_step_loop(method, x, ts, cond):
    """euler and heun as they were written before the step sizes were uploaded
    once a loop: each step's size made from its own fp32 difference, rounded
    to x's dtype."""
    velocity = tsampling._velocity_fn(_torch_model([]), x, cond)
    for t_cur, t_next in zip(ts[:-1], ts[1:]):
        dt = torch.tensor(float(np.float32(t_next - t_cur)), dtype=torch.float32).to(x.dtype)
        if method == "euler":
            x = x + dt * velocity(x, t_cur).to(x.dtype)
        else:
            v1 = velocity(x, t_cur).to(x.dtype)
            v2 = velocity(x + dt * v1, t_next).to(x.dtype)
            x = x + dt * 0.5 * (v1 + v2)
    return x


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_uploaded_step_sizes_give_the_per_step_bits(method):
    """The step sizes uploaded once a loop give the bf16 state, bit for bit,
    that a step size made at each step gives."""
    x, cond = torch.from_numpy(X0).to(torch.bfloat16), torch.from_numpy(COND)
    got = tsampling.denoise_ode(_torch_model([]), x, TS, cond=cond, method=method)
    want = _per_step_loop(method, x, np.asarray(TS, np.float32), cond)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("points", [2, 30])
@pytest.mark.parametrize("method", ["euler", "heun", "ab2", "cached:3"])
def test_step_sizes_are_uploaded_once_a_loop(method, points):
    """euler and heun upload their step sizes once a loop, whatever its
    length; ab2 and cached keep theirs on the host and upload none."""
    ts = tode_timesteps(points, 256, do_shift=True)
    x = torch.from_numpy(X0).to(torch.bfloat16)
    before = tsampling.denoise_ode.step_size_uploads
    tsampling.denoise_ode(_torch_model([]), x, ts, cond=torch.from_numpy(COND), method=method)
    assert tsampling.denoise_ode.step_size_uploads - before == (1 if method in ("euler", "heun") else 0)
