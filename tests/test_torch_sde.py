"""The port's SDE and likelihood samplers (transport/sampling.py's
denoise_sde, sample_ode_likelihood and Sampler) and the path / transport
conversions they need, against the JAX package's, on the CPU.

JAX's noise and Rademacher probes are replayed into the port. Bounds:
- the path helpers: fp32, rtol 1e-6 (elementwise formulas; torch's and
  XLA's exp, cos and tan agree to an ulp at these points);
- the samplers on the tiny fp32 DiT: max |Δ| <= 1e-4 of max |x| (the DiT
  alone agrees to ~1e-6 at guidance 3.5; a score-based drift scales it by
  1 / (1 - t));
- the likelihood: logp to rtol 1e-4. JAX takes the divergence by jvp, the
  port by vjp; eps . (J eps) and (eps J) . eps are the same number, summed
  in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.transport import path as jpath
from visualcloze_tpu.transport import sampling as jsamp
from visualcloze_tpu.transport.transport import create_transport as jax_create_transport
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.transport import Sampler, create_transport, denoise_sde, sample_ode_likelihood
from visualcloze_tpu_torch.transport import path as tpath

FORMS = ("constant", "SBDM", "sigma", "linear", "decreasing", "increasing-decreasing")
PLANS = (("ICPlan", {}), ("VPCPlan", {}), ("GVPCPlan", {}))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Tiny ops: one intra-op thread under several test workers, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("plan", [p for p, _ in PLANS])
def test_path_helpers_match_jax(plan):
    jp, tp = getattr(jpath, plan)(), getattr(tpath, plan)()
    rng = np.random.default_rng(0)
    t = np.array([0.13, 0.5, 0.87], np.float32)
    x, v, x0 = (rng.standard_normal((3, 5, 4)).astype(np.float32) for _ in range(3))
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    jx, tx, jv, tv = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(v), torch.from_numpy(v)
    _close(tp.compute_d_alpha_alpha_ratio_t(tt), jp.compute_d_alpha_alpha_ratio_t(jt))
    for a, b in zip(tp.compute_drift(tx, tt), jp.compute_drift(jx, jt)):
        _close(a, b)
    for form in FORMS:
        _close(tp.compute_diffusion(tx, tt, form, 0.7), jp.compute_diffusion(jx, jt, form, 0.7))
    for name in ("get_score_from_velocity", "get_noise_from_velocity", "get_velocity_from_score"):
        _close(getattr(tp, name)(tv, tx, tt), getattr(jp, name)(jv, jx, jt))
    for a, b in zip(tp.plan(tt, torch.from_numpy(x0), tx), jp.plan(jt, jnp.asarray(x0), jx)):
        _close(a, b)
    with pytest.raises(NotImplementedError):
        tp.compute_diffusion(tx, tt, "cubic")


@pytest.mark.parametrize("path_type,prediction", [("Linear", "velocity"), ("Linear", "score"), ("Linear", "noise"),
                                                  ("VP", "velocity"), ("GVP", "score")])
def test_transport_conversions_match_jax(path_type, prediction):
    jt_, tt_ = jax_create_transport(path_type, prediction), create_transport(path_type, prediction)
    rng = np.random.default_rng(1)
    t = np.array([0.2, 0.6], np.float32)
    out, x = (rng.standard_normal((2, 6, 3)).astype(np.float32) for _ in range(2))
    args_t = (torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(t))
    args_j = (jnp.asarray(out), jnp.asarray(x), jnp.asarray(t))
    _close(tt_.velocity_from_model(*args_t), jt_.velocity_from_model(*args_j), rtol=1e-5)
    _close(tt_.score_from_velocity(*args_t), jt_.score_from_velocity(*args_j), rtol=1e-5)


# ----------------------------- the samplers on the tiny DiT -----------------------------

CFG = FluxConfig().tiny()
L_IMG, L_TXT = 16, 8


@pytest.fixture(scope="module")
def dit():
    """The tiny fp32 DiT in both packages and its fixed inputs: (JAX
    model_fn, port model_fn, the port's under autograd, x, cond): x the
    output channels, cond the rest of the input's, as the Fill model takes
    them."""
    params = init_flux(jax.random.PRNGKey(4), CFG)
    model = convert.flux_from_jax(jax.tree.map(np.asarray, params), CFG, device="cpu")
    rng = np.random.default_rng(2)
    ids = np.zeros((1, L_IMG, 3), np.float32)
    ids[..., 1], ids[..., 2] = np.arange(L_IMG) // 4, np.arange(L_IMG) % 4
    kw = dict(img_ids=ids, txt=rng.standard_normal((1, L_TXT, CFG.context_in_dim)).astype(np.float32),
              txt_ids=np.zeros((1, L_TXT, 3), np.float32),
              y=rng.standard_normal((1, CFG.vec_in_dim)).astype(np.float32), guidance=np.full((1,), 3.5, np.float32))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jfn = jax.jit(lambda img, timesteps: jax_flux_apply(CFG, params, img=img, timesteps=timesteps, **jkw,
                                                       rope_layout="half", attn_impl="xla"))
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}

    @torch.no_grad()
    def tfn(img, timesteps):
        return model(img=img, timesteps=timesteps, **tkw)

    def tfn_grad(img, timesteps):  # under autograd, for the likelihood
        return model(img=img, timesteps=timesteps, **tkw)

    out_ch = CFG.out_channels
    x = rng.standard_normal((1, L_IMG, out_ch)).astype(np.float32)
    cond = rng.standard_normal((1, L_IMG, CFG.in_channels - out_ch)).astype(np.float32)
    return jfn, tfn, tfn_grad, x, cond


def _jax_noise(key, n, shape):
    keys = jax.random.split(key, n)
    return keys, [torch.from_numpy(np.asarray(jax.random.normal(k, shape, jnp.float32))) for k in keys]


def _sde_case(dit, method, form, last_step, ts):
    jfn, tfn, _, x, cond = dit
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsamp.denoise_sde(jax_create_transport(), jfn, key, jnp.asarray(x), jnp.asarray(ts), {},
                                        cond=jnp.asarray(cond), diffusion_form=form, last_step=last_step,
                                        method=method))
    _, noise = _jax_noise(key, len(ts) - 1, x.shape)
    got = denoise_sde(create_transport(), tfn, torch.from_numpy(x), ts, cond=torch.from_numpy(cond),
                      diffusion_form=form, last_step=last_step, method=method,
                      noise=noise if last_step is None else noise[:-1]).numpy()
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


TS = np.linspace(0.9, 0.1, 4, dtype=np.float32)


@pytest.mark.parametrize("method", ["Euler", "Heun"])
@pytest.mark.parametrize("form", FORMS)
def test_denoise_sde_diffusion_forms_match_jax(dit, method, form):
    _sde_case(dit, method, form, "Mean", TS)


@pytest.mark.parametrize("method", ["Euler", "Heun"])
@pytest.mark.parametrize("last_step", ["Euler", "Tweedie", None])
def test_denoise_sde_last_steps_match_jax(dit, method, last_step):
    _sde_case(dit, method, "SBDM", last_step, TS)


def test_denoise_sde_draws_from_a_generator_deterministically(dit):
    _, tfn, _, x, cond = dit
    runs = [denoise_sde(create_transport(), tfn, torch.from_numpy(x), TS, cond=torch.from_numpy(cond),
                        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and torch.isfinite(runs[0]).all()
    with pytest.raises(ValueError, match="draws"):
        denoise_sde(create_transport(), tfn, torch.from_numpy(x), TS, cond=torch.from_numpy(cond),
                    noise=[torch.zeros(x.shape)])
    with pytest.raises(NotImplementedError):
        denoise_sde(create_transport(), tfn, torch.from_numpy(x), TS, method="Milstein")


def test_sampler_closures_match_jax(dit):
    """sample_ode (euler, heun) and sample_sde (default SBDM from 1 - 1e-3,
    the deterministic Mean step last) through the reference's call pattern;
    model_kwargs reach the model, "cond" is concatenated on channels."""
    jfn, tfn, _, xa, cond = dit
    jsampler, tsampler = jsamp.Sampler(jax_create_transport()), Sampler(create_transport())

    def jmodel(img, timesteps, scale):
        return jfn(img, timesteps) * scale

    def tmodel(img, timesteps, scale):
        return tfn(img, timesteps) * scale

    for method in ("euler", "heun"):
        want = jsampler.sample_ode(sampling_method=method, num_steps=5)(jnp.asarray(xa), jmodel,
                                                                      {"cond": jnp.asarray(cond), "scale": 0.5})
        got = tsampler.sample_ode(sampling_method=method, num_steps=5)(torch.from_numpy(xa), tmodel,
                                                                       {"cond": torch.from_numpy(cond), "scale": 0.5})
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4 * np.abs(np.asarray(want)).max()
    key = jax.random.PRNGKey(9)
    want = jsampler.sample_sde(num_steps=5)(jnp.asarray(xa), jmodel, {"cond": jnp.asarray(cond), "scale": 0.5}, key)
    _, noise = _jax_noise(key, 4, xa.shape)
    got = tsampler.sample_sde(num_steps=5)(torch.from_numpy(xa), tmodel, {"cond": torch.from_numpy(cond), "scale": 0.5},
                                           noise=noise[:-1])
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4 * np.abs(np.asarray(want)).max()


def test_likelihood_linear_field_is_analytic():
    """v(x) = a x: the Hutchinson divergence is exact, so logp = prior(x_T) +
    a N (JAX's own test of its sampler, tests/test_aux.py)."""
    a, n_steps = 0.3, 11
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 4)).astype(np.float32))
    logp, x_t = sample_ode_likelihood(lambda img, timesteps: a * img, x0, n_steps,
                                      generator=torch.Generator().manual_seed(1))
    n = 12
    prior = -0.5 * n * np.log(2 * np.pi) - 0.5 * np.sum(x_t.numpy() ** 2, axis=(1, 2))
    np.testing.assert_allclose(logp.numpy(), prior + a * n, rtol=1e-4)


def test_likelihood_on_the_tiny_dit_matches_jax(dit):
    """The same Rademacher probes in both: JAX's jvp and the port's vjp give
    the same logp and terminal state."""
    jfn, _, tfn_grad, x, cond = dit
    key = jax.random.PRNGKey(11)
    n_steps = 4
    want_logp, want_x = jsamp.sample_ode_likelihood(jfn, key, jnp.asarray(x), n_steps, {}, cond=jnp.asarray(cond))
    keys = jax.random.split(key, n_steps - 1)
    probes = [torch.from_numpy(np.asarray(jax.random.rademacher(k, x.shape, jnp.float32))) for k in keys]
    logp, x_t = sample_ode_likelihood(tfn_grad, torch.from_numpy(x), n_steps, cond=torch.from_numpy(cond),
                                      probes=probes)
    assert np.abs(x_t.detach().numpy() - np.asarray(want_x)).max() <= 1e-4 * np.abs(np.asarray(want_x)).max()
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(want_logp), rtol=1e-4)
