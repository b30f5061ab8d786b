"""Kernel N (ops/group_norm.py) on the CPU, and the DiT's serving route
that no longer reaches kernel A.

- group_norm_stats_plain against JAX's `group_norm_affine`, and
  group_norm_apply_plain (act none and swish) against JAX's `group_norm`
  and `swish(group_norm(...))`, on NHWC inputs made with numpy: two VAE-like
  shapes and a tiny-config C < 32 (groups = min(32, C)), in fp32 and bf16.
  Bounds: fp32 max |Δ| <= 1e-6 of the largest |want| (the same fp32 chain,
  sums in another order); bf16 inputs: a and bb 1e-6 of their largest
  (fp32 statistics of the same bf16 values) and the bf16 outputs one bf16
  ulp at the largest (JAX may round sigmoid(h) * h once where PyTorch
  rounds twice).
- The wrappers on CPU tensors run their plain versions bit for bit and
  count no launch; the tiny VAE calls N's statistics once per GroupNorm
  and the apply once per attention block and norm_out (chip_smoke's
  group_norm_calls, which the card's launch checks use).
- The half layout without a gradient (serving's route) with kernel A's
  entry patched to raise: the tiny double and single blocks and the tiny
  DiT complete through kernel L's rotation and match JAX within
  tests/test_torch_rope_fusion.py's and test_torch_models.py's bounds
  (1e-4 of the output RMS).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from visualcloze_tpu.config import AutoEncoderConfig as JaxAutoEncoderConfig
from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models import autoencoder as jae
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu_torch import convert, ops
from visualcloze_tpu_torch.config import AutoEncoderConfig
from visualcloze_tpu_torch.models import autoencoder as tae
from visualcloze_tpu_torch.ops import attention as tatt
from visualcloze_tpu_torch.ops.group_norm import (group_norm_apply, group_norm_apply_plain, group_norm_stats,
                                                  group_norm_stats_plain)

F32, BF16 = torch.float32, torch.bfloat16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}
SHAPES = [(2, 16, 24, 64), (1, 8, 8, 512), (1, 6, 10, 16)]  # the last: the tiny configs' C < 32


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Tiny ops: one intra-op thread under several test workers, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(shape, seed):
    """x with per-channel offsets (the group mean matters), scale and bias."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape) * rng.uniform(0.5, 3.0, c) + rng.uniform(-2.0, 2.0, c)
    scale = 1.0 + 0.2 * rng.standard_normal(c)
    bias = 0.3 * rng.standard_normal(c)
    return [a.astype(np.float32) for a in (x, scale, bias)]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_rel(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _assert_ulp(got, want, what):
    """One bf16 ulp at the largest |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 2.0 ** (math.floor(math.log2(float(np.abs(want).max()))) - 7)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_jax(shape, dtype):
    x, scale, bias = _inputs(shape, sum(shape))
    jd = JAX_DTYPE[dtype]
    p = {"scale": jnp.asarray(scale).astype(jd), "bias": jnp.asarray(bias).astype(jd)}
    jx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(x).to(dtype)
    tscale, tbias = torch.from_numpy(scale).to(dtype), torch.from_numpy(bias).to(dtype)
    groups = min(32, shape[-1])
    a, bb = group_norm_stats_plain(tx, tscale, tbias, groups)
    wa, wbb = jae.group_norm_affine(p, jx)
    assert a.dtype == bb.dtype == F32
    _assert_rel(a, wa, 1e-6, "a")
    _assert_rel(bb, wbb, 1e-6, "bb")
    close = (lambda g, w, what: _assert_rel(g, w, 1e-6, what)) if dtype == F32 else _assert_ulp
    y = group_norm_apply_plain(tx, a, bb)
    assert y.dtype == dtype
    close(y, jae.group_norm(p, jx), "apply")
    close(group_norm_apply_plain(tx, a, bb, "swish"), jae.swish(jae.group_norm(p, jx)), "apply + swish")


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_wrappers_on_cpu_tensors_run_the_plain_versions_and_count_no_launch(dtype):
    x, scale, bias = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 5, 7, 64), 3))
    ops.reset_kernel_launches()
    a, bb = group_norm_stats(x, scale, bias, 32)
    pa, pbb = group_norm_stats_plain(x, scale, bias, 32)
    assert torch.equal(a, pa) and torch.equal(bb, pbb)
    for act in ("none", "swish"):
        assert torch.equal(group_norm_apply(x, a, bb, act), group_norm_apply_plain(x, a, bb, act))
    with pytest.raises(ValueError, match="unknown act"):
        group_norm_apply(x, a, bb, "gelu")
    assert ops.kernel_launches()["group_norm_stats"] == 0
    assert ops.kernel_launches()["group_norm_apply"] == 0


def test_the_tiny_vae_calls_n_once_per_group_norm(monkeypatch):
    """Encoder and decoder of the tiny VAE: N's statistics once per
    GroupNorm (two a resnet block, the attention block's, norm_out's), its
    apply at the attention block and norm_out (with swish there), as
    chip_smoke.group_norm_calls counts them; and the same numbers as JAX's
    encode_moments / decode on the same weights (1e-4, test_vae_tiny_matches_jax's
    bound)."""
    cfg = AutoEncoderConfig().tiny()
    seen = {"stats": 0, "none": 0, "swish": 0}

    def stats(*args, **kwargs):
        seen["stats"] += 1
        return group_norm_stats(*args, **kwargs)

    def apply(x, a, bb, act="none"):
        seen[act] += 1
        return group_norm_apply(x, a, bb, act)

    monkeypatch.setattr(tae, "group_norm_stats", stats)
    monkeypatch.setattr(tae, "group_norm_apply", apply)
    jcfg = JaxAutoEncoderConfig().tiny()
    jmodel = jae.AutoEncoder(jcfg, jae.init_autoencoder(jax.random.PRNGKey(5), jcfg))
    model = convert.vae_from_jax(jax.tree.map(np.asarray, jmodel.params), cfg, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    got = model.encode_moments(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.encode_moments(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    calls = chip_smoke.group_norm_calls(cfg)
    assert seen == {"stats": calls["encode"]["stats"], "none": 1, "swish": 1}, seen
    z = rng.standard_normal((1, 4, 6, cfg.z_channels)).astype(np.float32)
    got = model.decoder(torch.from_numpy(z)).numpy()
    want = np.asarray(jae.decoder_apply(jcfg, jmodel.params["decoder"], jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert seen == {"stats": calls["encode"]["stats"] + calls["decode"]["stats"], "none": 2, "swish": 2}, seen
    assert calls["encode"]["apply"] == calls["decode"]["apply"] == 2
    full = chip_smoke.group_norm_calls(AutoEncoderConfig())
    assert full == {"encode": {"stats": 22, "apply": 2}, "decode": {"stats": 30, "apply": 2}}


@pytest.fixture
def no_kernel_a(monkeypatch):
    """Kernel A's entry (attention's flash_mha_rope) raises if reached."""

    def refuse(*args, **kwargs):
        raise AssertionError("the DiT reached kernel A's route")

    monkeypatch.setattr(tatt, "flash_mha_rope", refuse)


@pytest.mark.parametrize("kind", ["double", "single"])
def test_the_serving_route_rotates_in_l_without_kernel_a(no_kernel_a, kind):
    """The half layout with no gradient: the tiny blocks complete with
    kernel A's entry raising, and equal JAX's (1e-4 of each output's RMS)."""
    from test_torch_rope_fusion import _assert_rms_close, _block_run

    for what, got, want in _block_run(kind, "half", False):
        _assert_rms_close(got, want, what)


def test_the_tiny_dit_serves_without_kernel_a(no_kernel_a):
    """The tiny DiT's no-grad forward in the half layout (the pipeline's)
    with padding masks, kernel A's entry raising: L rotates at every block
    and the velocity equals JAX's flux_apply within 1e-4 of its RMS."""
    from test_torch_models import _flux_inputs

    cfg = FluxConfig().tiny()
    params = init_flux(jax.random.PRNGKey(1), cfg)
    inp = _flux_inputs(cfg, 2, 64, 16, 0, True)
    want = np.asarray(jax_flux_apply(cfg, params, **{k: jnp.asarray(v) for k, v in inp.items()},
                                     rope_layout="half", attn_impl="xla"))
    model = convert.flux_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(np.array(v)) for k, v in inp.items()}, rope_layout="half").numpy()
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert float(np.abs(got - want).max()) <= 1e-4 * rms


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_native_group_norm_yardstick_computes_kernel_n(shape):
    """The PyTorch call chip_smoke.py times beside N (aten's
    native_group_norm on the channels-last view of x) computes the plain
    apply of N's statistics without an act: fp32, max |Δ| <= 1e-5 of the
    largest output (its statistics sum in another order)."""
    x, scale, bias = (torch.from_numpy(a) for a in _inputs(shape, 7))
    b, h, w, c = shape
    out, _, _ = torch.ops.aten.native_group_norm(x.permute(0, 3, 1, 2), scale, bias, b, c, h * w, 32, 1e-6)
    want = group_norm_apply_plain(x, *group_norm_stats_plain(x, scale, bias, 32))
    _assert_rel(out.permute(0, 2, 3, 1), want, 1e-5, "native_group_norm")
