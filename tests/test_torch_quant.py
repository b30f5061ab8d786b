"""The port's weight-only quantization (models/quant.py, layers.Int8Linear and
kernel G's plain version) against the JAX package's, on the CPU.

Bounds, and the reading behind each one that is not exact:
- G's plain version vs the Pallas int8_matmul in interpret mode, fp32 out,
  (200 ragged, 128, 256): 1e-5 of the largest output. Both sum exact
  bf16 x int8 products in fp32; only the order of the sum differs.
- N = 64 (final_layer.linear), which the Pallas kernel refuses, vs the einsum
  with dequantize_linear: 1e-5 of the largest output.
- Int8Linear vs JAX linear's int8 branch: one bf16 ulp of each output without
  a bias (JAX rounds the dot to bf16 before the fp32 rescale, G rounds once,
  after it); with a bias, one ulp of the product plus the bf16 add's own
  rounding (a near-cancelling sum can be far smaller than the product).
- Quantizers, embeddings and the quantized T5 / CLIP / DiT trees: exact.
- T5 with int4 linears and CLIP with int8 linears over fp32 token tables:
  1e-5, as the dense encoders. With their int8 tables the encoders run in bf16
  end to end (embedding_lookup returns bf16, as in JAX), see _BF16_TEXT.
- The tiny int8 DiT and the tiny quantized pipeline: see _DIT_INT8 and
  test_quantized_pipeline_matches_jax.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.config import CLIPTextConfig, FluxConfig, T5Config
from visualcloze_tpu.models import quant as jq
from visualcloze_tpu.models.clip import clip_encode as jax_clip_encode
from visualcloze_tpu.models.clip import init_clip
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.models.layers import linear as jax_linear
from visualcloze_tpu.models.t5 import init_t5
from visualcloze_tpu.models.t5 import t5_encode as jax_t5_encode
from visualcloze_tpu.ops import int8_matmul as jim
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.models import quant as tq
from visualcloze_tpu_torch.models.conditioner import FallbackTokenizer
from visualcloze_tpu_torch.models.flux import build_flux
from visualcloze_tpu_torch.models.layers import Int8Linear
from visualcloze_tpu_torch.ops.int8_matmul import int8_matmul

F32, BF16 = jnp.float32, jnp.bfloat16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits), elementwise."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def _pallas_int8_matmul(*args, **kw):
    """The JAX kernel in interpret mode, as tests/test_quant.py runs it."""
    orig = jim.pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        k.pop("compiler_params", None)
        return orig(*a, **k)

    with mock.patch.object(jim.pl, "pallas_call", interp):
        return jim.int8_matmul(*args, **kw)


def test_int8_matmul_plain_matches_the_pallas_kernel():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 100, 128)).astype(np.float32)  # M = 200: ragged on purpose
    w8 = rng.integers(-128, 128, (128, 256)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, (256,)).astype(np.float32)
    want = np.asarray(_pallas_int8_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(scale), out_dtype=F32))
    got = int8_matmul(_t(x), _t(w8), _t(scale), out_dtype=torch.float32).numpy()
    assert got.shape == (2, 100, 256)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    got16 = int8_matmul(_t(x), _t(w8), _t(scale))  # the default output: one rounding of the fp32 result
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, torch.from_numpy(got).to(torch.bfloat16))


def test_int8_matmul_takes_n64_which_the_pallas_kernel_refuses():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((37, 256)).astype(np.float32)
    w8 = rng.integers(-128, 128, (256, 64)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, (64,)).astype(np.float32)
    with pytest.raises(ValueError, match="multiples of 128"):
        _pallas_int8_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(scale))
    w = jq.dequantize_linear({"w_int8": jnp.asarray(w8), "w_scale": jnp.asarray(scale)})["w"]
    want = np.asarray(jnp.einsum("mk,kn->mn", jnp.asarray(x).astype(BF16).astype(F32), w))
    got = int8_matmul(_t(x), _t(w8), _t(scale), out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear_matches_the_jax_int8_branch(bias):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 96)).astype(np.float32)
    p = {"w": jnp.asarray(rng.standard_normal((96, 160)) * 0.05, F32)}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal((160,)) * 0.1, F32)
    q = jq.quantize_linear_int8(p)
    want = np.asarray(jax_linear(q, jnp.asarray(x)), np.float32)
    m = Int8Linear(96, 160, bias=bias).requires_grad_(False)
    for key, val in q.items():
        getattr(m, "bias" if key == "b" else key).copy_(_t(val))
    got = m(_t(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 160)
    got = got.float().numpy()
    xb = np.asarray(jnp.asarray(x).astype(BF16).astype(F32), np.float64)
    prod = xb @ (np.asarray(q["w_int8"], np.float64) * np.asarray(q["w_scale"], np.float64))
    tol = _bf16_ulp(prod) + (_bf16_ulp(want) if bias else 0.0)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_quantizers_match_jax_bit_for_bit():
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((3, 96, 40)) * 0.05).astype(np.float32)
    jl, tl = jq.quantize_linear_int8({"w": jnp.asarray(w)}), tq.quantize_linear_int8({"w": _t(w)})
    for key in ("w_int8", "w_scale"):
        np.testing.assert_array_equal(tl[key].numpy(), np.asarray(jl[key]), err_msg=key)
    np.testing.assert_array_equal(tq.dequantize_linear(tl)["w"].numpy(), np.asarray(jq.dequantize_linear(jl)["w"]))
    for shape, group in (((2, 256, 64), 128), ((48, 24), 128), ((6, 8), 128)):  # groups 128, 16, 2
        w = rng.standard_normal(shape).astype(np.float32)
        j4, t4 = jq.quantize_weight_int4(jnp.asarray(w), group), tq.quantize_weight_int4(_t(w), group)
        assert t4["w_int4"].dtype == torch.uint8
        for key in ("w_int4", "w_scale"):
            np.testing.assert_array_equal(t4[key].numpy(), np.asarray(j4[key]), err_msg=(shape, key))
        for jd, td in ((F32, torch.float32), (BF16, torch.bfloat16)):
            np.testing.assert_array_equal(tq.dequant_weight_int4(t4, td).float().numpy(),
                                          np.asarray(jq.dequant_weight_int4(j4, jd), np.float32))
        assert tq._int4_group_for(shape[-2]) == jq._int4_group_for(shape[-2])
    emb = rng.standard_normal((50, 32)).astype(np.float32)
    je, te = jq.quantize_embedding_int8(jnp.asarray(emb)), tq.quantize_embedding_int8(_t(emb))
    for key in ("w_int8", "w_scale"):
        np.testing.assert_array_equal(te[key].numpy(), np.asarray(je[key]), err_msg=key)
    ids = rng.integers(0, 50, (2, 7))
    np.testing.assert_array_equal(tq.embedding_lookup(te, _t(ids)).float().numpy(),
                                  np.asarray(jq.embedding_lookup(je, jnp.asarray(ids)), np.float32))
    np.testing.assert_array_equal(tq.embedding_lookup(_t(emb), _t(ids)).numpy(),
                                  np.asarray(jq.embedding_lookup(jnp.asarray(emb), jnp.asarray(ids))))


def _assert_same_state(got: torch.nn.Module, want: torch.nn.Module) -> None:
    gs, ws = got.state_dict(), want.state_dict()
    assert set(gs) == set(ws), set(gs) ^ set(ws)
    for key, val in ws.items():
        assert gs[key].dtype == val.dtype, (key, gs[key].dtype, val.dtype)
        assert torch.equal(gs[key], val), key


T5_CFG, CLIP_CFG = T5Config().tiny(), CLIPTextConfig().tiny()


@pytest.mark.parametrize("which", ["flux", "t5", "t5_int8_embed", "clip"])
def test_module_quantizers_give_the_jax_trees(which):
    """quantize_flux_int8 / quantize_t5_int4 / quantize_clip_int8 of a port
    module carried over from a dense JAX tree == the JAX quantizer's tree
    carried over: every code, scale and remaining leaf, exactly."""
    if which == "flux":
        cfg = FluxConfig().tiny()
        params = init_flux(jax.random.PRNGKey(1), cfg)
        want = convert.flux_from_jax(_np(jq.quantize_flux_int8(params)), cfg, device="cpu")
        got = tq.quantize_flux_int8(convert.flux_from_jax(_np(params), cfg, device="cpu"))
        assert isinstance(got.single_blocks[0].linear1, Int8Linear)
    elif which == "clip":
        params = init_clip(jax.random.PRNGKey(4), CLIP_CFG)
        want = convert.clip_from_jax(_np(jq.quantize_clip_int8(params)), CLIP_CFG, device="cpu")
        got = tq.quantize_clip_int8(convert.clip_from_jax(_np(params), CLIP_CFG, device="cpu"))
    else:
        embed = which == "t5_int8_embed"
        params = init_t5(jax.random.PRNGKey(3), T5_CFG)
        want = convert.t5_from_jax(_np(jq.quantize_t5_int4(params, quantize_embed=embed)), T5_CFG, device="cpu")
        got = tq.quantize_t5_int4(convert.t5_from_jax(_np(params), T5_CFG, device="cpu"), quantize_embed=embed)
        assert isinstance(got.embed, tq.Int8Embedding) == embed
    _assert_same_state(got, want)


PROMPTS = ["A grid layout with 2 rows and 2 columns", "every row maps a photo to its edges"]
# The encoders with int8 token tables run in bf16 end to end, as in JAX, and
# bf16 elementwise ops round differently in the two frameworks (see _DIT_INT8).
# Reading, max |Δ| over max |want|: T5 0.031 / 3.66 (0.85%, 75% of the
# elements differ), CLIP hidden 0.023 / 2.97 (0.79%), pooled 0.016 / 1.99
# (0.78%); about two bf16 ulps at the largest output. Bound: 2% of max |want|.
_BF16_TEXT = 2e-2


def _ids(vocab):
    return FallbackTokenizer(vocab)(PROMPTS, 16)


def test_t5_int4_matches_jax():
    params = init_t5(jax.random.PRNGKey(3), T5_CFG)
    ids = _ids(T5_CFG.vocab_size)
    for embed in (False, True):
        jp = jq.quantize_t5_int4(params, quantize_embed=embed)
        want = np.asarray(jax_t5_encode(T5_CFG, jp, jnp.asarray(ids)), np.float32)
        got = convert.t5_from_jax(_np(jp), T5_CFG, device="cpu")(_t(ids).long()).float().numpy()
        if embed:
            assert np.abs(got - want).max() <= _BF16_TEXT * np.abs(want).max()
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)


def test_clip_int8_matches_jax():
    params = init_clip(jax.random.PRNGKey(4), CLIP_CFG)
    ids = _ids(CLIP_CFG.vocab_size)
    full = jq.quantize_clip_int8(params)
    for jp in (dict(full, token_embed=params["token_embed"]), full):  # fp32 table, then the int8 one
        want_h, want_p = (np.asarray(a, np.float32) for a in jax_clip_encode(CLIP_CFG, jp, jnp.asarray(ids)))
        got_h, got_p = convert.clip_from_jax(_np(jp), CLIP_CFG, device="cpu")(_t(ids).long())
        for got, want in ((got_h, want_h), (got_p, want_p)):
            if jp is full:
                assert np.abs(got.float().numpy() - want).max() <= _BF16_TEXT * np.abs(want).max()
            else:
                np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# The tiny int8 DiT (quantize_flux_int8 of fp32 init_flux params; JAX through
# attn_impl="xla") vs the port (G's plain version, the plain attention): every
# int8 linear returns bf16, so the activations are bf16 from the embedders on,
# and JAX and PyTorch round bf16 gelu(tanh) and silu differently in ~40% of
# the elements (measured on 1e5 N(0, 9) values). Reading, max and mean |Δ| over
# the output RMS: 0.0251 and 0.0063 (no padding), 0.0291 and 0.0062 (padded).
# With G's arithmetic replaced by JAX's order (the dot rounded to bf16 before
# the rescale) the reading is the same (0.0314 / 0.0063 and 0.0258 / 0.0057),
# so G's one rounding fewer is not what sets it. Bounds: twice the reading.
_DIT_INT8 = {"max": 6e-2, "mean": 1.3e-2}


@pytest.mark.parametrize("padded", [False, True])
def test_dit_int8_matches_jax(padded):
    from test_torch_models import _flux_inputs

    cfg = FluxConfig().tiny()
    qparams = jq.quantize_flux_int8(init_flux(jax.random.PRNGKey(1), cfg))
    inp = _flux_inputs(cfg, 2, 64, 16, 0, padded)
    want = np.asarray(jax_flux_apply(cfg, qparams, **{k: jnp.asarray(v) for k, v in inp.items()},
                                     rope_layout="half", attn_impl="xla"), np.float32)
    model = convert.flux_from_jax(_np(qparams), cfg, device="cpu")
    assert all(isinstance(m, Int8Linear) for m in (model.img_in, model.final_layer.linear,
                                                   model.double_blocks[0].img_mod.lin))
    got = model(**{k: _t(v) for k, v in inp.items()}).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want ** 2)))
    diff = np.abs(got - want)
    assert diff.max() <= _DIT_INT8["max"] * rms, diff.max() / rms
    assert diff.mean() <= _DIT_INT8["mean"] * rms, diff.mean() / rms


def test_init_int8_models_have_the_jax_trees_structure():
    """init_flux_int8 / init_t5_int4 / init_clip_int8: the JAX init's tree
    carried over has the same leaves, shapes and dtypes; scales, biases and
    norms are the JAX values; the codes cover their whole range."""
    flux_cfg = FluxConfig().tiny()
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    bf = torch.bfloat16
    pairs = [
        (tq.init_flux_int8(flux_cfg, "cpu", gen),
         convert.flux_from_jax(_np(jq.init_flux_int8(key, flux_cfg)), flux_cfg, device="cpu", dtype=bf)),
        (tq.init_t5_int4(T5_CFG, "cpu", gen),
         convert.t5_from_jax(_np(jq.init_t5_int4(key, T5_CFG)), T5_CFG, device="cpu", dtype=bf)),
        (tq.init_clip_int8(CLIP_CFG, "cpu", gen),
         convert.clip_from_jax(_np(jq.init_clip_int8(key, CLIP_CFG)), CLIP_CFG, device="cpu", dtype=bf)),
    ]
    for got, want in pairs:
        gs, ws = got.state_dict(), want.state_dict()
        assert set(gs) == set(ws), set(gs) ^ set(ws)
        for name, val in ws.items():
            assert (gs[name].shape, gs[name].dtype) == (val.shape, val.dtype), name
            if name.endswith(("w_int8", "w_int4")):
                lo, hi = (-128, 127) if val.dtype == torch.int8 else (0, 255)
                assert int(gs[name].min()) >= lo and int(gs[name].max()) <= hi, name
            elif not name.endswith(("embed", "relative_attention_bias")):  # drawn N(0, std) in both
                assert torch.equal(gs[name], val), name
    big = pairs[0][0].single_blocks[0].linear1.w_int8
    assert (int(big.min()), int(big.max())) == (-128, 127)


def test_materialize_keeps_int8_codes_and_fp32_scales():
    cfg = FluxConfig().tiny()
    flux = build_flux(cfg, torch.device("cpu"), torch.bfloat16, int8=True)
    lin = flux.double_blocks[0].img_attn.qkv
    assert (lin.w_int8.dtype, lin.w_scale.dtype, lin.bias.dtype) == (torch.int8, torch.float32, torch.bfloat16)
    assert lin.w_int8.shape == (cfg.hidden_size, 3 * cfg.hidden_size)
    assert flux.double_blocks[0].img_attn.norm.q_scale.dtype == torch.bfloat16
    assert sum(isinstance(m, Int8Linear) for m in flux.modules()) == 8 + 10 * cfg.depth + 3 * cfg.depth_single_blocks + 2


def test_convert_refuses_what_it_cannot_carry():
    cfg = FluxConfig().tiny()
    params = init_flux(jax.random.PRNGKey(1), cfg)
    q = _np(jq.quantize_flux_int8(params))
    del q["final_layer"]["linear"]["w_scale"]
    with pytest.raises(ValueError, match="not in the JAX tree"):
        convert.flux_from_jax(q, cfg, device="cpu")
    mixed = _np(jq.quantize_flux_w8a8(params))  # w8a8 entries beside a dense one
    mixed["final_layer"]["linear"] = _np(params["final_layer"]["linear"])
    with pytest.raises(ValueError, match="together"):
        convert.flux_from_jax(mixed, cfg, device="cpu")
    q4 = _np(jq.quantize_flux_int4(params))  # the int4 DiT carries across, its codes exactly
    assert torch.equal(convert.flux_from_jax(q4, cfg, device="cpu").img_in.w_int4, _t(q4["img_in"]["w_int4"]))
    q4["final_layer"] = _np(jq.quantize_flux_int8(params))["final_layer"]  # int4 beside int8
    with pytest.raises(ValueError, match="together"):
        convert.flux_from_jax(q4, cfg, device="cpu")
    q = _np(jq.quantize_flux_int8(params))
    q["img_in"]["w_int8"] = q["img_in"]["w_int8"].astype(np.int16)
    with pytest.raises(ValueError, match="codes"):
        convert.flux_from_jax(q, cfg, device="cpu")


def test_quantized_pipeline_matches_jax():
    """synthetic_full_components(tiny=True) in JAX (int8 DiT, int4 T5 with an
    int8 table, int8 CLIP, bf16 VAE), its parameters carried across, the JAX
    noise replayed; 2x2 grid at 64, 4 steps.

    Reading (seed 7): the packed image tokens agree exactly; the bf16 text
    features differ by one ulp in 60% of the elements (bf16 elementwise
    roundings, see _DIT_INT8) and the bf16 VAE's conditioning tokens in 2%;
    the denoised bf16 latents in 33.5% of the elements, mean |Δ| 4.2e-5, max
    1/64. So the fraction bound of tests/test_torch_pipeline.py (2%, an fp32
    stack) cannot hold for a bf16 stack: it is 50% here (the reading, with
    room); the mean and max bounds are the fp32 pipeline's, 1e-4 and 1/64."""
    from test_torch_pipeline import PROMPTS as GRID_PROMPTS
    from test_torch_pipeline import SEED, STEPS, _grid, _jax_noise

    from visualcloze_tpu.pipeline.loader import synthetic_full_components as jax_synthetic
    from visualcloze_tpu_torch import config as tconfig
    from visualcloze_tpu_torch.models.conditioner import TextEncoder
    from visualcloze_tpu_torch.pipeline.visualcloze import VisualClozeModel

    jm = jax_synthetic(jax.random.PRNGKey(0), resolution=64, tiny=True)
    bf = torch.bfloat16
    t5 = TextEncoder("t5", convert.t5_from_jax(_np(jm.t5.params), jm.t5.cfg, device="cpu", dtype=bf),
                     FallbackTokenizer(jm.t5.cfg.vocab_size), jm.t5.max_length)
    clip = TextEncoder("clip", convert.clip_from_jax(_np(jm.clip.params), jm.clip.cfg, device="cpu", dtype=bf),
                       FallbackTokenizer(jm.clip.cfg.vocab_size), jm.clip.max_length)
    flux = convert.flux_from_jax(_np(jm.params), jm.cfg, device="cpu", dtype=bf)
    assert isinstance(flux.img_in, Int8Linear) and isinstance(t5.model.embed, tq.Int8Embedding)
    pm = VisualClozeModel(convert.config_from(jm.cfg, tconfig.FluxConfig), flux,
                          convert.vae_from_jax(_np(jm.ae.params), jm.ae.cfg, device="cpu", dtype=bf),
                          t5, clip, resolution=64, device="cpu",
                          permute_params=False)  # jm.params as the JAX constructor left them
    for m in (jm, pm):
        m.set_grid_size(2, 2)
    grid = _grid()
    noise = _jax_noise((1, 8, 16, 4), (1, 8, 8, 4))
    qj = jm.prepare_query(grid, GRID_PROMPTS, seed=SEED, steps=STEPS)
    qp = pm.prepare_query(grid, GRID_PROMPTS, seed=SEED, steps=STEPS, noise=noise)
    np.testing.assert_array_equal(qp["x"].float().numpy(), np.asarray(qj["x"], np.float32))
    sj = np.asarray(jm.denoise_query(qj), np.float32)
    got = pm.denoise_query(qp).float().numpy()
    assert np.isfinite(got).all() and got.shape == sj.shape
    diff = np.abs(got - sj)
    assert (diff > 0).mean() <= 0.5, (diff > 0).mean()
    assert diff.mean() <= 1e-4, diff.mean()
    assert diff.max() <= 1 / 64, diff.max()
