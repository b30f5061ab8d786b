"""The port's w8a8 and SmoothQuant w8a8 DiT (models/quant.py, layers.W8A8Linear,
kernels I and H through their plain versions) against the JAX package's, on
the CPU.

Bounds, and the reading behind each one that is not exact:
- act_quant_int8 and W8A8Linear against JAX (act_quant_int8, linear's "a8"
  branch): bit for bit, fp32 and bf16 inputs, with and without a_sinv and a
  bias, an all-zero row included.
- The w8a8 trees: the port's quantizers (quantize_flux_w8a8, mark_w8a8) give
  exactly the JAX trees carried over, W8A8Linears exactly where JAX puts "a8"
  markers.
- Calibration statistics: one block with the same inputs, 1e-6 of each
  entry's largest value; the whole tiny DiT, 2e-5 (reading 7.2e-6): the two
  frameworks' fp32 stacks already differ by ~5e-6 relative at the first
  block's inputs (matmul sum orders, the timestep embedding), and an absmax
  passes that on.
- quantize_flux_w8a8_smooth fed JAX's statistics: codes within 1 of JAX's in
  at most 0.1% of the elements (reading: 0 of 477,952 -- torch's and XLA's
  float32 pow agree here, so no rounding tie moved), a_sinv and w_scale
  within 4 float32 ulps (readings 1.9 and 1.3 ulps: pow), the rest exact.
- The tiny w8a8 and w8a8_smooth DiT against JAX: see _DIT_W8A8.
- The pipeline: see test_build_visualcloze_w8a8_smooth_matches_jax.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_checkpoints import (  # noqa: F401 (fixtures)
    JFLUX,
    _jax_timestep_embedding,
    hf_clip_state,
    hf_t5_state,
    stack_files,
    tiny_jax_loader,
)
from test_torch_models import _flux_inputs
from test_torch_pipeline import PROMPTS

from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models import layers as jlayers
from visualcloze_tpu.models import quant as jq
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.pipeline import loader as jloader
from visualcloze_tpu.pipeline.visualcloze import VisualClozeModel as JaxModel
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.models import flux as tflux
from visualcloze_tpu_torch.models import quant as tq
from visualcloze_tpu_torch.models.flux import A8_KEYS, a8_linears
from visualcloze_tpu_torch.models.layers import DoubleBlock, Int8Linear, SingleBlock, W8A8Linear
from visualcloze_tpu_torch.models.lora import tree_items
from visualcloze_tpu_torch.pipeline import loader as tloader
from visualcloze_tpu_torch.pipeline.visualcloze import VisualClozeModel

F32, BF16 = jnp.float32, jnp.bfloat16
CFG = FluxConfig().tiny()
ULP32 = 2.0 ** -23


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_like(x_np, jdtype):
    """x rounded as JAX holds it, as a tensor of the same dtype."""
    t = _t(np.asarray(jnp.asarray(x_np).astype(jdtype).astype(F32)))
    return t.to(torch.bfloat16) if jdtype == BF16 else t


@pytest.fixture(scope="module")
def params():
    return init_flux(jax.random.PRNGKey(1), CFG)


def _activations(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((5, 7, 96)) * 3.0).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero token: scale 1e-8 / 127, codes 0
    x[3, 4, 10] = 80.0  # an outlier channel
    return x, rng.uniform(0.2, 5.0, (96,)).astype(np.float32)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("jdtype", [F32, BF16])
def test_act_quant_int8_matches_jax_bit_for_bit(jdtype, smooth):
    x, sinv = _activations()
    xj = jnp.asarray(x).astype(jdtype)
    xs = xj.astype(F32) * sinv if smooth else xj  # the w8a8 branch's SmoothQuant divide
    want_codes, want_scale = jq.act_quant_int8(xs)
    codes, scale = tq.act_quant_int8(_torch_like(x, jdtype), _t(sinv) if smooth else None)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32 and scale.shape == (5, 7, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want_scale))
    assert not codes[1, 2].any() and scale[1, 2, 0].item() == np.float32(1e-8) / np.float32(127.0)


def _w8a8_linear(q: dict, bias: bool, smooth: bool) -> W8A8Linear:
    m = W8A8Linear(96, 160, bias=bias, smooth=smooth).requires_grad_(False)
    m.w_int8.copy_(_t(np.asarray(q["w_int8"]).T))  # K-major, as convert.py carries it
    m.w_scale.copy_(_t(q["w_scale"]))
    if bias:
        m.bias.copy_(_t(q["b"]))
    if smooth:
        m.a_sinv.copy_(_t(q["a_sinv"]))
    return m


@pytest.mark.parametrize("jdtype", [F32, BF16])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_w8a8_linear_matches_the_jax_a8_branch_bit_for_bit(bias, smooth, jdtype):
    """W8A8Linear (kernels I and H through their plain versions) == JAX
    linear's "a8" branch in bf16 out: fp32 inputs are quantized as they
    arrive (the double blocks' qkv and mlp.0), bf16 ones as bf16."""
    x, sinv = _activations(1)
    rng = np.random.default_rng(2)
    p = {"w": jnp.asarray(rng.standard_normal((96, 160)) * 0.05, F32)}
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal((160,)) * 0.1, F32)
    q = dict(jq.quantize_linear_int8(p), a8=jnp.zeros((), jnp.int8))
    if smooth:
        q["a_sinv"] = jnp.asarray(sinv)
    want = np.asarray(jlayers.linear(q, jnp.asarray(x).astype(jdtype)).astype(F32))
    got = _w8a8_linear(q, bias, smooth)(_torch_like(x, jdtype))
    assert got.dtype == torch.bfloat16 and got.shape == (5, 7, 160)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_w8a8_linear_lora_delta_sees_bf16_x():
    """With a LoRA the delta is added in bf16 after the bias, on bf16(x), as
    JAX; bf16 matmuls round in each framework's own order, so the bound is
    two bf16 ulps of the output (reading: 1)."""
    x, _ = _activations(3)
    rng = np.random.default_rng(4)
    p = {"w": jnp.asarray(rng.standard_normal((96, 160)) * 0.05, F32),
         "b": jnp.asarray(rng.standard_normal((160,)) * 0.1, F32)}
    q = dict(jq.quantize_linear_int8(p), a8=jnp.zeros((), jnp.int8))
    lora = {"a": rng.standard_normal((96, 4)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((4, 160)).astype(np.float32) * 0.1,
            "b_bias": rng.standard_normal((160,)).astype(np.float32) * 0.1}
    want = np.asarray(jlayers.linear(q, jnp.asarray(x), {k: jnp.asarray(v) for k, v in lora.items()}, 0.5)
                      .astype(F32))
    got = _w8a8_linear(q, True, False)(_t(x), {k: _t(v) for k, v in lora.items()}, 0.5).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= 2 * ulp).all()


def _a8_paths(tree, path=()):
    """Dotted module paths of the JAX tree's "a8"-marked entries, unstacked."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            if "a8" in v:
                depth = np.shape(v["a8"])[0]
                out += [".".join((path[0], str(i), *path[1:], k)) for i in range(depth)]
            else:
                out += _a8_paths(v, path + (k,))
    return out


def test_w8a8_modules_sit_where_jax_marks_and_hold_its_codes(params):
    """quantize_flux_w8a8 and mark_w8a8(quantize_flux_int8) of the dense
    port DiT == JAX's quantize_flux_w8a8 tree carried over, exactly; the
    W8A8Linears are the "a8"-marked entries of mark_w8a8, and nothing else."""
    want = convert.flux_from_jax(_np(jq.quantize_flux_w8a8(params)), CFG, device="cpu")
    dense = convert.flux_from_jax(_np(params), CFG, device="cpu")
    marked = _a8_paths(_np(jq.mark_w8a8(jq.quantize_flux_int8(params))))
    for got in (tq.quantize_flux_w8a8(dense), tq.mark_w8a8(tq.quantize_flux_int8(dense))):
        a8 = sorted(n for n, m in got.named_modules() if isinstance(m, W8A8Linear))
        assert a8 == sorted(marked) == sorted(f"{n}.{c}" if n else c for n, c in _names(got))
        assert len(a8) == 8 * CFG.depth + 2 * CFG.depth_single_blocks
        assert all(isinstance(m, (Int8Linear, W8A8Linear)) or not hasattr(m, "weight") for m in got.modules())
        gs, ws = got.state_dict(), want.state_dict()
        assert set(gs) == set(ws)
        for key, val in ws.items():
            assert gs[key].dtype == val.dtype and torch.equal(gs[key], val), key
    lin = want.single_blocks[0].linear1
    assert lin.w_int8.shape == (lin.out_features, lin.in_features) and lin.a_sinv is None


def _names(flux):
    mods = {id(m): n for n, m in flux.named_modules()}
    return [(mods[id(parent)], name) for parent, name, _ in a8_linears(flux)]


def _stats_rel_err(got, want) -> float:
    """The largest |got - want| over the largest |want| of each entry."""
    worst = 0.0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for p in path:
            node = node[p.key]
        ref = np.asarray(leaf, np.float32)
        assert node.shape == ref.shape, path
        worst = max(worst, float(np.abs(node - ref).max() / np.abs(ref).max()))
    return worst


@pytest.mark.parametrize("padded", [False, True])
def test_collect_a8_stats_matches_jax(params, padded):
    """Flux(collect_a8_stats=True) == flux_apply(collect_a8_stats=True): the
    same tree once stacked (lora_to_jax), the absmax of the same six inputs,
    padding tokens included, within 2e-5 (see the module docstring); and
    calibrate_flux_a8's elementwise max over two batches == JAX's."""
    inp = _flux_inputs(CFG, 2, 64, 16, 0, padded)
    want_out, want = jax_flux_apply(CFG, params, **{k: jnp.asarray(v) for k, v in inp.items()},
                                    rope_layout="half", attn_impl="xla", collect_a8_stats=True)
    model = convert.flux_from_jax(_np(params), CFG, device="cpu")
    out, stats = model(**{k: _t(v) for k, v in inp.items()}, collect_a8_stats=True)
    got = convert.lora_to_jax(stats)
    assert jax.tree.structure(got) == jax.tree.structure(_np(want))
    assert {p.rsplit(".", 1)[-1] for p, _ in tree_items(stats)} == A8_KEYS
    assert _stats_rel_err(got, want) <= 2e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-4 * float(np.abs(want_out).max()))
    with pytest.raises(ValueError, match="calibration"):
        model(**{k: _t(v) for k, v in inp.items()}, collect_a8_stats=True, remat=True)

    batches = [inp, _flux_inputs(CFG, 2, 64, 16, 1, padded)]
    want = jq.calibrate_flux_a8(CFG, params, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                                attn_impl="xla", rope_layout="half")
    got = tq.calibrate_flux_a8(model, [{k: _t(v) for k, v in b.items()} for b in batches])
    assert _stats_rel_err(convert.lora_to_jax(got), want) <= 2e-5


def test_block_stats_match_jax_on_the_same_inputs(params):
    """One double and one single block fed the same inputs: their statistics
    within 1e-6 of JAX's; under remat (seg) collection raises, as in JAX."""
    rng = np.random.default_rng(8)
    h, l_txt, l_img = CFG.hidden_size, 8, 16
    img, txt = (rng.standard_normal((2, n, h)).astype(np.float32) for n in (l_img, l_txt))
    vec = rng.standard_normal((2, h)).astype(np.float32)
    pe = np.stack([np.cos(rng.uniform(0, 6, (2, l_txt + l_img, CFG.head_dim // 2))),
                   np.sin(rng.uniform(0, 6, (2, l_txt + l_img, CFG.head_dim // 2)))]).astype(np.float32)
    take = functools.partial(jax.tree.map, lambda a: a[0])
    dp, sp = take(params["double_blocks"]), take(params["single_blocks"])
    jpe = (jnp.asarray(pe[0]), jnp.asarray(pe[1]))
    tpe = (_t(pe[0]), _t(pe[1]))
    _, want_d = jlayers.double_block(CFG, dp, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(vec), jpe, None,
                                     attn_impl="xla", rope_layout="half", collect_stats=True)
    x = np.concatenate([txt, img], axis=1)
    _, want_s = jlayers.single_block(CFG, sp, jnp.asarray(x), jnp.asarray(vec), jpe, None, attn_impl="xla",
                                     rope_layout="half", collect_stats=True)
    model = convert.flux_from_jax(_np(params), CFG, device="cpu")
    db, sb = model.double_blocks[0], model.single_blocks[0]
    assert isinstance(db, DoubleBlock) and isinstance(sb, SingleBlock)
    _, got_d = db(_t(img), _t(txt), _t(vec), tpe, None, collect_stats=True)
    _, got_s = sb(_t(x), _t(vec), tpe, None, collect_stats=True)
    arr = functools.partial(jax.tree.map, lambda t: t.numpy())
    assert _stats_rel_err(arr(got_d), want_d) <= 1e-6
    assert _stats_rel_err(arr(got_s), want_s) <= 1e-6
    with pytest.raises(ValueError, match="calibration"):
        sb(_t(x), _t(vec), tpe, None, seg=lambda f: f, collect_stats=True)


def _compare_w8a8_trees(got: torch.nn.Module, want: torch.nn.Module, code_share: float, scale_rel: float,
                        dense_rel: float = 0.0) -> dict:
    """Codes within 1 of `want`'s in at most code_share of the elements;
    a_sinv and w_scale within scale_rel of each element; every other tensor
    within dense_rel of its largest magnitude (0: exact). Returns the
    readings."""
    gs, ws = got.state_dict(), want.state_dict()
    assert set(gs) == set(ws)
    flips = total = 0
    worst_rel = 0.0
    for key, val in ws.items():
        g = gs[key]
        assert g.dtype == val.dtype and g.shape == val.shape, key
        if key.endswith("w_int8"):
            d = (g.int() - val.int()).abs()
            assert int(d.max()) <= 1, key
            flips += int((d > 0).sum())
            total += d.numel()
        elif key.endswith(("a_sinv", "w_scale")):
            worst_rel = max(worst_rel, ((g - val).abs() / val.abs()).max().item())
        elif dense_rel:
            assert (g.float() - val.float()).abs().max() <= dense_rel * val.float().abs().max(), key
        else:
            assert torch.equal(g, val), key
    assert flips <= code_share * total, (flips, total)
    assert worst_rel <= scale_rel, worst_rel
    return {"flips": flips, "codes": total, "scale_rel": worst_rel}


def test_smooth_quantization_fed_jax_stats_matches_jax(params):
    inp = _flux_inputs(CFG, 2, 64, 16, 0, True)
    _, jstats = jax_flux_apply(CFG, params, **{k: jnp.asarray(v) for k, v in inp.items()}, rope_layout="half",
                               attn_impl="xla", collect_a8_stats=True)
    want = convert.flux_from_jax(_np(jq.quantize_flux_w8a8_smooth(params, jstats)), CFG, device="cpu")
    stats = convert.lora_from_jax(_np(jstats), CFG, device="cpu")
    dense = convert.flux_from_jax(_np(params), CFG, device="cpu")
    got = tq.quantize_flux_w8a8_smooth(dense, stats)
    assert all(m.a_sinv is not None for m in got.modules() if isinstance(m, W8A8Linear))
    _compare_w8a8_trees(got, want, code_share=1e-3, scale_rel=4 * ULP32)
    del stats["single_blocks"][1]["linear2"]
    with pytest.raises(ValueError, match="single_blocks.1.linear2"):
        tq.quantize_flux_w8a8_smooth(dense, stats)
    # the smooth scales themselves, from the same statistic and weight
    w = np.asarray(params["single_blocks"]["linear1"]["w"][0])
    st = np.asarray(jstats["single_blocks"]["linear1"][0])
    s_j = np.asarray(jq.smooth_scales(jnp.asarray(st), jnp.asarray(w)))
    s_t = tq.smooth_scales(_t(st), _t(w.T)).numpy()
    assert (np.abs(s_t - s_j) <= 4 * ULP32 * np.abs(s_j)).all()


# The tiny w8a8 DiTs (JAX's quantize_flux_w8a8[_smooth] of fp32 init_flux
# params, carried over; JAX through attn_impl="xla") vs the port (kernels I,
# H and G through their plain versions): every quantized linear returns
# bf16, and JAX and PyTorch round bf16 gelu(tanh) and silu differently (see
# test_torch_quant._DIT_INT8); a code that such a difference moves across a
# rounding boundary moves its token's product by a whole step. Reading, max
# and mean |Δ| over the output RMS: w8a8 0.0377 and 0.0083 (no padding),
# 0.0436 and 0.0088 (padded); w8a8_smooth 0.0376 and 0.0082, 0.0420 and
# 0.0077. Bounds: twice the reading. Both are still within JAX's own bound
# against the fp32 DiT (tests/test_quant.py: correlation > 0.97; reading
# 0.99988).
_DIT_W8A8 = {"max": 9e-2, "mean": 1.8e-2}


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("mode", ["w8a8", "w8a8_smooth"])
def test_dit_w8a8_matches_jax(params, mode, padded):
    inp = _flux_inputs(CFG, 2, 64, 16, 0, padded)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    if mode == "w8a8":
        qparams = jq.quantize_flux_w8a8(params)
    else:
        _, st = jax_flux_apply(CFG, params, **jin, rope_layout="half", attn_impl="xla", collect_a8_stats=True)
        qparams = jq.quantize_flux_w8a8_smooth(params, st)
    want = np.asarray(jax_flux_apply(CFG, qparams, **jin, rope_layout="half", attn_impl="xla"), np.float32)
    model = convert.flux_from_jax(_np(qparams), CFG, device="cpu")
    lin = model.double_blocks[1].txt_mlp["2"]
    assert isinstance(lin, W8A8Linear) and (lin.a_sinv is not None) == (mode == "w8a8_smooth")
    assert isinstance(model.double_blocks[1].txt_mod.lin, Int8Linear)
    got = model(**{k: _t(v) for k, v in inp.items()}).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want ** 2)))
    diff = np.abs(got - want)
    assert diff.max() <= _DIT_W8A8["max"] * rms, diff.max() / rms
    assert diff.mean() <= _DIT_W8A8["mean"] * rms, diff.mean() / rms
    ref = np.asarray(jax_flux_apply(CFG, params, **jin, rope_layout="half", attn_impl="xla"), np.float32)
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.97


def test_convert_carries_w8a8_trees(params):
    """A w8a8_smooth tree carried into the port keeps every code and leaf
    (the codes transposed to (out, in)); a tree with a_sinv on some w8a8
    entries only is refused."""
    inp = {k: jnp.asarray(v) for k, v in _flux_inputs(CFG, 1, 16, 4, 0, False).items()}
    shapes = jax.eval_shape(lambda: jax_flux_apply(CFG, params, **inp, attn_impl="xla", collect_a8_stats=True)[1])
    st = jax.tree.map(lambda s: jnp.full(s.shape, 2.0, F32), shapes)
    q = _np(jq.quantize_flux_w8a8_smooth(params, st))
    model = convert.flux_from_jax(q, CFG, device="cpu")
    lin = model.single_blocks[1].linear2
    np.testing.assert_array_equal(lin.w_int8.numpy(), q["single_blocks"]["linear2"]["w_int8"][1].T)
    np.testing.assert_array_equal(lin.a_sinv.numpy(), q["single_blocks"]["linear2"]["a_sinv"][1])
    del q["single_blocks"]["linear2"]["a_sinv"]
    with pytest.raises(ValueError, match="together"):
        convert.flux_from_jax(q, CFG, device="cpu")


# ----------------------------- the pipeline -----------------------------


def _calib_noise(seed: int, row_shape, rows: int = 2) -> dict:
    """The JAX pipeline's draws for a grid of `rows` rows without SDEdit, in
    the port's order of use (prepare_query: split(key, 3) per row)."""
    key = jax.random.PRNGKey(seed)
    vae, latent = [], []
    for _ in range(rows):
        key, ek, nk = jax.random.split(key, 3)
        vae.append(np.asarray(jax.random.normal(ek, row_shape, F32)))
        latent.append(np.asarray(jax.random.normal(nk, row_shape, F32)))
    return {"vae": vae, "latent": latent}


def test_build_visualcloze_w8a8_smooth_matches_jax(tiny_jax_loader, stack_files, monkeypatch):
    """build_visualcloze(quantize="w8a8_smooth") in both packages on the tiny
    BFL + LoRA files: the LoRA folded, the DiT permuted to the half layout,
    calibrated with the defaults (a blank 2x2 grid, 30 Euler steps,
    statistics every 5th and at the last, seed 1; JAX's noise replayed into
    the port), then quantized. The timestep embedding is JAX's in both, as
    in test_torch_checkpoints' heun and ab2 cases: at guidance 30 the two
    frameworks' embeddings differ by ~1e-3 (test_torch_ops), which would
    otherwise set the statistics' difference.

    Readings and bounds: the statistics within 3.1e-4 of each entry's
    largest value (the calibration's latents are bf16, so the two 30-step
    trajectories drift apart by bf16 roundings; bound 1e-3); the quantized
    DiTs' codes differ by 1 in 38 of 494,592 elements (bound 0.1%), a_sinv
    and w_scale by 2.6e-4 relative (half the statistics' difference, through
    s = a^0.5 / wmax^0.5; bound 1e-3), the folded dense tensors within 1e-6
    of their largest value (the fold's bound in test_torch_checkpoints).
    Then a 2x2 query (4 steps) on each package's own w8a8 model: the
    denoised bf16 latents within 1.96% relative RMS of JAX's (bound 4%),
    correlation 0.99981 (bound 0.999), while the 4 steps move them by 82%
    of their RMS. Far looser than the int8 pipeline's (test_torch_quant):
    every w8a8 linear returns bf16, JAX and PyTorch round bf16 gelu and silu
    differently, and an activation code that such a rounding moves moves its
    token's product by a whole quantization step (_DIT_W8A8)."""
    captured = {}
    noise = _calib_noise(1, (1, 8, 16, 4))

    def spy(orig, tag, **kw):
        def run(self, *a, **k):
            captured[tag] = orig(self, *a, **k, **kw)
            return captured[tag]
        return run

    monkeypatch.setattr(JaxModel, "calibrate_w8a8_smooth", spy(JaxModel.calibrate_w8a8_smooth, "jax"))
    monkeypatch.setattr(VisualClozeModel, "calibrate_w8a8_smooth",
                        spy(VisualClozeModel.calibrate_w8a8_smooth, "port", noise=[noise]))
    monkeypatch.setattr(tflux, "timestep_embedding", _jax_timestep_embedding)
    path = str(stack_files["lora"])
    jm = jloader.build_visualcloze(model_path=path, resolution=64, dtype=F32, quantize="w8a8_smooth")
    pm = tloader.build_visualcloze(model_path=path, resolution=64, dtype=torch.float32, device="cpu",
                                   quantize="w8a8_smooth")
    assert pm.rope_layout == "half" and set(pm.stage_seconds) >= {"calibrate_denoise", "quantize"}
    got_stats = convert.lora_to_jax(captured["port"])
    assert _stats_rel_err(got_stats, captured["jax"]) <= 1e-3
    want = convert.flux_from_jax(_np(jm.params), JFLUX, device="cpu")
    _compare_w8a8_trees(pm.flux, want, code_share=1e-3, scale_rel=1e-3, dense_rel=1e-6)

    from test_torch_pipeline import SEED, _grid, _jax_noise

    for m in (jm, pm):
        m.set_grid_size(2, 2)
    grid = _grid()
    qj = jm.prepare_query(grid, PROMPTS, seed=SEED, steps=4)
    qp = pm.prepare_query(grid, PROMPTS, seed=SEED, steps=4, noise=_jax_noise((1, 8, 16, 4), (1, 8, 8, 4)))
    sj = np.asarray(jm.denoise_query(qj), np.float32)
    got = pm.denoise_query(qp).float().numpy()
    assert np.isfinite(got).all() and got.shape == sj.shape
    rel_rms = float(np.sqrt(np.mean((got - sj) ** 2) / np.mean(sj ** 2)))
    assert rel_rms <= 4e-2, rel_rms
    assert np.corrcoef(got.ravel(), sj.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("mode", ["w8a8", "w8a8_smooth"])
def test_build_visualcloze_serves_w8a8_modes(tiny_jax_loader, stack_files, mode):
    """build_visualcloze(quantize=...) returns a w8a8 DiT (W8A8Linear in
    every token-dim block linear, a_sinv with w8a8_smooth) that serves a
    query; calib_queries replaces the blank calibration grid."""
    cell = Image.new("RGB", (64, 64), (40, 160, 220))
    calib = [([[cell, cell], [cell, None]], ["a grid", "", ""])] if mode == "w8a8_smooth" else None
    pm = tloader.build_visualcloze(model_path=str(stack_files["lora"]), resolution=64, dtype=torch.float32,
                                   device="cpu", quantize=mode, calib_queries=calib)
    lins = [m for _, _, m in a8_linears(pm.flux)]
    assert len(lins) == 8 * JFLUX.depth + 2 * JFLUX.depth_single_blocks
    assert all(isinstance(m, W8A8Linear) and (m.a_sinv is not None) == (mode == "w8a8_smooth") for m in lins)
    assert isinstance(pm.flux.img_in, Int8Linear)
    pm.set_grid_size(2, 2)
    out = pm.process_images([[cell, cell], [cell, None]], ["a", "b", "c"], seed=3, steps=2, is_upsampling=False)
    assert out[0].size == (64, 64) and np.asarray(out[0]).std() > 0
