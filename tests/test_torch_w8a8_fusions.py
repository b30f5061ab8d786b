"""The fused w8a8 route (models/layers.py `_takes_codes`): kernels J and M
writing their consumer linear's int8 codes (ops/block_fusions.py
`layernorm_modulate_quant`, `merge_heads_quant`) and kernel O, gelu + the
quantize of mlp.2's input (ops/act_quant.py `gelu_act_quant`), through their
plain versions on the CPU, against the JAX package's XLA-fused code; then
the tiny w8a8 and w8a8_smooth DiT on that route against the port's unfused
route (kernel I after J, M and gelu) and against JAX, and the cases that keep
the unfused route.

Bounds, and the reading behind each one that is not exact:
- J quantized (fp32 and bf16-rounded x_mod) and M quantized against JAX's
  act_quant_int8 of JAX's x_mod and merge: codes within 1 in at most 0.1% of
  the elements, scales within 1e-6 relative (the LayerNorm's fp32 sums run
  in another order than XLA's; readings: 0 codes and 0 scales apart).
- The gelu paths (M's MLP half, O): JAX's jax.nn.gelu on bf16 and
  PyTorch's F.gelu round differently in ~40% of the elements (reading on
  N(0, 1)-N(0, 9) inputs; tests/test_torch_fusions.py notes the same), which
  moves codes by up to 2 in 1-4% of the elements and a scale by up to 0.5%:
  no port of the quantize can meet 0.1% there. So the quantize is held to the
  0.1% / 1e-6 bound against JAX's act_quant_int8 of JAX's gelu computed as
  PyTorch computes it (fp32, one rounding to bf16), and against
  jax.nn.gelu on bf16 itself to codes within 2 in at most 8% of the
  elements and scales within 2^-7 relative (one bf16 ulp at the absmax;
  twice the readings).
- The tiny DiT on the fused route equals the unfused route bit for bit (the
  plain versions are the same PyTorch ops) and stays within
  tests/test_torch_w8a8.py's bound of JAX (_DIT_W8A8).
"""

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import _flux_inputs
from test_torch_w8a8 import _DIT_W8A8

from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models import layers as jl
from visualcloze_tpu.models import quant as jq
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch import ops
from visualcloze_tpu_torch.models import layers as layers_mod
from visualcloze_tpu_torch.models.layers import TPShard, W8A8Linear
from visualcloze_tpu_torch.models.lora import init_lora, randomize_lora_b
from visualcloze_tpu_torch.ops import attention as attention_mod
from visualcloze_tpu_torch.ops.act_quant import gelu_act_quant
from visualcloze_tpu_torch.ops.block_fusions import layernorm_modulate_quant, merge_heads_quant

F32, BF16 = jnp.float32, jnp.bfloat16
CFG = FluxConfig().tiny()
CODE_SHARE, SCALE_REL = 1e-3, 1e-6  # codes off by 1 in at most 0.1%; scales within 1e-6
GELU_CODES, GELU_SHARE, GELU_SCALE_REL = 2, 0.08, 2.0 ** -7  # against jax.nn.gelu on bf16


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32)))
    return t if dtype is None else t.to(dtype)


def _jax_quant(x, sinv):
    """JAX linear's w8a8 quantize of x: the SmoothQuant divide (x in fp32
    times a_sinv), then act_quant_int8 -> codes (M, K), scales (M,)."""
    xs = x.astype(F32) * sinv if sinv is not None else x
    codes, scale = jq.act_quant_int8(xs)
    k = codes.shape[-1]
    return np.asarray(codes).reshape(-1, k), np.asarray(scale).reshape(-1)


def _assert_quant_close(got, want, codes_off=1, share=CODE_SHARE, scale_rel=SCALE_REL):
    codes, scale = got
    want_codes, want_scale = want
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(codes.shape) == want_codes.shape and tuple(scale.shape) == want_scale.shape
    d = np.abs(codes.numpy().astype(np.int32) - want_codes.astype(np.int32))
    assert d.max() <= codes_off, d.max()
    assert (d != 0).mean() <= share, (d != 0).mean()
    rel = np.abs(scale.numpy() - want_scale) / want_scale
    assert rel.max() <= scale_rel, rel.max()


def _sinv(rng, k, smooth):
    return rng.uniform(0.2, 5.0, (k,)).astype(np.float32) if smooth else None


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_layernorm_modulate_quant_plain_matches_jax(dtype, smooth):
    """J quantized: JAX's (1 + scale) * layer_norm(x) + shift, in fp32 (a
    double block's qkv and mlp.0 input) or cast to bf16 (the single block's
    linear1 input, .astype(x.dtype)), then linear's w8a8 quantize. A row of
    equal values (LayerNorm's zero row, then shift alone) included."""
    rng = np.random.default_rng(11)
    b, length, c = 2, 9, 96
    x = (rng.standard_normal((b, length, c)) * 2.0 + 0.5).astype(np.float32)
    x[1, 3] = 1.5
    shift, scale = (rng.standard_normal((b, 1, c)).astype(np.float32) * 0.5 for _ in range(2))
    sinv = _sinv(rng, c, smooth)
    xj = jnp.asarray(x).astype(BF16)
    x_mod = (1.0 + scale) * jl.layer_norm(xj) + shift
    want = _jax_quant(x_mod.astype(dtype), sinv)
    got = layernorm_modulate_quant(_t(xj.astype(F32), torch.bfloat16), _t(shift), _t(scale),
                                   None if sinv is None else _t(sinv),
                                   torch.bfloat16 if dtype == BF16 else torch.float32)
    _assert_quant_close(got, want)


def _merge_case(seed, gelu_cols):
    """Attention's output (B, H, L, D) bf16, a mask with padded query rows and
    (gelu_cols) an N(0, 9) MLP half, as numpy; and JAX's merged rows."""
    rng = np.random.default_rng(seed)
    b, heads, length, d = 2, 2, 10, 16
    x = jnp.asarray(rng.standard_normal((b, heads, length, d)), F32).astype(BF16)
    mask = np.ones((b, length), np.int32)
    mask[1, 7:] = 0
    mask[0, 9:] = 0
    merged = jnp.swapaxes(x, 1, 2).reshape(b, length, heads * d) * jnp.asarray(mask)[..., None].astype(BF16)
    h = jnp.asarray(rng.standard_normal((b, length, gelu_cols)) * 3.0, F32).astype(BF16) if gelu_cols else None
    return rng, x, mask, merged, h


@pytest.mark.parametrize("smooth", [False, True])
def test_merge_heads_quant_plain_matches_jax_in_a_double_block(smooth):
    """M quantized, a double block: JAX's merge (padded query rows zeroed) cut
    at txt_len, each part quantized with its own proj's a_sinv; the padded
    rows give codes 0 and scale 1e-8 / 127."""
    rng, x, mask, merged, _ = _merge_case(12, 0)
    txt_len, w = 3, merged.shape[-1]
    sinv_txt, sinv_img = _sinv(rng, w, smooth), _sinv(rng, w, smooth)
    got = merge_heads_quant(_t(x.astype(F32), torch.bfloat16), torch.from_numpy(mask), None,
                            None if sinv_img is None else _t(sinv_img), txt_len,
                            None if sinv_txt is None else _t(sinv_txt))
    assert len(got) == 2
    _assert_quant_close(got[0], _jax_quant(merged[:, :txt_len], sinv_txt))
    _assert_quant_close(got[1], _jax_quant(merged[:, txt_len:], sinv_img))
    img_codes, img_scale = got[1]
    padded = (img_codes.reshape(2, -1, w)[1, 7 - txt_len:], img_scale.reshape(2, -1)[1, 7 - txt_len:])
    assert not padded[0].any() and bool((padded[1] == np.float32(1e-8) / np.float32(127.0)).all())


@pytest.mark.parametrize("smooth", [False, True])
def test_merge_heads_quant_plain_matches_jax_in_a_single_block(smooth):
    """M quantized, a single block: concatenate([merge, gelu(mlp_h)]) (the
    padded rows' merge zeroed, their gelu half kept) quantized with
    linear2's a_sinv: against JAX's gelu computed as PyTorch's (fp32, one
    rounding) within the quantize's bound, against jax.nn.gelu on bf16
    within the gelu's (module docstring)."""
    rng, x, mask, merged, h = _merge_case(13, 48)
    sinv = _sinv(rng, merged.shape[-1] + 48, smooth)
    got = merge_heads_quant(_t(x.astype(F32), torch.bfloat16), torch.from_numpy(mask), _t(h.astype(F32),
                            torch.bfloat16), None if sinv is None else _t(sinv))
    assert len(got) == 1
    as_torch = jax.nn.gelu(h.astype(F32), approximate=True).astype(BF16)
    _assert_quant_close(got[0], _jax_quant(jnp.concatenate([merged, as_torch], -1), sinv))
    bf16_gelu = jax.nn.gelu(h, approximate=True)
    _assert_quant_close(got[0], _jax_quant(jnp.concatenate([merged, bf16_gelu], -1), sinv), GELU_CODES,
                        GELU_SHARE, GELU_SCALE_REL)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_gelu_act_quant_plain_matches_jax(scale, smooth):
    """O: gelu(tanh) of the bf16 mlp.0 output, then mlp.2's w8a8 quantize
    (double_block :276 and linear's a8 branch); an all-zero row (gelu 0:
    codes 0, scale 1e-8 / 127) included."""
    rng = np.random.default_rng(14)
    h = jnp.asarray(rng.standard_normal((3, 11, 128)) * scale, F32).astype(BF16)
    h = h.at[1, 4].set(0.0)
    sinv = _sinv(rng, 128, smooth)
    got = gelu_act_quant(_t(h.astype(F32), torch.bfloat16), None if sinv is None else _t(sinv))
    _assert_quant_close(got, _jax_quant(jax.nn.gelu(h.astype(F32), approximate=True).astype(BF16), sinv))
    _assert_quant_close(got, _jax_quant(jax.nn.gelu(h, approximate=True), sinv), GELU_CODES, GELU_SHARE,
                        GELU_SCALE_REL)
    assert not got[0][11 + 4].any()


def _rn32(v: Fraction) -> np.float32:
    """The exact value v rounded to the nearest float32, ties to even (v 0 or
    in float32's normal range)."""
    if v == 0:
        return np.float32(0.0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    ulp = Fraction(2) ** (e - 23)
    n, rem = divmod(a, ulp)
    if 2 * rem > ulp or (2 * rem == ulp and n % 2):
        n += 1
    return np.float32(float(n * ulp) * (1 if v > 0 else -1))


def test_reciprocal_quotient_is_the_ieee_quotient():
    """csrc/act_quant.cuh `quotient`, emulated exactly: with r = RN(1 / s), q =
    RN(x r), e = RN(x - s q) and RN(q + e r) (each FMA one rounding of the
    exact value) equals the IEEE quotient RN(x / s) wherever |x / s| >= 1/2,
    and rounds to the same code below; x drawn next to every half-integer
    multiple of s (the codes' rounding ties) and uniformly over [-127 s,
    127 s], s = max(amax, 1e-8) / 127 over amax from 1e-12 to 1e18 (the
    kernels take this path for s in [2^-64, 2^64])."""
    rng = np.random.default_rng(21)
    checked = 0
    for amax in np.float32(10.0) ** rng.uniform(-12, 18, 40).astype(np.float32):
        s = np.float32(max(amax, np.float32(1e-8))) / np.float32(127.0)
        r = np.float32(1.0) / s
        ties = (np.arange(-127, 127) + np.float32(0.5)).astype(np.float32) * s
        xs = np.concatenate([np.nextafter(ties, np.float32(np.inf)), np.nextafter(ties, -np.float32(np.inf)), ties,
                             rng.uniform(-127, 127, 200).astype(np.float32) * s]).astype(np.float32)
        for x in xs:
            q = np.float32(x * r)
            e = _rn32(Fraction(float(x)) - Fraction(float(s)) * Fraction(float(q)))
            got = _rn32(Fraction(float(q)) + Fraction(float(e)) * Fraction(float(r)))
            want = np.float32(x / s)
            if abs(want) >= 0.5:
                assert got == want, (x, s)
            assert np.rint(got) == np.rint(want), (x, s)
            checked += 1
    assert checked == 40 * (3 * 254 + 200)


# ----------------------------- the tiny DiT on each route -----------------------------


@pytest.fixture(scope="module")
def params():
    return init_flux(jax.random.PRNGKey(1), CFG)


@functools.lru_cache(maxsize=None)
def _quantized(mode: str, padded: bool):
    """(JAX's quantized tree, JAX's output, the inputs) of the tiny DiT; w8a8_smooth
    calibrated on the same inputs, as tests/test_torch_w8a8.py does."""
    params = init_flux(jax.random.PRNGKey(1), CFG)
    inp = _flux_inputs(CFG, 2, 64, 16, 0, padded)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    if mode == "w8a8":
        qparams = jq.quantize_flux_w8a8(params)
    else:
        _, st = jax_flux_apply(CFG, params, **jin, rope_layout="half", attn_impl="xla", collect_a8_stats=True)
        qparams = jq.quantize_flux_w8a8_smooth(params, st)
    want = np.asarray(jax_flux_apply(CFG, qparams, **jin, rope_layout="half", attn_impl="xla"), np.float32)
    return jax.tree.map(np.asarray, qparams), want, inp


def _model(mode, padded):
    qparams, want, inp = _quantized(mode, padded)
    return convert.flux_from_jax(qparams, CFG, device="cpu"), want, {k: _t(v) if v.dtype != np.int32 else
                                                                     torch.from_numpy(v) for k, v in inp.items()}


ROUTE = ("layernorm_modulate_quant", "merge_heads_quant", "gelu_act_quant", "act_quant_int8")


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the fused route's three wrappers and kernel I's,
    where the blocks and attention() reach them."""
    seen = dict.fromkeys(ROUTE, 0)

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for module, name in ((layers_mod, "layernorm_modulate_quant"), (attention_mod, "merge_heads_quant"),
                         (layers_mod, "gelu_act_quant"), (layers_mod, "act_quant_int8")):
        monkeypatch.setattr(module, name, counted(name, getattr(module, name)))
    return seen


def _fused_counts(depth=CFG.depth, single=CFG.depth_single_blocks) -> dict:
    """The fused route per evaluation: J before 4 linears a double block and
    linear1, M before both projs and linear2, O before both mlp.2s, no I."""
    return {"layernorm_modulate_quant": 4 * depth + single, "merge_heads_quant": depth + single,
            "gelu_act_quant": 2 * depth, "act_quant_int8": 0}


UNFUSED = {"layernorm_modulate_quant": 0, "merge_heads_quant": 0, "gelu_act_quant": 0,
           "act_quant_int8": 8 * CFG.depth + 2 * CFG.depth_single_blocks}


def _unfused(model, inp, monkeypatch, **kw):
    """The model's output with every w8a8 linear quantizing its own input
    (kernel I), the route before kernels J and M wrote codes."""
    with monkeypatch.context() as m:
        m.setattr(W8A8Linear, "takes_codes", lambda self, lora, *inputs: False)
        with torch.no_grad():
            return model(**inp, **kw)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("mode", ["w8a8", "w8a8_smooth"])
def test_dit_w8a8_fused_route_matches_the_unfused_route_and_jax(calls, monkeypatch, mode, padded):
    model, want, inp = _model(mode, padded)
    with torch.no_grad():
        got = model(**inp)
    assert calls == _fused_counts()
    for k in calls:
        calls[k] = 0
    unfused = _unfused(model, inp, monkeypatch)
    assert calls == UNFUSED
    assert torch.equal(got, unfused)
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want ** 2)))
    diff = np.abs(got - want)
    assert diff.max() <= _DIT_W8A8["max"] * rms, diff.max() / rms
    assert diff.mean() <= _DIT_W8A8["mean"] * rms, diff.mean() / rms


def test_a_lora_entry_keeps_its_linear_on_kernel_i(calls, monkeypatch):
    """A runtime LoRA entry on the qkv and linear2 linears only: those
    quantize their own input (I; the delta needs bf16(x)), the other w8a8
    linears still take J's, M's and O's codes; the same bits as the all-I
    route."""
    model, _, inp = _model("w8a8_smooth", True)
    lora = randomize_lora_b(init_lora(model, 4, generator=torch.Generator().manual_seed(3)),
                            torch.Generator().manual_seed(4))
    for blk in lora["double_blocks"]:
        for key in [k for k in blk if k not in ("img_attn", "txt_attn")]:
            del blk[key]
        for stream in ("img_attn", "txt_attn"):
            blk[stream] = {"qkv": blk[stream]["qkv"]}
    for blk in lora["single_blocks"]:
        for key in [k for k in blk if k != "linear2"]:
            del blk[key]
    for key in [k for k in lora if k not in ("double_blocks", "single_blocks")]:
        del lora[key]
    with torch.no_grad():
        got = model(**inp, lora=lora)
    d, s = CFG.depth, CFG.depth_single_blocks
    assert calls == {"layernorm_modulate_quant": 2 * d + s, "merge_heads_quant": d, "gelu_act_quant": 2 * d,
                     "act_quant_int8": 2 * d + s}
    assert torch.equal(got, _unfused(model, inp, monkeypatch, lora=lora))


def test_a_tp_shard_keeps_its_linear_on_kernel_i(calls, monkeypatch):
    """Every w8a8 linear with a (one-rank, whole) column shard quantizes its
    own input (the shard's copy_to comes first): no J, M or O codes."""
    model, _, inp = _model("w8a8", False)
    for lin in model.modules():
        if isinstance(lin, W8A8Linear):
            lin.tp = TPShard("column", None, torch.arange(lin.out_features), lin.out_features)
    with torch.no_grad():
        got = model(**inp)
    assert calls == UNFUSED
    for lin in model.modules():
        if isinstance(lin, W8A8Linear):
            lin.tp = None
    with torch.no_grad():
        assert torch.equal(got, model(**inp))


def test_calibration_and_autograd_keep_kernel_i(calls, monkeypatch):
    """The passes that collect SmoothQuant statistics run the plain blocks,
    and a forward whose input wants a gradient the autograd route: both
    quantize through kernel I (the autograd route decides per call: the
    first double block's text stream, which no gradient reaches yet, keeps
    J's codes for its qkv), the autograd route with the fused route's bits
    (the calibration route rotates and normalizes in plain passes of its
    own)."""
    model, _, inp = _model("w8a8_smooth", False)
    with torch.no_grad():
        fused = model(**inp)
    assert calls == _fused_counts()
    for k in calls:
        calls[k] = 0
    with torch.no_grad():
        out, stats = model(**inp, collect_a8_stats=True)
    assert calls == UNFUSED and stats["double_blocks"] and stats["single_blocks"]
    assert out.shape == fused.shape and bool(torch.isfinite(out).all())
    for k in calls:
        calls[k] = 0
    img = inp["img"].clone().requires_grad_(True)
    out = model(**dict(inp, img=img))
    assert calls == dict(UNFUSED, layernorm_modulate_quant=1, act_quant_int8=UNFUSED["act_quant_int8"] - 1)
    assert out.requires_grad
    assert torch.equal(out.detach(), fused)
    assert ops.kernel_launches()["layernorm_modulate_quant"] == 0  # the CPU runs plain versions: no launch
