"""Work that the port once ran as plain passes, folded into kernels: the
RoPE rotation of q and k into kernel L (its transpose into L'), and the
bias of the int8 and int4 linears into kernels G and G4.

- L's plain version with RoPE tables, in the interleaved and the half
  layout, against JAX's `_split_heads` -> `qk_norm` -> `rope_qk` (a joint
  two-stream buffer at token offsets, and a single stream wider than its
  qkv columns); L''s plain backward with the rotation (through the
  QKNormSplit Function) against jax.vjp of the same chain.
- The tiny double and single blocks and the tiny DiT under autograd, in the
  trainer's interleaved layout, against jax.vjp of JAX's: on the fused
  route kernel L rotates (its wrapper gets the tables) and no plain
  rotation runs (attention's rope_qk, FlashMHARope: counted by the `calls`
  fixture); the half layout under autograd likewise; without a gradient
  both layouts rotate in L too (the half one, serving's, once left the
  rotation to kernel A, flash_mha_rope, which the blocks now never reach).
- G's and G4's plain versions with a bias equal the bias-less plain version
  followed by the bf16 add `y + b` bit for bit (what the linears ran before
  the bias moved into the kernels' epilogues); Int8Linear and Int4DiTLinear
  with a bias against JAX's `linear` with "b".

Bounds, as tests/test_torch_fusions.py and test_torch_fusions_bwd.py hold
L and L': in fp32 max |Δ| <= 1e-5 of the largest output (gradient); in
bf16 one bf16 ulp at the largest; the q/k scales' bf16 gradients against
jax.vjp of the fp32 chain on the same values (JAX's bf16 vjp rounds each
product and sums in bf16); the blocks and the DiT 1e-4 of each output's
and gradient's RMS (fp32); the linears within one bf16 ulp of each output
(JAX rounds the int8 dot to bf16 before its rescale, the port once after
it: tests/test_torch_quant.py's bound), and the int4 linear as
tests/test_torch_int4.py holds it.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models import layers as jl
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.ops.attention import rope_qk as jax_rope_qk
from visualcloze_tpu.ops.rope import embed_nd as jax_embed_nd
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.ops import attention as tatt
from visualcloze_tpu_torch.ops import block_fusions as bf
from visualcloze_tpu_torch.ops import flash_attention as tfa
from visualcloze_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
from visualcloze_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from visualcloze_tpu_torch.ops.rope import embed_nd

F32, BF16 = torch.float32, torch.bfloat16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}
LAYOUTS = ("interleaved", "half")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Tiny ops: one intra-op thread under several test workers, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=F32, grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _j(a, dtype=F32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JAX_DTYPE[dtype])


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, want, dtype, what=""):
    """fp32: max |Δ| <= 1e-5 of the largest |want|; bf16: one bf16 ulp there."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max())
    tol = 1e-5 * top if dtype == F32 else 2.0 ** (math.floor(math.log2(top)) - 7)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _assert_rms_close(got, want, what=""):
    """max |Δ| <= 1e-4 of want's RMS (fp32)."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert rms > 0, what
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * rms, (what, err / rms)


def _tables(rng, b, length, d):
    """Random RoPE tables: angles uniform over [0, 40), cos and sin (b, length, d/2) fp32."""
    ang = rng.uniform(0.0, 40.0, (b, length, d // 2)).astype(np.float32)
    return np.cos(ang), np.sin(ang)


def _jax_streams(xs, scales, heads, pe, layout, dtype, cols):
    """JAX: each stream's _split_heads + qk_norm, concatenated on the token
    axis, then rope_qk of the joint q, k."""
    parts = []
    for x, (qs, ks) in zip(xs, scales):
        q, k, v = jl._split_heads(_j(x, dtype)[..., :cols], heads)
        q, k = jl.qk_norm({"q_scale": _j(qs, dtype), "k_scale": _j(ks, dtype)}, q, k, v)
        parts.append((q, k, v))
    q, k, v = (jnp.concatenate(ts, axis=2) for ts in zip(*parts))
    q, k = jax_rope_qk(q, k, (jnp.asarray(pe[0]), jnp.asarray(pe[1])), layout)
    return q, k, v


# ----------------------------- L and L' with the rotation -----------------------------


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_qk_norm_split_plain_rotates_the_joint_streams_as_jax(layout, dtype):
    """L with RoPE tables: a 3-token txt stream at token 0 and a 5-token img
    stream at token 3 of one joint buffer (each rotated by the tables' rows
    at its offset), against rope_qk of JAX's joint q, k; v unrotated, bit
    for bit."""
    rng = np.random.default_rng(31)
    heads, d, cols = 2, 16, 2 * 3 * 16
    xs = [rng.standard_normal((2, n, cols + 8)) * 2.0 for n in (3, 5)]
    scales = [tuple(rng.uniform(0.5, 1.5, (d,)) for _ in range(2)) for _ in range(2)]
    pe = _tables(rng, 2, 8, d)
    want = _jax_streams(xs, scales, heads, pe, layout, dtype, cols)
    tpe = (_t(pe[0]), _t(pe[1]))
    bufs = bf.qkv_buffers(_t(xs[0], dtype)[..., :cols], heads, 8)
    for x, (qs, ks), offset in zip(xs, scales, (0, 3)):
        out = bf.qk_norm_split(_t(x, dtype)[..., :cols], _t(qs, dtype), _t(ks, dtype), heads, bufs, offset, tpe,
                               layout)
        assert all(o is b for o, b in zip(out, bufs))
    for got, w, what in zip(bufs, want, "qkv"):
        _assert_close(got, w, dtype, what)
    np.testing.assert_array_equal(_f32(bufs[2]), _f32(want[2]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_single_stream_wider_than_its_qkv_columns_rotates_and_passes_the_rest(layout):
    """The single block's linear1 output through apply_qk_norm_split with the
    tables: q, k rotated as JAX's, v and the gelu half (the other columns)
    as they were; without a gradient L runs once, with the tables."""
    rng = np.random.default_rng(32)
    heads, d = 2, 16
    cols = 3 * heads * d
    h = rng.standard_normal((2, 6, cols + 24)) * 2.0
    qs, ks = (rng.uniform(0.5, 1.5, (d,)) for _ in range(2))
    pe = _tables(rng, 2, 6, d)
    want = _jax_streams([h], [(qs, ks)], heads, pe, layout, F32, cols)
    seen = []
    split = bf.qk_norm_split
    try:
        bf.qk_norm_split = lambda *a, **k: seen.append(a[6]) or split(*a, **k)
        q, k, v, rest = bf.apply_qk_norm_split([(_t(h), _t(qs), _t(ks))], heads, cols, (_t(pe[0]), _t(pe[1])), layout)
    finally:
        bf.qk_norm_split = split
    assert len(seen) == 1 and seen[0] is not None
    for got, w, what in zip((q, k, v), want, "qkv"):
        _assert_close(got, w, F32, what)
    assert torch.equal(rest, _t(h)[..., cols:])


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_qk_norm_split_bwd_with_the_rotation_matches_jax_vjp(layout, dtype):
    """L' with the rotation, through QKNormSplit over a 5-token txt and a
    9-token img stream: each stream's dqkv and its q/k scales' gradients
    against jax.vjp of _split_heads + qk_norm of each stream, concatenated,
    then rope_qk; L' runs once a stream, at its offset, with the tables."""
    rng = np.random.default_rng(33)
    heads, d = 2, 16
    cols = 3 * heads * d
    xs = [rng.standard_normal((2, n, cols)) * 2.0 for n in (5, 9)]
    scales = [tuple(rng.uniform(0.5, 1.5, (d,)) for _ in range(2)) for _ in range(2)]
    pe = _tables(rng, 2, 14, d)
    cots = [rng.standard_normal((2, heads, 14, d)) for _ in range(3)]

    def chain(x0, qs0, ks0, x1, qs1, ks1):
        parts = []
        for x, qs, ks in ((x0, qs0, ks0), (x1, qs1, ks1)):
            q, k, v = jl._split_heads(x, heads)
            q, k = jl.qk_norm({"q_scale": qs, "k_scale": ks}, q, k, v)
            parts.append((q, k, v))
        return tuple(jnp.concatenate(ts, axis=2) for ts in zip(*parts))

    def rope(q, k):
        return jax_rope_qk(q, k, (jnp.asarray(pe[0]), jnp.asarray(pe[1])), layout)

    def fn(*args):
        q, k, v = chain(*args)
        return (*rope(q, k), v)

    arrays = [xs[0], *scales[0], xs[1], *scales[1]]
    primals = [_j(a, dtype) for a in arrays]
    jcots = tuple(_j(c, dtype) for c in cots)
    want = jax.vjp(fn, *primals)[1](jcots)
    # the scales' bf16 sums against the fp32 chain on the same values: the gradient of the normalized q, k as
    # the rotation's transpose rounds it (in bf16), then the fp32 split + norm
    d_normed = jax.vjp(rope, *chain(*primals)[:2])[1](jcots[:2])
    want32 = jax.vjp(chain, *[p.astype(jnp.float32) for p in primals])[1](
        tuple(c.astype(jnp.float32) for c in (*d_normed, jcots[2])))
    ins = [_t(a, dtype, True) for a in arrays]
    seen = []
    bwd = bf.qk_norm_split_bwd
    try:
        bf.qk_norm_split_bwd = lambda *a, **k: seen.append((a[7], a[10] is not None)) or bwd(*a, **k)
        q, k, v, _ = bf.apply_qk_norm_split([ins[:3], ins[3:]], heads, cols, (_t(pe[0]), _t(pe[1])), layout)
        got = torch.autograd.grad((q, k, v), ins, tuple(_t(c, dtype) for c in cots))
    finally:
        bf.qk_norm_split_bwd = bwd
    assert seen == [(0, True), (5, True)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w if i % 3 == 0 or dtype == F32 else want32[i], dtype, f"input {i}")


# ----------------------------- the blocks' routes -----------------------------


@pytest.fixture
def calls(monkeypatch):
    """Records the plain rotations of the attention path (attention's
    rope_qk and FlashMHARope rotate with apply_rope / apply_rope_half),
    kernel A's entry (flash_mha_rope), and kernel L's calls with and
    without RoPE tables (block_fusions' qk_norm_split); calls through."""
    seen = {"rope_qk": 0, "flash_mha_rope_plain_rotation": 0, "flash_mha_rope": 0, "l_rotating": 0,
            "l_plain": 0}

    def count(mod, name, key):
        fn = getattr(mod, name)

        def wrapper(*args, **kwargs):
            seen[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, wrapper)

    count(tatt, "apply_rope", "rope_qk")
    count(tatt, "apply_rope_half", "rope_qk")
    count(tfa, "apply_rope_half", "flash_mha_rope_plain_rotation")
    count(tatt, "flash_mha_rope", "flash_mha_rope")
    split = bf.qk_norm_split

    def l_wrapper(*args, **kwargs):
        pe = args[6] if len(args) > 6 else kwargs.get("pe")
        seen["l_rotating" if pe is not None else "l_plain"] += 1
        return split(*args, **kwargs)

    monkeypatch.setattr(bf, "qk_norm_split", l_wrapper)
    return seen


@functools.lru_cache(maxsize=None)
def _tiny(seed: int = 3):
    cfg = FluxConfig().tiny()
    return cfg, init_flux(jax.random.PRNGKey(seed), cfg)


_jax_double_block = jax.jit(jl.double_block, static_argnames=("cfg", "attn_impl", "rope_layout"))
_jax_single_block = jax.jit(jl.single_block, static_argnames=("cfg", "attn_impl", "rope_layout"))


def _block_inputs(cfg, seed: int = 34):
    rng = np.random.default_rng(seed)
    b, l_txt, side = 2, 8, 4
    l_img = side * side
    ids = np.zeros((b, l_txt + l_img, 3), np.float32)
    ids[:, l_txt:, 0] = 1
    ids[:, l_txt:, 1] = np.arange(l_img) // side
    ids[:, l_txt:, 2] = np.arange(l_img) % side
    mask = np.ones((b, l_txt + l_img), np.int32)
    mask[0, -5:] = 0
    return rng, dict(img=rng.standard_normal((b, l_img, cfg.hidden_size)),
                     txt=rng.standard_normal((b, l_txt, cfg.hidden_size)),
                     vec=rng.standard_normal((b, cfg.hidden_size)), ids=ids, mask=mask)


def _block_run(kind: str, layout: str, grad: bool):
    """One tiny block on the fused route, the port against JAX: the outputs
    (and under autograd the inputs' and vec's gradients for random
    cotangents), as (what, got, want) triples."""
    cfg, params = _tiny()
    rng, inp = _block_inputs(cfg)
    model = convert.flux_from_jax(_np(params), cfg, device="cpu").requires_grad_(False)
    pe = jax_embed_nd(jnp.asarray(inp["ids"]), cfg.axes_dim, cfg.theta)
    tpe = embed_nd(_t(inp["ids"]), cfg.axes_dim, cfg.theta)
    mask, tmask = jnp.asarray(inp["mask"]), torch.from_numpy(inp["mask"])
    if kind == "double":
        p = jax.tree.map(lambda a: a[0], params["double_blocks"])
        xs = {"img": inp["img"], "txt": inp["txt"]}

        def jfn(xj, vec):
            return _jax_double_block(cfg=cfg, p=p, img=xj["img"], txt=xj["txt"], vec=vec, pe=pe, attn_mask=mask,
                                     attn_impl="xla", rope_layout=layout)

        def tfn(xt, vec):
            return model.double_blocks[0](xt["img"], xt["txt"], vec, tpe, tmask, rope_layout=layout)
    else:
        p = jax.tree.map(lambda a: a[0], params["single_blocks"])
        xs = {"x": np.concatenate([inp["txt"], inp["img"]], axis=1)}

        def jfn(xj, vec):
            return (_jax_single_block(cfg=cfg, p=p, x=xj["x"], vec=vec, pe=pe, attn_mask=mask, attn_impl="xla",
                                      rope_layout=layout),)

        def tfn(xt, vec):
            return (model.single_blocks[0](xt["x"], vec, tpe, tmask, rope_layout=layout),)

    want_out, pull = jax.vjp(jfn, {k: _j(v) for k, v in xs.items()}, _j(inp["vec"]))
    txs = {k: _t(v, grad=grad) for k, v in xs.items()}
    tvec = _t(inp["vec"], grad=grad)
    with torch.enable_grad() if grad else torch.no_grad():
        got_out = tfn(txs, tvec)
    triples = [(f"out {i}", g, w) for i, (g, w) in enumerate(zip(got_out, want_out))]
    if grad:
        cots = [rng.standard_normal(w.shape) for w in want_out]
        want_x, want_vec = pull(tuple(_j(c) for c in cots))
        got = torch.autograd.grad(got_out, [*txs.values(), tvec], [_t(c) for c in cots])
        triples += [(f"d{k}", g, want_x[k]) for k, g in zip(txs, got)] + [("dvec", got[-1], want_vec)]
    return triples


@pytest.mark.parametrize("kind", ["double", "single"])
@pytest.mark.parametrize("layout, grad", [("interleaved", True), ("half", True), ("interleaved", False)],
                         ids=["interleaved-autograd", "half-autograd", "interleaved-no_grad"])
def test_blocks_rotate_in_l_and_match_jax(calls, kind, layout, grad):
    """The tiny blocks where the port once rotated with plain passes (the
    interleaved layout on every route, the half one under autograd): kernel
    L takes the tables (twice in a double block, once in a single block),
    no plain rotation runs, and the outputs and gradients match JAX's."""
    for what, got, want in _block_run(kind, layout, grad):
        _assert_rms_close(got, want, what)
    per_block = 2 if kind == "double" else 1
    assert calls == dict(rope_qk=0, flash_mha_rope_plain_rotation=0, flash_mha_rope=0, l_rotating=per_block,
                         l_plain=0), calls


@pytest.mark.parametrize("kind", ["double", "single"])
def test_the_half_layout_without_a_gradient_keeps_kernel_a_route(calls, kind):
    """Serving's route: the half layout with no gradient, which once left
    the rotation to kernel A, now rotates in L as every other route does
    (L takes the tables, twice in a double block, once in a single block);
    kernel A's entry (flash_mha_rope) is not reached and no plain rotation
    runs."""
    for what, got, want in _block_run(kind, "half", False):
        _assert_rms_close(got, want, what)
    per_block = 2 if kind == "double" else 1
    assert calls == dict(rope_qk=0, flash_mha_rope_plain_rotation=0, flash_mha_rope=0, l_rotating=per_block,
                         l_plain=0), calls


def test_the_tiny_dit_under_autograd_in_the_interleaved_layout_matches_jax_vjp(calls):
    """The whole tiny DiT as the trainer runs it (interleaved layout, under
    autograd): the velocity and the gradient of the image tokens against
    jax.vjp of flux_apply; L rotates at every block (2 a double block, 1 a
    single block) and no plain rotation runs."""
    from test_torch_models import _flux_inputs

    cfg, params = _tiny()
    inp = _flux_inputs(cfg, 2, 16, 8, 5, True)
    model = convert.flux_from_jax(_np(params), cfg, device="cpu").requires_grad_(False)
    rest = {k: jnp.asarray(v) for k, v in inp.items() if k != "img"}

    def jfn(img):
        return jax_flux_apply(cfg, params, img=img, **rest, rope_layout="interleaved", attn_impl="xla")

    want, pull = jax.vjp(jfn, jnp.asarray(inp["img"]))
    cot = np.random.default_rng(35).standard_normal(want.shape)
    img = _t(inp["img"], grad=True)
    got = model(img=img, **{k: torch.from_numpy(np.array(v)) for k, v in inp.items() if k != "img"},
                rope_layout="interleaved")
    (dimg,) = torch.autograd.grad(got, [img], [_t(cot)])
    _assert_rms_close(got, want, "velocity")
    _assert_rms_close(dimg, pull(_j(cot))[0], "dimg")
    assert calls == dict(rope_qk=0, flash_mha_rope_plain_rotation=0, flash_mha_rope=0,
                         l_rotating=2 * cfg.depth + cfg.depth_single_blocks, l_plain=0), calls


def test_calibration_keeps_the_plain_rotation(calls):
    """collect_stats (calibration) runs the blocks' plain code: no kernel L,
    and the interleaved layout rotates in attention's rope_qk."""
    cfg, params = _tiny()
    _, inp = _block_inputs(cfg)
    model = convert.flux_from_jax(_np(params), cfg, device="cpu")
    tpe = embed_nd(_t(inp["ids"]), cfg.axes_dim, cfg.theta)
    with torch.no_grad():
        model.single_blocks[0](_t(np.concatenate([inp["txt"], inp["img"]], axis=1)), _t(inp["vec"]), tpe,
                               torch.from_numpy(inp["mask"]), rope_layout="interleaved", collect_stats=True)
    assert calls["rope_qk"] == 2 and calls["l_rotating"] == calls["l_plain"] == 0, calls


# ----------------------------- the bias in G's and G4's epilogues -----------------------------


def _int8_case(rng, m, k, n):
    x = _t(rng.standard_normal((m, k)), BF16)
    w = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8))
    scale = _t(rng.uniform(0.5, 1.5, (n,)) * k ** -0.5 / 127)
    return x, w, scale


@pytest.mark.parametrize("m", [1, 7, 130])
def test_g_plain_with_a_bias_is_the_unbiased_plain_plus_the_bf16_add(m):
    """Kernel G's plain version with a bias (N,) equals its bias-less plain
    version followed by `y + b` in bf16 bit for bit, for a bf16 and an
    fp32 bias (the wrapper's CPU route is the plain version)."""
    rng = np.random.default_rng(36 + m)
    x, w, scale = _int8_case(rng, m, 64, 48)
    for bias in (_t(rng.standard_normal(48) * 3, BF16), _t(rng.standard_normal(48) * 3)):
        want = int8_matmul_plain(x, w, scale) + bias.to(BF16)
        assert torch.equal(int8_matmul_plain(x, w, scale, bias=bias), want)
        assert torch.equal(int8_matmul(x, w, scale, bias=bias), want)


@pytest.mark.parametrize("m", [1, 7, 130])
def test_g4_plain_with_a_bias_is_the_unbiased_plain_plus_the_bf16_add(m):
    """Kernel G4's plain version with a bias, as G's."""
    rng = np.random.default_rng(46 + m)
    x = _t(rng.standard_normal((m, 128)), BF16)
    w4 = torch.from_numpy(rng.integers(0, 256, (64, 48), dtype=np.uint8))
    scale = _t(rng.uniform(0.5, 1.5, (2, 48)) * 128 ** -0.5 / 7)
    bias = _t(rng.standard_normal(48) * 3, BF16)
    want = int4_matmul_plain(x, w4, scale) + bias
    assert torch.equal(int4_matmul_plain(x, w4, scale, bias=bias), want)
    assert torch.equal(int4_matmul(x, w4, scale, bias=bias), want)


def test_a_bias_with_an_fp32_output_is_refused():
    """The kernels add the bias to a bf16 output only; the plain versions
    refuse an fp32 one too (no silent second rounding order)."""
    rng = np.random.default_rng(56)
    x, w, scale = _int8_case(rng, 3, 64, 16)
    bias = _t(rng.standard_normal(16), BF16)
    with pytest.raises(ValueError, match="bf16 output only"):
        int8_matmul(x, w, scale, torch.float32, bias)
    w4 = torch.from_numpy(rng.integers(0, 256, (32, 16), dtype=np.uint8))
    with pytest.raises(ValueError, match="bf16 output only"):
        int4_matmul(x, w4, _t(rng.uniform(0.5, 1.5, (1, 16))), torch.float32, bias)


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (8 significant bits; the smallest normal's below it)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(np.asarray(a, np.float64)), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("m", [1, 9])
def test_int8_linear_with_its_bias_matches_jax_linear(m):
    """Int8Linear (the bias through G's plain version) against JAX's
    `linear` on quantize_linear_int8's entry with "b": each output within
    one bf16 ulp of the exact product (JAX rounds its dot to bf16 before
    the rescale, the port once after it) plus one of the output (the bias
    add's own rounding), as tests/test_torch_quant.py holds it."""
    from visualcloze_tpu.models import quant as jq

    from visualcloze_tpu_torch.models.layers import Int8Linear

    rng = np.random.default_rng(57 + m)
    k, n = 96, 80
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    q = jq.quantize_linear_int8({"w": jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32),
                                 "b": jnp.asarray(rng.standard_normal((n,)) * 0.5, jnp.float32)})
    want = _f32(jl.linear(q, jnp.asarray(x)))
    lin = Int8Linear(k, n).requires_grad_(False)
    for key, val in q.items():
        getattr(lin, "bias" if key == "b" else key).copy_(torch.from_numpy(np.array(val)))
    got = _f32(lin(_t(x)))
    xb = _f32(_t(x, BF16)).astype(np.float64)
    prod = xb @ (np.asarray(q["w_int8"], np.float64) * np.asarray(q["w_scale"], np.float64))
    assert got.shape == want.shape and bool(np.all(np.abs(got - want) <= _bf16_ulp(prod) + _bf16_ulp(want)))


def test_int4_dit_linear_with_its_bias_matches_jax_linear():
    """Int4DiTLinear (the bias through G4's plain version) against JAX's
    `linear` on quantize_weight_int4's entry with "b": the same dequantized
    weights, within two bf16 ulps of the largest output (the product's
    rounding and the bias add's), as tests/test_torch_int4.py holds it."""
    from visualcloze_tpu.models import quant as jq

    from visualcloze_tpu_torch.models.layers import Int4DiTLinear

    rng = np.random.default_rng(58)
    k, n = 256, 48
    entry = dict(jq.quantize_weight_int4(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.1)),
                 b=jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.5))
    x = rng.standard_normal((5, k)).astype(np.float32)
    want = _f32(jl.linear(entry, jnp.asarray(x)))
    lin = Int4DiTLinear(k, n).requires_grad_(False)
    for key, val in entry.items():
        getattr(lin, "bias" if key == "b" else key).copy_(torch.from_numpy(np.array(val)))
    got = _f32(lin(_t(x)))
    assert got.shape == want.shape and np.abs(got - want).max() <= 2 * _bf16_ulp(np.abs(want).max())
