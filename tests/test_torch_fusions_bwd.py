"""The backward of the DiT blocks' fused passes (visualcloze_tpu_torch/ops/
block_fusions.py: the Functions LayerNormModulate, GatedResidual,
QKNormSplit and MergeHeads, whose backward is kernel J', K', L' or M', the
plain backward on the CPU) against jax.vjp of the JAX package's chains, for
every input's cotangent; then the tiny double block, single block and final
layer under autograd, through the Functions, against jax.vjp of
`double_block`, `single_block` and `last_layer` (the inputs, vec, the LoRA
leaves and the q/k scales), and Flux.forward_cfg against flux_apply_cfg.

Bounds: in fp32, max |Δ| <= 1e-5 of the largest gradient; in bf16 one bf16
ulp at the largest gradient (tests/test_torch_fusions.py's bound for the
forwards) for what rounds to bf16 -- K's dy equals JAX bit for bit -- and
1e-5 for the fp32 column sums (dshift, dscale, dgate); the q/k scales'
bf16 gradients, sums over every token and head, within one bf16 ulp of
JAX's vjp of the fp32 chain on the same values (JAX's bf16 vjp rounds each
product and sums in bf16, 2 ulps off here; the port sums in fp32 and
rounds once); the blocks and the final layer 1e-4 of each gradient's RMS
(fp32); forward_cfg 1e-4 of the output's RMS, as tests/test_flux.py holds
flux_apply_cfg. M's bf16 gelu gradient is held against JAX's vjp of the
fp32 gelu rounded once (PyTorch's bf16 gelu backward computes in fp32 and
rounds once; JAX's bf16 gelu rounds after each of its operations).
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
from visualcloze_tpu.models.flux import flux_apply_cfg, init_flux
from visualcloze_tpu.models.lora import init_lora as jax_init_lora
from visualcloze_tpu.models.lora import randomize_lora_b
from visualcloze_tpu.ops.rope import embed_nd as jax_embed_nd
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.ops import block_fusions as bf
from visualcloze_tpu_torch.ops.rope import embed_nd

F32, BF16 = torch.float32, torch.bfloat16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}


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


def _grads(outs, ins, cots):
    return torch.autograd.grad(outs, ins, cots)


# ----------------------------- each chain against jax.vjp -----------------------------


@pytest.mark.parametrize("x_dtype, out_dtype, strided", [(F32, F32, False), (BF16, F32, False),
                                                          (BF16, BF16, False), (BF16, BF16, True)])
def test_layernorm_modulate_bwd_matches_jax_vjp(x_dtype, out_dtype, strided):
    """J': dx, dshift, dscale of (1 + scale) * layer_norm(x) + shift (as
    out_dtype); strided: x the rows after 3 others of each batch element
    (the final layer's image tokens). The Function calls J once and J' once."""
    rng = np.random.default_rng(10)
    skip = 3 if strided else 0
    x = rng.standard_normal((2, skip + 7, 64)) * 3.0 + 1.0
    shift, scale = (rng.standard_normal((2, 1, 64)) * 0.5 for _ in range(2))
    dy = rng.standard_normal((2, 7, 64))

    def fn(x, shift, scale):
        return ((1.0 + scale) * jl.layer_norm(x[:, skip:]) + shift).astype(JAX_DTYPE[out_dtype])

    want = jax.vjp(fn, _j(x, x_dtype), _j(shift), _j(scale))[1](_j(dy, out_dtype))
    xt, st, ct = _t(x, x_dtype, True), _t(shift, grad=True), _t(scale, grad=True)
    y = bf.apply_layernorm_modulate(xt[:, skip:], st, ct, out_dtype)
    assert y.dtype == out_dtype and type(y.grad_fn).__name__ == "LayerNormModulateBackward"
    got = _grads(y, (xt, st, ct), _t(dy, out_dtype))
    assert got[0].dtype == x_dtype and got[1].dtype == got[2].dtype == F32
    _assert_close(got[0], want[0], x_dtype, "dx")
    for g, w, what in zip(got[1:], want[1:], ("dshift", "dscale")):
        _assert_close(g, w, F32, what)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gated_residual_bwd_matches_jax_vjp(dtype):
    """K': dx (dout itself), dgate, dy of x + (gate * y.astype(f32)).astype(x.dtype);
    in bf16 dy equals JAX bit for bit."""
    rng = np.random.default_rng(11)
    x, y, dout = (rng.standard_normal((2, 7, 64)) * 2.0 for _ in range(3))
    gate = rng.standard_normal((2, 1, 64))

    def fn(x, gate, y):
        return x + (gate * y.astype(jnp.float32)).astype(x.dtype)

    want = jax.vjp(fn, _j(x, dtype), _j(gate), _j(y, dtype))[1](_j(dout, dtype))
    ins = (_t(x, dtype, True), _t(gate, grad=True), _t(y, dtype, True))
    out = bf.apply_gated_residual(*ins)
    d = _t(dout, dtype)
    got = _grads(out, ins, d)
    assert torch.equal(got[0], d)
    _assert_close(got[1], want[1], F32, "dgate")
    if dtype == BF16:
        np.testing.assert_array_equal(_f32(got[2]), _f32(want[2]))
    else:
        _assert_close(got[2], want[2], dtype, "dy")


def _qk_chain(x, qs, ks, heads):
    q, k, v = jl._split_heads(x, heads)
    q, k = jl.qk_norm({"q_scale": qs, "k_scale": ks}, q, k, v)
    return q, k, v


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_qk_norm_split_bwd_matches_jax_vjp_for_the_joint_streams(dtype):
    """L': the double block's joint Function over a 5-token txt stream and a
    9-token img stream (L twice forward, L' twice backward): each stream's
    dqkv and its q/k scales' gradients against jax.vjp of _split_heads +
    qk_norm of each stream concatenated on the token axis."""
    rng = np.random.default_rng(12)
    heads, d = 2, 16
    xs = [rng.standard_normal((2, n, 3 * heads * d)) * 2.0 for n in (5, 9)]
    scales = [rng.uniform(0.5, 1.5, (d,)) for _ in range(4)]
    cots = [rng.standard_normal((2, heads, 14, d)) for _ in range(3)]

    def fn(x0, qs0, ks0, x1, qs1, ks1):
        parts = [_qk_chain(x0, qs0, ks0, heads), _qk_chain(x1, qs1, ks1, heads)]
        return tuple(jnp.concatenate(ts, axis=2) for ts in zip(*parts))

    primals = [_j(xs[0], dtype), _j(scales[0], dtype), _j(scales[1], dtype),
               _j(xs[1], dtype), _j(scales[2], dtype), _j(scales[3], dtype)]
    want = jax.vjp(fn, *primals)[1](tuple(_j(c, dtype) for c in cots))
    # the scales' sums against the fp32 chain on the same values (JAX's bf16 vjp rounds each product and sums
    # in bf16; the port's sum runs in fp32 and rounds once)
    want32 = jax.vjp(fn, *[p.astype(jnp.float32) for p in primals])[1](
        tuple(_j(c, dtype).astype(jnp.float32) for c in cots))
    ins = [_t(xs[0], dtype, True), _t(scales[0], dtype, True), _t(scales[1], dtype, True),
           _t(xs[1], dtype, True), _t(scales[2], dtype, True), _t(scales[3], dtype, True)]
    calls = []
    bwd = bf.qk_norm_split_bwd
    try:
        bf.qk_norm_split_bwd = lambda *a, **k: calls.append(a[7]) or bwd(*a, **k)
        q, k, v, rest = bf.apply_qk_norm_split([ins[:3], ins[3:]], heads, 3 * heads * d)
        assert rest is None and q.shape == (2, heads, 14, d)
        got = _grads((q, k, v), ins, tuple(_t(c, dtype) for c in cots))
    finally:
        bf.qk_norm_split_bwd = bwd
    assert calls == [0, 5]  # one L' a stream, at its token offset
    for i, (g, w) in enumerate(zip(got, want)):
        if i % 3 == 0:
            _assert_close(g, w, dtype, f"dqkv {i}")
        else:
            _assert_close(g, w if dtype == F32 else want32[i], dtype, f"dscale {i}")


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_qk_norm_split_bwd_passes_the_gelu_half_through(dtype):
    """The single block's Function over linear1's whole output h (3 H D + 24
    columns): q, k, v and h's last 24 columns as a fourth output; h's
    gradient holds L''s dqkv in its first columns and that output's
    cotangent in the rest."""
    rng = np.random.default_rng(13)
    heads, d, g = 2, 16, 24
    h = rng.standard_normal((2, 6, 3 * heads * d + g)) * 2.0
    qs, ks = (rng.uniform(0.5, 1.5, (d,)) for _ in range(2))
    cots = [rng.standard_normal((2, heads, 6, d)) for _ in range(3)] + [rng.standard_normal((2, 6, g))]

    def fn(h):
        return (*_qk_chain(h[..., : 3 * heads * d], _j(qs, dtype), _j(ks, dtype), heads), h[..., 3 * heads * d:])

    want = jax.vjp(fn, _j(h, dtype))[1](tuple(_j(c, dtype) for c in cots))[0]
    ht = _t(h, dtype, True)
    out = bf.apply_qk_norm_split([(ht, _t(qs, dtype), _t(ks, dtype))], heads, 3 * heads * d)
    assert out[3]._base is ht and type(out[3].grad_fn).__name__ == "QKNormSplitBackward"
    (got,) = _grads(out, (ht,), tuple(_t(c, dtype) for c in cots))
    _assert_close(got, want, dtype, "dh")
    np.testing.assert_array_equal(_f32(got[..., 3 * heads * d:]), cots[3].astype(np.float32) if dtype == F32
                                  else _f32(_t(cots[3], dtype)))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("with_gelu", [False, True])
def test_merge_heads_bwd_matches_jax_vjp(dtype, with_gelu):
    """M': dx (padded rows zero) and the gelu input's gradient of
    concatenate([merge(x) * mask, gelu(g, approximate=True)]), g a strided
    view (linear1's last columns)."""
    rng = np.random.default_rng(14)
    b, heads, length, d, g = 2, 2, 6, 16, 24
    x = rng.standard_normal((b, heads, length, d))
    mask = np.ones((b, length), np.int32)
    mask[1, 4:] = 0
    h = rng.standard_normal((b, length, 40 + g)) * 3.0
    dout = rng.standard_normal((b, length, heads * d + (g if with_gelu else 0)))

    def merge(x):
        return jnp.swapaxes(x, 1, 2).reshape(b, length, heads * d) * jnp.asarray(mask)[..., None].astype(x.dtype)

    want_dx = jax.vjp(merge, _j(x, dtype))[1](_j(dout[..., : heads * d], dtype))[0]
    xt, ht = _t(x, dtype, True), _t(h, dtype, True)
    out = bf.apply_merge_heads(xt, torch.from_numpy(mask), ht[..., 40:] if with_gelu else None)
    ins = (xt, ht) if with_gelu else (xt,)
    got = _grads(out, ins, _t(dout, dtype))
    np.testing.assert_array_equal(_f32(got[0]), _f32(want_dx))
    assert not bool(got[0][1, :, 4:].any())
    if with_gelu:
        # JAX's vjp of the fp32 gelu, rounded once to the working dtype (PyTorch's bf16 gelu backward)
        dg = jax.vjp(lambda t: jax.nn.gelu(t, approximate=True), _j(h, dtype)[..., 40:].astype(jnp.float32))[1](
            _j(dout[..., heads * d:], dtype).astype(jnp.float32))[0].astype(JAX_DTYPE[dtype])
        assert not bool(got[1][..., :40].any())
        _assert_close(got[1][..., 40:], dg, dtype, "dg")


def test_the_single_block_gradient_of_linear1_is_one_buffer():
    """L' and M' write linear1's output gradient into one (B, L, W) buffer:
    the tensor the single block's h receives is M''s gelu-gradient buffer,
    completed in place by L' (no copy, no sum)."""
    rng = np.random.default_rng(15)
    heads, d, g = 2, 16, 24
    h = _t(rng.standard_normal((2, 6, 3 * heads * d + g)), grad=True)
    scales = (torch.ones(d), torch.ones(d))
    seen = {}
    mbwd = bf.merge_heads_bwd
    try:
        def recording(*args, **kwargs):
            dx, dg = mbwd(*args, **kwargs)
            seen["dg"] = dg
            return dx, dg

        bf.merge_heads_bwd = recording
        linear1_out = h * 1.0
        grads = []
        linear1_out.register_hook(grads.append)
        q, k, v, mlp_h = bf.apply_qk_norm_split([(linear1_out, *scales)], heads, 3 * heads * d)
        out = bf.apply_merge_heads(q + k + v, None, mlp_h)
        out.sum().backward()
    finally:
        bf.merge_heads_bwd = mbwd
    (dh,) = grads
    assert dh.shape == h.shape and dh.untyped_storage().data_ptr() == seen["dg"].untyped_storage().data_ptr()
    assert dh.data_ptr() + 3 * heads * d * dh.element_size() == seen["dg"].data_ptr()


# ----------------------------- the blocks under autograd -----------------------------


_jax_double_block = jax.jit(jl.double_block, static_argnames=("cfg", "attn_impl", "rope_layout"))
_jax_single_block = jax.jit(jl.single_block, static_argnames=("cfg", "attn_impl", "rope_layout"))


@functools.lru_cache(maxsize=None)
def _tiny_params_and_lora(seed: int):
    cfg = FluxConfig().tiny()
    params = init_flux(jax.random.PRNGKey(seed), cfg)
    lora = randomize_lora_b(jax_init_lora(jax.random.PRNGKey(seed + 1), params, rank=4),
                            jax.random.PRNGKey(seed + 2), scale=0.05)
    return cfg, params, lora


def _block_inputs(cfg, padded: bool, seed: int = 16):
    rng = np.random.default_rng(seed)
    b, l_txt, side = 2, 8, 4
    l_img = side * side
    ids = np.zeros((b, l_txt + l_img, 3), np.float32)
    ids[:, l_txt:, 0] = 1
    ids[:, l_txt:, 1] = np.arange(l_img) // side
    ids[:, l_txt:, 2] = np.arange(l_img) % side
    mask = None
    if padded:
        mask = np.ones((b, l_txt + l_img), np.int32)
        mask[0, -5:] = 0
        mask[1, l_txt // 2:l_txt] = 0
    return dict(img=rng.standard_normal((b, l_img, cfg.hidden_size)), txt=rng.standard_normal(
        (b, l_txt, cfg.hidden_size)), vec=rng.standard_normal((b, cfg.hidden_size)), ids=ids, mask=mask,
        rng=rng)


def _leaves(tree, prefix=()):
    """(path, leaf) of a nested dict, sorted by path."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _assert_grads_close(got, want, what):
    """fp32: max |Δ| <= 1e-4 of the gradient's RMS."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert rms > 0, what
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * rms, (what, err / rms)


def _block_case(kind: str, padded: bool):
    """jax.vjp of one tiny block (or the final layer) and the port's block
    under autograd on the same inputs, LoRA and cotangents: the gradients of
    the inputs, vec, every LoRA leaf and the q/k scales, as (name, got,
    want) triples, and the backward wrappers' calls."""
    cfg, params, lora = _tiny_params_and_lora(2)
    inp = _block_inputs(cfg, padded)
    rng = inp.pop("rng")
    pe = jax_embed_nd(jnp.asarray(inp["ids"]), cfg.axes_dim, cfg.theta)
    tpe = embed_nd(_t(inp["ids"]), cfg.axes_dim, cfg.theta)
    mask = None if inp["mask"] is None else jnp.asarray(inp["mask"])
    tmask = None if inp["mask"] is None else torch.from_numpy(inp["mask"])
    model = convert.flux_from_jax(_np(params), cfg, device="cpu")
    tlora = convert.lora_from_jax(_np(lora), cfg, device="cpu")
    if kind == "double":
        p, jlora = (jax.tree.map(lambda a: a[0], t["double_blocks"]) for t in (params, lora))
        block, blora = model.double_blocks[0], tlora["double_blocks"][0]
        norms = {"img_attn": block.img_attn.norm, "txt_attn": block.txt_attn.norm}
        xs = {"img": inp["img"], "txt": inp["txt"]}
    elif kind == "single":
        p, jlora = (jax.tree.map(lambda a: a[0], t["single_blocks"]) for t in (params, lora))
        block, blora = model.single_blocks[0], tlora["single_blocks"][0]
        norms = {"": block.norm}
        xs = {"x": np.concatenate([inp["txt"], inp["img"]], axis=1)}
    else:
        p, jlora = params["final_layer"], lora["final_layer"]
        block, blora = model.final_layer, tlora["final_layer"]
        norms = {}
        whole = np.concatenate([inp["txt"], inp["img"]], axis=1)
        xs = {"x": whole}
    model.requires_grad_(False)
    scale_keys = [(k, s) for k in norms for s in ("q_scale", "k_scale")]

    def with_scales(p, scales):
        p = jax.tree.map(lambda a: a, p)
        for (k, s), val in zip(scale_keys, scales):
            (p[k]["norm"] if k else p["norm"])[s] = val
        return p

    def jfn(xs_j, vec, lo, scales):
        pp = with_scales(p, scales)
        if kind == "double":
            return _jax_double_block(cfg=cfg, p=pp, img=xs_j["img"], txt=xs_j["txt"], vec=vec, pe=pe,
                                     attn_mask=mask, lora=lo, attn_impl="xla", rope_layout="interleaved")
        if kind == "single":
            return _jax_single_block(cfg=cfg, p=pp, x=xs_j["x"], vec=vec, pe=pe, attn_mask=mask, lora=lo,
                                     attn_impl="xla", rope_layout="interleaved")
        return jl.last_layer(pp, xs_j["x"][:, 8:], vec, lo)

    jscales = [((p[k]["norm"] if k else p["norm"])[s]) for k, s in scale_keys]
    jxs = {k: _j(v) for k, v in xs.items()}
    want_out, pull = jax.vjp(jfn, jxs, _j(inp["vec"]), jlora, jscales)
    cots = jax.tree.map(lambda o: rng.standard_normal(o.shape), want_out)
    want = pull(jax.tree.map(lambda c: _j(c), cots))

    txs = {k: _t(v, grad=True) for k, v in xs.items()}
    vec = _t(inp["vec"], grad=True)
    lleaves = list(_leaves(blora))
    for _, t in lleaves:
        t.requires_grad_()
    tscales = [getattr(norms[k], s).requires_grad_() for k, s in scale_keys]
    calls = {name: 0 for name in ("layernorm_modulate_bwd", "gated_residual_bwd", "qk_norm_split_bwd",
                                  "merge_heads_bwd")}
    saved = {name: getattr(bf, name) for name in calls}

    def recording(name):
        def run(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return run

    try:
        for name in calls:
            setattr(bf, name, recording(name))
        if kind == "double":
            out = block(txs["img"], txs["txt"], vec, tpe, tmask, blora, rope_layout="interleaved")
        elif kind == "single":
            out = block(txs["x"], vec, tpe, tmask, blora, rope_layout="interleaved")
        else:
            out = block(txs["x"][:, 8:], vec, blora)
        outs = out if isinstance(out, tuple) else (out,)
        jouts = want_out if isinstance(want_out, tuple) else (want_out,)
        for o, w in zip(outs, jouts):
            rms = float(np.sqrt(np.mean(_f32(w) ** 2)))
            assert float(np.abs(_f32(o) - _f32(w)).max()) <= 1e-4 * rms
        tcots = tuple(_t(c) for c in (cots if isinstance(cots, tuple) else (cots,)))
        ins = [*txs.values(), vec, *[t for _, t in lleaves], *tscales]
        got = _grads(outs, ins, tcots)
    finally:
        for name, fn in saved.items():
            setattr(bf, name, fn)
    want_x, want_vec, want_lora, want_scales = want
    triples = [(k, g, want_x[k]) for k, g in zip(txs, got)]
    triples.append(("vec", got[len(txs)], want_vec))
    jleaves = dict(_leaves(want_lora))
    for (path, _), g in zip(lleaves, got[len(txs) + 1:]):
        triples.append((".".join(path), g, jleaves[path] if path in jleaves else None))
    for (k, s), g, w in zip(scale_keys, got[len(got) - len(tscales):], want_scales):
        triples.append((f"{k}.{s}", g, w))
    return triples, calls


@pytest.mark.parametrize("kind, padded", [("double", False), ("double", True), ("single", False),
                                          ("single", True), ("final", False)])
def test_block_gradients_match_jax_vjp_through_the_functions(kind, padded):
    """The tiny double block (J 4, K 4, L 2, M 1: as many J'-M' launches), the
    single block (1 each) and the final layer (J once) under autograd with
    a random-B LoRA, in the trainer's interleaved RoPE layout: every
    input's, vec's, LoRA leaf's and q/k scale's gradient within 1e-4 of its
    RMS of jax.vjp's."""
    triples, calls = _block_case(kind, padded)
    per_block = {"double": (4, 4, 2, 1), "single": (1, 1, 1, 1), "final": (1, 0, 0, 0)}[kind]
    assert tuple(calls.values()) == per_block, calls
    names = [name for name, _, _ in triples]
    assert len(names) > 3 and len(set(names)) == len(names)
    for name, got, want in triples:
        if want is None:  # a LoRA leaf the JAX tree lacks would be a converter bug
            raise AssertionError(f"{name} has no JAX counterpart")
        if not np.any(_f32(want)):  # e.g. a leaf whose cotangent is 0 by construction
            assert not np.any(_f32(got)), name
            continue
        _assert_grads_close(got, want, name)


# ----------------------------- classifier-free guidance -----------------------------


def test_forward_cfg_matches_flux_apply_cfg():
    """Flux.forward_cfg at b = 2 ([cond | uncond]) against flux_apply_cfg:
    both halves within 1e-4 of the RMS, the guided half equal to uncond +
    s * (cond - uncond) of the port's own forward."""
    from test_torch_models import _flux_inputs

    cfg, params, _ = _tiny_params_and_lora(2)
    inp = _flux_inputs(cfg, 2, 64, 16, 5, False)
    want = np.asarray(flux_apply_cfg(cfg, params, 2.0, **{k: jnp.asarray(v) for k, v in inp.items()},
                                     rope_layout="half", attn_impl="xla"))
    model = convert.flux_from_jax(_np(params), cfg, device="cpu")
    args = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    with torch.no_grad():
        got = model.forward_cfg(cfg_scale=2.0, **args)
        plain = model(**args)
    assert got.shape == (2, 64, cfg.out_channels)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * rms
    cond, uncond = plain.chunk(2)
    assert torch.equal(got[1:], uncond) and torch.equal(got[:1], uncond + 2.0 * (cond - uncond))
