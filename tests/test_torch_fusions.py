"""Kernels J, K, L and M of the DiT blocks (visualcloze_tpu_torch/ops/
block_fusions.py) against the JAX package's XLA-fused code: each plain
version against its JAX counterpart, then the tiny double and single blocks
and the whole tiny DiT against JAX's, on both routes -- the no-grad forward
through the four wrappers (their plain versions on the CPU; recorded here),
and under autograd through their Functions, whose forward is the same
wrapper and whose backward is the backward wrapper of J', K', L' or M'
(recorded too; tests/test_torch_fusions_bwd.py holds the gradients against
JAX's). Also the port's pack_sequences against JAX's.

Bounds: in fp32, max |Δ| <= 1e-5 of the largest output (the blocks and the
DiT: 1e-4 of the output RMS, as tests/test_torch_models.py holds the DiT).
In bf16, one bf16 ulp at the largest output: J, L and M's gelu round
fp32 values computed in another order or by another library (JAX and
PyTorch round bf16 gelu(tanh) differently, ROADMAP's framework
differences; reading on 640 N(0, 9) values: 46% of the elements differ, by
at most 0.0156 at a largest output of 9.19, a quarter of its ulp); K and M's
merge equal JAX bit for bit.
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
from visualcloze_tpu.ops.packing import pack_sequences as jax_pack_sequences
from visualcloze_tpu.ops.rope import embed_nd as jax_embed_nd
from visualcloze_tpu_torch import convert
from visualcloze_tpu_torch.ops import block_fusions as bf
from visualcloze_tpu_torch.ops.packing import pack_sequences
from visualcloze_tpu_torch.ops.rope import embed_nd

F32, BF16 = torch.float32, torch.bfloat16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}
FUSIONS = ("layernorm_modulate", "gated_residual", "qk_norm_split", "merge_heads")
BACKWARDS = tuple(f"{name}_bwd" for name in FUSIONS)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Tiny ops: one intra-op thread under several test workers, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=F32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=F32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JAX_DTYPE[dtype])


def _f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, want, dtype):
    """fp32: max |Δ| <= 1e-5 of the largest |want|; bf16: one bf16 ulp there."""
    got, want = _f32(got), _f32(want)
    top = float(np.abs(want).max())
    tol = 1e-5 * top if dtype == F32 else 2.0 ** (math.floor(math.log2(top)) - 7)
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("x_dtype, out_dtype", [(F32, F32), (BF16, F32), (BF16, BF16)])
def test_layernorm_modulate_plain_matches_jax(x_dtype, out_dtype):
    """J: (1 + scale) * layer_norm(x) + shift, as double_block (fp32 out) and
    single_block (.astype(x.dtype)) compute it."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)) * 3.0 + 1.0
    shift, scale = (rng.standard_normal((2, 1, 64)) * 0.5 for _ in range(2))
    want = ((1.0 + _j(scale)) * jl.layer_norm(_j(x, x_dtype)) + _j(shift)).astype(JAX_DTYPE[out_dtype])
    got = bf.layernorm_modulate(_t(x, x_dtype), _t(shift), _t(scale), out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 7, 64)
    _assert_close(got, want, out_dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gated_residual_plain_matches_jax(dtype):
    """K: x + (gate * y.astype(f32)).astype(x.dtype); bit for bit in bf16."""
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal((2, 7, 64)) * 2.0 for _ in range(2))
    gate = rng.standard_normal((2, 1, 64))
    want = _j(x, dtype) + (_j(gate) * _j(y, dtype).astype(jnp.float32)).astype(JAX_DTYPE[dtype])
    got = bf.gated_residual(_t(x, dtype), _t(gate), _t(y, dtype))
    assert got.dtype == dtype
    if dtype == BF16:
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_qk_norm_split_plain_matches_jax_at_an_offset_into_a_joint_buffer(dtype):
    """L: _split_heads + qk_norm of a strided qkv (the first 3 H D columns of
    a wider projection, as linear1's), written at token 4 of a 12-token joint
    buffer; the other tokens stay as they were."""
    rng = np.random.default_rng(2)
    heads, d, length, offset = 2, 16, 5, 4
    h = rng.standard_normal((2, length, 3 * heads * d + 40)) * 2.0
    q_scale, k_scale = (rng.uniform(0.5, 1.5, (d,)) for _ in range(2))
    jq, jk, jv = jl._split_heads(_j(h, dtype)[..., : 3 * heads * d], heads)
    jq, jk = jl.qk_norm({"q_scale": _j(q_scale, dtype), "k_scale": _j(k_scale, dtype)}, jq, jk, jv)
    ht = _t(h, dtype)
    bufs = bf.qkv_buffers(ht[..., : 3 * heads * d], heads, 12)
    for b in bufs:
        b.fill_(7.0)
    out = bf.qk_norm_split(ht[..., : 3 * heads * d], _t(q_scale, dtype), _t(k_scale, dtype), heads, bufs, offset)
    assert all(o is b for o, b in zip(out, bufs)) and bufs[0].shape == (2, heads, 12, d)
    for got, want in zip(bufs, (jq, jk, jv)):
        _assert_close(got[:, :, offset:offset + length], want, dtype)
        rest = torch.cat([got[:, :, :offset], got[:, :, offset + length:]], dim=2)
        assert bool((rest == 7.0).all())
    np.testing.assert_array_equal(_f32(bufs[2][:, :, offset:offset + length]), _f32(jv))
    q, k, v = bf.qk_norm_split(ht[..., : 3 * heads * d], _t(q_scale, dtype), _t(k_scale, dtype), heads)
    assert torch.equal(q, bufs[0][:, :, offset:offset + length]) and v.shape == (2, heads, length, d)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("with_gelu", [False, True])
def test_merge_heads_plain_matches_jax(dtype, with_gelu):
    """M: attention()'s head merge with padded query rows zeroed, and in the
    single block concatenate([attn, gelu(mlp_h, approximate=True)]) with
    mlp_h a strided view (linear1's last columns)."""
    rng = np.random.default_rng(3)
    b, heads, length, d, g = 2, 2, 6, 16, 24
    x = rng.standard_normal((b, heads, length, d))
    mask = np.ones((b, length), np.int32)
    mask[1, 4:] = 0
    h = rng.standard_normal((b, length, 40 + g)) * 3.0
    jx = _j(x, dtype)
    want = jnp.swapaxes(jx, 1, 2).reshape(b, length, heads * d) * jnp.asarray(mask)[..., None].astype(jx.dtype)
    gelu = None
    if with_gelu:
        want = jnp.concatenate([want, jax.nn.gelu(_j(h, dtype)[..., 40:], approximate=True)], axis=-1)
        gelu = _t(h, dtype)[..., 40:]
    got = bf.merge_heads(_t(x, dtype), torch.from_numpy(mask), gelu)
    assert got.shape == (b, length, heads * d + (g if with_gelu else 0)) and got.dtype == dtype
    assert bool((got[1, 4:, : heads * d] == 0).all())
    np.testing.assert_array_equal(_f32(got[..., : heads * d]), _f32(want[..., : heads * d]))
    if with_gelu:
        _assert_close(got[..., heads * d:], want[..., heads * d:], dtype)


# ----------------------------- the blocks, both routes -----------------------------


@pytest.fixture
def calls(monkeypatch):
    """Records every call of the four forward wrappers and the four backward
    wrappers (block_fusions' module globals, which the entry points and the
    Functions call), then calls through (the plain versions here)."""
    seen = {name: 0 for name in FUSIONS + BACKWARDS}

    def recording(name):
        fn = getattr(bf, name)

        def wrapper(*args, **kwargs):
            seen[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(bf, name, wrapper)

    for name in FUSIONS + BACKWARDS:
        recording(name)
    return seen


def _forwards(calls) -> dict:
    return {name: calls[name] for name in FUSIONS}


def _backwards(calls) -> dict:
    """The backward wrappers' calls, keyed by their forward's name."""
    return {name: calls[f"{name}_bwd"] for name in FUSIONS}


# the JAX blocks jitted: one compile instead of eager dispatch's per-op compiles
_jax_double_block = jax.jit(jl.double_block, static_argnames=("cfg", "attn_impl", "rope_layout"))
_jax_single_block = jax.jit(jl.single_block, static_argnames=("cfg", "attn_impl", "rope_layout"))


@functools.lru_cache(maxsize=None)
def _tiny_params(seed: int):
    return init_flux(jax.random.PRNGKey(seed), FluxConfig().tiny())


def _tiny(seed: int = 1):
    """The tiny JAX DiT's config and parameters, and a fresh port of them."""
    cfg, params = FluxConfig().tiny(), _tiny_params(seed)
    return cfg, params, convert.flux_from_jax(_np(params), cfg, device="cpu")


def _block_inputs(cfg, padded: bool, seed: int = 6):
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
        (b, l_txt, cfg.hidden_size)), vec=rng.standard_normal((b, cfg.hidden_size)), ids=ids, mask=mask)


def _route(grad: bool, *ts):
    """The tensors as a route gives them to a block: under autograd they
    want a gradient; else under no_grad."""
    if grad:
        return torch.enable_grad(), [t.requires_grad_() for t in ts]
    return torch.no_grad(), list(ts)


def _check_route(calls, grad: bool, per_call: dict, out):
    """Both routes run the forward wrappers per_call times and no backward
    one; under autograd the backward then runs each backward wrapper as often
    as its forward ran."""
    assert _forwards(calls) == per_call and not any(_backwards(calls).values()), calls
    if grad:
        sum(o.float().sum() for o in out).backward()
        assert _backwards(calls) == per_call and _forwards(calls) == per_call, calls


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("padded", [False, True])
def test_double_block_matches_jax_on_both_routes(calls, grad, padded):
    """One tiny double block: J 4, K 4, L 2 (txt, img into one joint
    buffer), M 1 on both routes; under autograd J'-M' as often."""
    cfg, params, model = _tiny()
    inp = _block_inputs(cfg, padded)
    bp = jax.tree.map(lambda a: a[0], params["double_blocks"])
    pe = jax_embed_nd(jnp.asarray(inp["ids"]), cfg.axes_dim, cfg.theta)
    mask = None if inp["mask"] is None else jnp.asarray(inp["mask"])
    want = _jax_double_block(cfg=cfg, p=bp, img=_j(inp["img"]), txt=_j(inp["txt"]), vec=_j(inp["vec"]), pe=pe,
                             attn_mask=mask, attn_impl="xla", rope_layout="half")
    ctx, (img, txt) = _route(grad, _t(inp["img"]), _t(inp["txt"]))
    with ctx:
        got = model.double_blocks[0](img, txt, _t(inp["vec"]), embed_nd(_t(inp["ids"]), cfg.axes_dim, cfg.theta),
                                     None if inp["mask"] is None else torch.from_numpy(inp["mask"]),
                                     rope_layout="half")
    for g, w in zip(got, want):
        rms = float(np.sqrt(np.mean(np.asarray(w) ** 2)))
        assert float(np.abs(g.detach().numpy() - np.asarray(w)).max()) <= 1e-4 * rms
    _check_route(calls, grad, {"layernorm_modulate": 4, "gated_residual": 4, "qk_norm_split": 2,
                               "merge_heads": 1}, got)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("padded", [False, True])
def test_single_block_matches_jax_on_both_routes(calls, grad, padded):
    """One tiny single block: J, K, L and M once each (M writes the gelu half
    of linear2's input too) on both routes; under autograd J'-M' once each."""
    cfg, params, model = _tiny()
    inp = _block_inputs(cfg, padded)
    bp = jax.tree.map(lambda a: a[0], params["single_blocks"])
    x = np.concatenate([inp["txt"], inp["img"]], axis=1)
    pe = jax_embed_nd(jnp.asarray(inp["ids"]), cfg.axes_dim, cfg.theta)
    mask = None if inp["mask"] is None else jnp.asarray(inp["mask"])
    want = np.asarray(_jax_single_block(cfg=cfg, p=bp, x=_j(x), vec=_j(inp["vec"]), pe=pe, attn_mask=mask,
                                        attn_impl="xla", rope_layout="half"))
    ctx, (xt,) = _route(grad, _t(x))
    with ctx:
        got = model.single_blocks[0](xt, _t(inp["vec"]), embed_nd(_t(inp["ids"]), cfg.axes_dim, cfg.theta),
                                     None if inp["mask"] is None else torch.from_numpy(inp["mask"]),
                                     rope_layout="half")
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert float(np.abs(got.detach().numpy() - want).max()) <= 1e-4 * rms
    _check_route(calls, grad, {name: 1 for name in FUSIONS}, [got])


def test_single_block_in_bf16_matches_jax_through_the_wrappers(calls):
    """The bf16 single block on the no-grad route (the card's dtype): within
    the tiny DiT's bf16 bounds of tests/test_torch_quant.py (max |Δ| <= 6e-2,
    mean <= 1.3e-2 of the output RMS: bf16 gelu and the norms round
    differently in the two frameworks)."""
    cfg, params, _ = _tiny()
    params16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    model = convert.flux_from_jax(_np(jax.tree.map(lambda a: a.astype(jnp.float32), params16)), cfg,
                                  device="cpu", dtype=BF16)
    inp = _block_inputs(cfg, True)
    bp = jax.tree.map(lambda a: a[0], params16["single_blocks"])
    x = np.concatenate([inp["txt"], inp["img"]], axis=1)
    pe = jax_embed_nd(jnp.asarray(inp["ids"]), cfg.axes_dim, cfg.theta)
    want = _f32(_jax_single_block(cfg=cfg, p=bp, x=_j(x, BF16), vec=_j(inp["vec"], BF16), pe=pe,
                                  attn_mask=jnp.asarray(inp["mask"]), attn_impl="xla", rope_layout="half"))
    with torch.no_grad():
        got = model.single_blocks[0](_t(x, BF16), _t(inp["vec"], BF16),
                                     embed_nd(_t(inp["ids"]), cfg.axes_dim, cfg.theta),
                                     torch.from_numpy(inp["mask"]), rope_layout="half")
    assert got.dtype == BF16 and _forwards(calls) == {name: 1 for name in FUSIONS}
    d, rms = np.abs(_f32(got) - want), float(np.sqrt(np.mean(want ** 2)))
    assert d.max() <= 6e-2 * rms and d.mean() <= 1.3e-2 * rms, (d.max() / rms, d.mean() / rms)


@pytest.mark.parametrize("padded", [False, True])
def test_dit_no_grad_forward_goes_through_j_k_l_m_and_matches_jax(calls, padded):
    """The whole tiny DiT on the serving route: per evaluation J depth * 4 +
    single + 1 (the final layer), K depth * 4 + single, L depth * 2 +
    single, M depth + single (115, 114, 76, 57 at 19 + 38 blocks); the RoPE
    tables passed in as the serving loop builds them once give the same
    velocity bit for bit; in calibration (collect_a8_stats) none runs."""
    from test_torch_models import _flux_inputs

    cfg, params, model = _tiny()
    inp = _flux_inputs(cfg, 2, 64, 16, 0, padded)
    want = np.asarray(jax_flux_apply(cfg, params, **{k: jnp.asarray(v) for k, v in inp.items()},
                                     rope_layout="half", attn_impl="xla"))
    args = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    with torch.no_grad():
        got = model(**args)
        assert calls == dict(_dit_calls(cfg), **dict.fromkeys(BACKWARDS, 0)), calls
        again = model(**args, pe=model.rope_tables(args["img_ids"], args["txt_ids"]))
        for name in FUSIONS:
            calls[name] = 0
        model(**args, collect_a8_stats=True)
        assert not any(calls.values()), calls
    assert torch.equal(got, again)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * rms


def _dit_calls(cfg) -> dict:
    """J-M's calls in one DiT evaluation (each of J'-M' as often in its backward)."""
    return {"layernorm_modulate": 4 * cfg.depth + cfg.depth_single_blocks + 1,
            "gated_residual": 4 * cfg.depth + cfg.depth_single_blocks,
            "qk_norm_split": 2 * cfg.depth + cfg.depth_single_blocks,
            "merge_heads": cfg.depth + cfg.depth_single_blocks}


def test_dit_routes_by_its_lora_leaves_under_autograd(calls):
    """A LoRA whose leaves want gradients puts every block on the autograd
    route, though the DiT's inputs and weights want none (the trainer's
    case): J-M through their Functions, then J'-M' as often in the
    backward."""
    from test_torch_models import _flux_inputs

    from visualcloze_tpu_torch.models.lora import init_lora, tree_leaves

    cfg, _, model = _tiny()
    model.requires_grad_(False)
    lora = init_lora(model, 2, generator=torch.Generator().manual_seed(0))
    for leaf in tree_leaves(lora):
        leaf.requires_grad_()
    inp = _flux_inputs(cfg, 1, 64, 16, 0, False)
    out = model(**{k: torch.from_numpy(np.array(v)) for k, v in inp.items()}, lora=lora)
    assert _forwards(calls) == _dit_calls(cfg) and not any(_backwards(calls).values()), calls
    out.sum().backward()
    assert _backwards(calls) == _dit_calls(cfg), calls
    assert any(leaf.grad is not None and bool(leaf.grad.abs().sum() > 0) for leaf in tree_leaves(lora))


# ----------------------------- token packing -----------------------------


@pytest.mark.parametrize("pad_to", [None, 32])
def test_pack_sequences_matches_jax(pad_to):
    rng = np.random.default_rng(4)
    lengths = (20, 13, 17)
    tokens = [rng.standard_normal((n, 12)).astype(np.float32) for n in lengths]
    ids = [rng.uniform(0, 9, (n, 3)).astype(np.float32) for n in lengths]
    want = jax_pack_sequences(tokens, ids, pad_to)
    got = pack_sequences([torch.from_numpy(t) for t in tokens], ids, pad_to)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert [g.dtype for g in got] == [F32, F32, torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="shorter"):
        pack_sequences(tokens, ids, pad_to=8)

