"""The port's int4 DiT (models/quant.quantize_flux_int4, layers.Int4DiTLinear
and kernel G4's plain version, ops/int4_matmul.py) against the JAX
package's quantize_flux_int4 and linear's "w_int4" branch, on the CPU.

Bounds, and the reading behind each one that is not exact:
- quantizers, dequantized weights and carried trees: exact (both round half
  to even, both take one fp32 product and one bf16 rounding);
- G4's plain version vs JAX's einsum on the dequantized bf16 weight: 1 bf16
  ulp of the largest output (both sum in fp32 and round once; only the
  order of the sum differs);
- the tiny int4 DiT: the int8 DiT's bound (test_torch_quant._DIT_INT8), for
  the same reason: every quantized linear returns bf16, and the two
  frameworks round bf16 gelu and silu differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcloze_tpu.config import FluxConfig
from visualcloze_tpu.models import quant as jq
from visualcloze_tpu.models.flux import flux_apply as jax_flux_apply
from visualcloze_tpu.models.flux import init_flux
from visualcloze_tpu.models.layers import linear as jax_linear
from visualcloze_tpu_torch import convert, ops
from visualcloze_tpu_torch.models import quant as tq
from visualcloze_tpu_torch.models.layers import Int4DiTLinear, linear_kind
from visualcloze_tpu_torch.ops.int4_matmul import dequant_int4_plain, int4_matmul, int4_matmul_plain


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """Tiny ops: one intra-op thread under several test workers, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(v), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("shape,group", [((256, 96), 128), ((96, 40), 128), ((3, 48, 20), 128), ((6, 8), 128),
                                         ((256, 64), 64), ((512, 32), 256)])
def test_quantize_weight_int4_is_bit_exact(shape, group):
    """Codes and scales, with the group shrunk to divide small input dims
    (96 -> 32, 48 -> 16, 6 -> 2), and the dequantized weight."""
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 0.3
    want = jq.quantize_weight_int4(jnp.asarray(w), group)
    got = tq.quantize_weight_int4(torch.from_numpy(w), group)
    for k in ("w_int4", "w_scale"):
        assert got[k].dtype == {"w_int4": torch.uint8, "w_scale": torch.float32}[k]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    deq = np.asarray(jq.dequant_weight_int4(want).astype(jnp.float32))
    np.testing.assert_array_equal(tq.dequant_weight_int4(got).float().numpy(), deq)
    if len(shape) == 2:
        np.testing.assert_array_equal(dequant_int4_plain(got["w_int4"], got["w_scale"]).float().numpy(), deq)


def test_quantize_flux_int4_matches_jax_tree():
    """The port quantizing its own fp32 Flux gives the JAX tree's codes and
    scales, leaf for leaf; biases and norms are carried as they are."""
    cfg = FluxConfig().tiny()
    params = init_flux(jax.random.PRNGKey(1), cfg)
    want = convert.flux_from_jax(_np(jq.quantize_flux_int4(params)), cfg, device="cpu").state_dict()
    got = tq.quantize_flux_int4(convert.flux_from_jax(_np(params), cfg, device="cpu")).state_dict()
    assert set(got) == set(want)
    for name, val in want.items():
        assert got[name].dtype == val.dtype and torch.equal(got[name], val), name
    n4 = sum(name.endswith("w_int4") for name in got)
    assert n4 == 8 + 10 * cfg.depth + 3 * cfg.depth_single_blocks + 2


@pytest.mark.parametrize("m,k,n,group", [(7, 256, 96, 128), (33, 128, 64, 64), (5, 96, 48, 128)])
def test_int4_matmul_plain_matches_jax_linear(m, k, n, group):
    """G4's plain version vs JAX linear's int4 branch (bias-free): within one
    bf16 ulp of the largest output."""
    rng = np.random.default_rng(m)
    w = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((2, m, k)).astype(np.float32)
    entry = jq.quantize_weight_int4(jnp.asarray(w), group)
    want = np.asarray(jax_linear(entry, jnp.asarray(x)).astype(jnp.float32))
    got = int4_matmul(torch.from_numpy(x), _t(entry["w_int4"]), _t(entry["w_scale"]))
    assert got.dtype == torch.bfloat16 and got.shape == (2, m, n)
    assert np.abs(got.float().numpy() - want).max() <= _bf16_ulp(np.abs(want).max())
    f32 = int4_matmul_plain(torch.from_numpy(x), _t(entry["w_int4"]), _t(entry["w_scale"]), torch.float32)
    assert np.abs(f32.numpy() - want).max() <= _bf16_ulp(np.abs(want).max())


def test_int4_dit_linear_matches_jax_with_bias_and_lora():
    """Int4DiTLinear (bias, LoRA delta in bf16) vs JAX linear on the same
    entry: two bf16 ulps of the largest output (the product's one, the bf16
    add's own)."""
    rng = np.random.default_rng(5)
    k, n, r = 128, 64, 4
    entry = dict(jq.quantize_weight_int4(jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.1)),
                 b=jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.1))
    lora = {"a": rng.standard_normal((k, r)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((r, n)).astype(np.float32) * 0.1}
    x = rng.standard_normal((3, k)).astype(np.float32)
    want = np.asarray(jax_linear(entry, jnp.asarray(x), {kk: jnp.asarray(v) for kk, v in lora.items()}, 0.5),
                      np.float32)
    assert linear_kind(entry) == "int4"
    lin = Int4DiTLinear(k, n)
    with torch.no_grad():
        lin.w_int4.copy_(_t(entry["w_int4"]))
        lin.w_scale.copy_(_t(entry["w_scale"]))
        lin.bias.copy_(_t(entry["b"]))
    got = lin(torch.from_numpy(x), {kk: torch.from_numpy(v) for kk, v in lora.items()}, 0.5).float().detach().numpy()
    assert np.abs(got - want).max() <= 2 * _bf16_ulp(np.abs(want).max())


@pytest.mark.parametrize("padded", [False, True])
def test_dit_int4_matches_jax(padded):
    from test_torch_models import _flux_inputs
    from test_torch_quant import _DIT_INT8

    cfg = FluxConfig().tiny()
    qparams = jq.quantize_flux_int4(init_flux(jax.random.PRNGKey(2), cfg))
    inp = _flux_inputs(cfg, 2, 64, 16, 1, padded)
    want = np.asarray(jax_flux_apply(cfg, qparams, **{k: jnp.asarray(v) for k, v in inp.items()},
                                     rope_layout="half", attn_impl="xla"), np.float32)
    model = convert.flux_from_jax(_np(qparams), cfg, device="cpu")
    assert all(isinstance(m, Int4DiTLinear) for m in (model.img_in, model.final_layer.linear,
                                                      model.double_blocks[0].img_mod.lin,
                                                      model.single_blocks[0].linear1))
    ops.reset_kernel_launches()
    got = model(**{k: _t(v) for k, v in inp.items()}).float().numpy()
    assert ops.kernel_launches()["int4_matmul"] == 0  # CPU tensors: the plain version, no launch
    assert got.shape == want.shape and np.isfinite(got).all()
    rms = float(np.sqrt(np.mean(want ** 2)))
    diff = np.abs(got - want)
    assert diff.max() <= _DIT_INT8["max"] * rms, diff.max() / rms
    assert diff.mean() <= _DIT_INT8["mean"] * rms, diff.mean() / rms


@pytest.mark.parametrize("case,match", [
    ("x_fp32", "bfloat16"), ("w_int8", "uint8"), ("k96", "multiples of 64"), ("group32", "multiples of 64"),
    ("n24", "N of 16"), ("scale_rows", "does not divide"), ("ok", "CUDA"),
])
def test_int4_matmul_refuses_what_the_kernel_does_not_take(case, match):
    """A tensor off the CPU goes to the kernel path, which checks types and
    shapes (here on meta tensors) before it needs the card; the plain
    version is never taken."""
    k, n, groups = {"k96": (96, 64, 1), "group32": (128, 64, 4), "n24": (128, 24, 1),
                    "scale_rows": (128, 64, 3)}.get(case, (128, 64, 2))
    x = torch.empty((4, k), device="meta", dtype=torch.float32 if case == "x_fp32" else torch.bfloat16)
    w = torch.empty((k // 2, n), device="meta", dtype=torch.int8 if case == "w_int8" else torch.uint8)
    s = torch.empty((groups, n), device="meta")
    with pytest.raises(ValueError, match=match):
        int4_matmul(x, w, s)
