"""FLUX transformer layers (counterpart of visualcloze_tpu/models/layers.py).

Precision policy, as in the JAX package: matmuls in the parameter dtype,
LayerNorm / RMSNorm / RoPE / softmax in fp32, modulation arithmetic in fp32
cast to the stream dtype at the residual add. Module and parameter names
mirror the JAX parameter tree so that convert.py maps one onto the other.
The dense linear, the int8 weight-only one (`Int8Linear`, through kernel G),
the int4 weight-only one (`Int4DiTLinear`, through kernel G4) and the w8a8
one (`W8A8Linear`, through kernels I and H) are ported.

What XLA fuses inside JAX's blocks runs as kernels J (LayerNorm +
modulate), K (gated residual), L (head split + q/k RMSNorm into attention's
buffers) and M (head merge, + gelu in the single block) of
ops/block_fusions.py, through its `apply_*` entry points: the kernels alone
on the no-grad forward, and under autograd their Functions, whose backward
is kernels J', K', L' and M'. In calibration (collect_stats) the blocks run
the plain versions, the former PyTorch code, whose fp32 values the
statistics read.

LoRA is unfolded, as in JAX: every forward takes an optional `lora` tree
(the entries of models/lora.py keyed like the module's own children) and
adds x @ A @ B (+ B's bias) times `lora_scale` to each linear; a MoE-LoRA
entry (models/lora.init_moe_lora) adds a shared pair plus every expert's
pair, computed densely and combined with the top-2 renormalised gate.

Parallelism (parallel/sharding.py sets it up): a linear with a `tp` shard
(`TPShard`) holds only its rank's output columns (column-parallel: qkv,
linear1, mlp "0") or input rows (row-parallel: proj, linear2, mlp "2"),
with Megatron's explicit collectives: its input is `copy_to` the tp group
(gradient summed), a row-parallel product is summed over the group before
the bias. Its LoRA factors stay whole and replicated: a column-parallel
linear adds only its columns of the delta, a row-parallel one sums the
rank-partial x @ A products first. A linear with an `ep_group` takes MoE
entries whose expert leaves hold only its rank's experts; one sum over the
ep group finishes the combine. Blocks take `attn_impl` (None: the kernels;
an ops.attention.RingSpec: ring attention over cp) and
`seg`, a wrapper applied to their pre- and post-attention halves (the
two-segment remat of models/flux.py); RoPE then runs inside the first half.
With collect_stats, a block also returns the per-input-channel absmax of
each w8a8 linear's input (the SmoothQuant calibration of models/quant.py),
keyed as the block's modules: {"img_attn": {"qkv", "proj"}, "img_mlp":
{"0", "2"}, "txt_..."} and {"linear1", "linear2"}.
"""

from __future__ import annotations

from typing import Callable

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..config import FluxConfig
from ..ops.act_quant import act_quant_int8
from ..ops.attention import attention, rope_qk
from ..ops.block_fusions import (apply_gated_residual, apply_layernorm_modulate, apply_qk_norm_split,
                                 gated_residual_plain, layernorm_modulate_plain, qk_norm_split_plain)
from ..parallel.collectives import all_gather_cat, copy_to, reduce_from
from ..ops.int4_matmul import int4_matmul
from ..ops.int8_matmul import int8_matmul
from ..ops.w8a8_matmul import w8a8_matmul
from .lora import Lora


MOE_TOP_K = 2  # the reference MixtureOfLoRAExperts' default


@dataclasses.dataclass(eq=False)
class TPShard:
    """This rank's part of a tensor-parallel linear: kind "column" (it holds
    the output features `idx` of the whole linear's `full`) or "row" (the
    input features `idx`); `rank`, its place in the group, where the
    group's all-gather puts its input features."""

    kind: str
    group: object
    idx: torch.Tensor
    full: int
    rank: int = 0


_OUT_LEAVES = ("b", "b_bias", "shared_b", "expert_b")  # their last dim is the linear's output


def _project(x, w, eq: str, lin) -> torch.Tensor:
    """einsum(eq, x, w) of an input-side LoRA leaf: under a row-parallel
    shard, w's rows that this rank's x holds, summed over the tp group."""
    tp = getattr(lin, "tp", None)
    row = tp is not None and tp.kind == "row"
    if row:
        w = copy_to(w, tp.group).index_select(-2, tp.idx.to(w.device))
    y = torch.matmul(x, w.to(x.dtype)) if w.dim() == 2 else torch.einsum(eq, x, w.to(x.dtype))
    return reduce_from(y, tp.group) if row else y


def _column_entry(lora: Lora, lin) -> Lora:
    """A column-parallel linear's view of a replicated LoRA entry: every leaf
    copy_to the tp group (its gradient summed there), the output leaves cut
    to this rank's columns."""
    tp = getattr(lin, "tp", None)
    if tp is None or tp.kind != "column":
        return lora
    out = {}
    for key, t in lora.items():
        t = copy_to(t, tp.group)
        out[key] = t.index_select(-1, tp.idx.to(t.device)) if key in _OUT_LEAVES else t
    return out


def _lora_delta(lora: Lora, x: torch.Tensor, scale: float, lin=None) -> torch.Tensor:
    """x @ A @ B (+ B bias) * scale in x's dtype; B carries a bias in the
    reference (lora_bias=True). `lin`: the linear, for its tp / ep shards."""
    lora = _column_entry(lora, lin)
    if "expert_a" in lora:
        return _moe_lora_delta(lora, x, scale, lin)
    y = _project(x, lora["a"], "...i,ir->...r", lin)
    y = torch.matmul(y, lora["b"].to(x.dtype))
    if "b_bias" in lora:
        y = y + lora["b_bias"].to(y.dtype)
    if scale != 1.0:  # JAX rounds the scale to y's dtype first
        y = y * torch.tensor(scale, dtype=y.dtype, device=y.device)
    return y


def _moe_lora_delta(lora: Lora, x: torch.Tensor, scale: float, lin=None) -> torch.Tensor:
    """Mixture-of-LoRA-experts delta (JAX `_moe_lora_delta`): the shared pair
    plus every expert's pair, computed densely, combined with the top-k gate.

    The gate is an fp32 softmax over the experts of x @ gate_w + gate_b; the
    top MOE_TOP_K probabilities, renormalised to sum to 1, weight their
    experts (the others 0). Everything else in x's dtype. When the expert
    leaves hold fewer experts than the gate (sharded over ep), this rank's
    experts are combined with their gate weights and one sum over the ep
    group finishes the combine."""
    shared = _project(x, lora["shared_a"], "...i,ir->...r", lin)
    shared = torch.matmul(shared, lora["shared_b"].to(x.dtype))
    logits = _project(x.to(torch.float32), lora["gate_w"].to(torch.float32), "...i,ie->...e", lin)
    probs = torch.softmax(logits + lora["gate_b"].to(torch.float32), dim=-1)
    n_exp = probs.shape[-1]
    top_v, top_i = torch.topk(probs, min(MOE_TOP_K, n_exp), dim=-1)
    top_v = top_v / top_v.sum(dim=-1, keepdim=True)
    weights = torch.zeros_like(probs).scatter(-1, top_i, top_v)  # (..., E), zero off the top k
    e_local = lora["expert_a"].shape[-3]
    group = None
    if e_local != n_exp:
        group = getattr(lin, "ep_group", None)
        if group is None or e_local * dist.get_world_size(group) != n_exp:
            raise ValueError(f"MoE entry holds {e_local} of {n_exp} experts without a matching ep group")
        first = dist.get_rank(group) * e_local
        weights = copy_to(weights, group)[..., first:first + e_local]
        x = copy_to(x, group)
    h = _project(x, lora["expert_a"], "...i,eir->...er", lin)
    d = torch.einsum("...er,ero->...eo", h, lora["expert_b"].to(x.dtype))
    expert_out = reduce_from(torch.einsum("...eo,...e->...o", d, weights.to(d.dtype)), group)
    return (shared + expert_out) * torch.tensor(scale, dtype=x.dtype, device=x.device)


class _LinearForward:
    """The forward the four linears share: x cast to `_x_dtype` (None keeps
    it), y = `_product(x, bias)` on the linear's weights, + the LoRA delta of
    x in `_lora_dtype` (None: x's). Under a tp shard (`tp`, set by
    parallel.sharding): column -- x copy_to the group, the local bias in the
    product, this rank's columns of the delta; row -- x holds this rank's
    input features, the products (and the LoRA's x @ A) are summed over the
    group, then the bias and the delta are added whole. `ep_group`: the
    group a MoE entry's experts are split over."""

    tp: TPShard | None = None
    ep_group = None
    _x_dtype: torch.dtype | None = torch.bfloat16
    _lora_dtype: torch.dtype | None = None

    def forward(self, x: torch.Tensor, lora: Lora | None = None, lora_scale: float = 1.0) -> torch.Tensor:
        if self._x_dtype is not None:
            x = x.to(self._x_dtype)
        tp = self.tp
        if tp is None:
            y = self._product(x, self.bias)
        elif tp.kind == "column":
            x = copy_to(x, tp.group)
            y = self._product(x, self.bias)
        else:
            y = reduce_from(self._product(x, None), tp.group)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)
        if lora is not None:
            y = y + _lora_delta(lora, x if self._lora_dtype is None else x.to(self._lora_dtype), lora_scale, self)
        return y


def _with_bias(y: torch.Tensor, bias) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)


def lora_delta_dtype(linear: nn.Module) -> torch.dtype:
    """The dtype `linear` computes its LoRA delta in, which _lora_delta casts
    the entry's factors to at every call: a dense Linear's weight dtype, bf16
    for the int8, int4 and w8a8 linears."""
    return linear.weight.dtype if isinstance(linear, Linear) else torch.bfloat16


class Linear(_LinearForward, nn.Linear):
    """y = x W^T + b (+ LoRA delta) with x cast to the weight dtype first (JAX `linear`)."""

    _x_dtype = None

    def forward(self, x: torch.Tensor, lora: Lora | None = None, lora_scale: float = 1.0) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype), lora, lora_scale)

    def _product(self, x, bias):
        return F.linear(x, self.weight, bias)


def linear_kind(entry) -> str:
    """"dense", "int8", "int4" or "w8a8" (an "a8" marker, with or without
    "a_sinv") for a JAX linear entry (a mapping of its leaves)."""
    if "w_int4" in entry:
        return "int4"
    if "a8" in entry:
        return "w8a8"
    return "int8" if "w_int8" in entry else "dense"


class Int8Linear(_LinearForward, nn.Module):
    """The int8 weight-only linear (JAX `linear`'s "w_int8" branch): buffers
    w_int8 (in, out) int8 and w_scale (out,) fp32, as the JAX entry stores
    them, and a bias in the compute dtype. y = bf16(x) @ (w_int8 * w_scale)
    through kernel G (its plain version for CPU tensors), + b, + the LoRA
    delta. G rounds once, after the fp32 rescale; JAX rounds the bf16 dot to
    bf16 first, so the two differ by at most one bf16 ulp."""

    lora_target = True  # models/lora.init_lora gives it a LoRA entry

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_int8", torch.empty((in_features, out_features), dtype=torch.int8))
        self.register_buffer("w_scale", torch.empty((out_features,), dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def _product(self, x, bias):
        return _with_bias(int8_matmul(x.contiguous(), self.w_int8, self.w_scale), bias)


INT4_GROUP = 128


def int4_group(din: int, group: int = INT4_GROUP) -> int:
    """quantize_weight_int4's input group: halved until it divides din (and stays even)."""
    while din % group or group % 2:
        group //= 2
    if group < 2:
        raise ValueError(f"no even int4 group divides the input dim {din}")
    return group


class Int4DiTLinear(_LinearForward, nn.Module):
    """The int4 weight-only DiT linear (JAX `linear`'s "w_int4" branch, the
    quantize_flux_int4 entry): buffers w_int4 (in/2, out) uint8, two codes a
    byte (row 2i in the low nibble), and w_scale (in/group, out) fp32, as the
    JAX entry stores them, and a bias in the compute dtype. y = bf16(x) @
    bf16(q * scale) through kernel G4 (its plain version for CPU tensors),
    + b, + the LoRA delta. The dequantized weights equal JAX's bit for bit;
    G4 sums in fp32 and rounds once, as JAX's bf16 dot does on the CPU."""

    lora_target = True  # models/lora.init_lora gives it a LoRA entry

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.group = int4_group(in_features)
        self.register_buffer("w_int4", torch.empty((in_features // 2, out_features), dtype=torch.uint8))
        self.register_buffer("w_scale", torch.empty((in_features // self.group, out_features), dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def _product(self, x, bias):
        return _with_bias(int4_matmul(x.contiguous(), self.w_int4, self.w_scale), bias)


class W8A8Linear(_LinearForward, nn.Module):
    """The w8a8 linear (JAX `linear`'s "a8" branch): int8 weights, int8
    activations quantized per token at each call. Buffers w_int8 (out, in)
    int8 -- K-major, the JAX entry's (in, out) codes transposed once where
    the linear is quantized or converted, since the 8-bit tensor-core
    products take both operands K-major -- w_scale (out,) fp32 and, for
    SmoothQuant, a_sinv (in,) fp32; a bias in the compute dtype.

    x is quantized as it arrives (the double blocks' qkv and mlp.0 inputs
    are fp32; JAX does not round them to bf16 first) by kernel I, times
    a_sinv; kernel H takes the codes and returns bf16((acc * x_scale) *
    w_scale) + bf16 bias (a bf16 add, in its epilogue); then + the LoRA
    delta of bf16(x), in JAX's order.
    On CPU tensors both kernels run their plain versions, which equal JAX's
    arithmetic bit for bit."""

    lora_target = True  # models/lora.init_lora gives it a LoRA entry

    def __init__(self, in_features: int, out_features: int, bias: bool = True, smooth: bool = False):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_int8", torch.empty((out_features, in_features), dtype=torch.int8))
        self.register_buffer("w_scale", torch.empty((out_features,), dtype=torch.float32))
        self.register_buffer("a_sinv", torch.empty((in_features,), dtype=torch.float32) if smooth else None)
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    _x_dtype, _lora_dtype = None, torch.bfloat16

    def _product(self, x, bias):
        """Kernel I then H. A row-parallel shard quantizes the tp group's
        gathered inputs whole (the per-token scale is the absmax over every
        input feature, as unsharded) and gives H this rank's codes."""
        k = self.in_features
        if self.tp is not None and self.tp.kind == "row":
            codes, x_scale = act_quant_int8(all_gather_cat(x.contiguous(), self.tp.group, -1), self.a_sinv)
            start = self.tp.rank * k
            codes = codes.reshape(-1, codes.shape[-1])[:, start:start + k].contiguous()
        else:
            codes, x_scale = act_quant_int8(x.contiguous(), self.a_sinv)
        y = w8a8_matmul(codes, self.w_int8, x_scale.reshape(-1), self.w_scale, bias)
        return y.reshape(*x.shape[:-1], self.out_features)


def _absmax_in(t: torch.Tensor) -> torch.Tensor:
    """Per-input-channel absmax over every leading axis: (..., in) -> (in,)
    fp32 (the SmoothQuant calibration statistic, JAX `_absmax_in`)."""
    return t.to(torch.float32).abs().reshape(-1, t.shape[-1]).amax(dim=0)


class QKNorm(nn.Module):
    tp_group = None  # under tensor parallelism the scales meet only this rank's heads

    def __init__(self, dim: int):
        super().__init__()
        self.q_scale = nn.Parameter(torch.ones(dim))
        self.k_scale = nn.Parameter(torch.ones(dim))

    def scales(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(q_scale, k_scale), copied to the tp group (their gradients summed there)."""
        return copy_to(self.q_scale, self.tp_group), copy_to(self.k_scale, self.tp_group)


class MLPEmbedder(nn.Module):
    """out_layer(silu(in_layer(x)))."""

    def __init__(self, d_in: int, d_hidden: int):
        super().__init__()
        self.in_layer = Linear(d_in, d_hidden)
        self.out_layer = Linear(d_hidden, d_hidden)

    def forward(self, x, lora: Lora | None = None, lora_scale: float = 1.0):
        l = lora or {}
        h = F.silu(self.in_layer(x, l.get("in_layer"), lora_scale))
        return self.out_layer(h, l.get("out_layer"), lora_scale)


class Modulation(nn.Module):
    """adaLN modulation: linear of silu(vec) -> (shift, scale, gate) chunks in
    fp32 with a length-1 sequence axis. The caller applies the silu, once per
    block: a double block's two modulations share one silu(vec), so vec's
    gradient gets one contribution per block, summed in the block's own
    order whether or not a hook wraps the block's inputs (FSDP2)."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.mult = 6 if double else 3
        self.lin = Linear(dim, self.mult * dim)

    def forward(self, silu_vec, lora: Lora | None = None, lora_scale: float = 1.0):
        """silu_vec: F.silu(vec); lora: the entry of `lin`."""
        out = self.lin(silu_vec, lora, lora_scale).to(torch.float32)[:, None, :]
        chunks = out.chunk(self.mult, dim=-1)
        m1 = {"shift": chunks[0], "scale": chunks[1], "gate": chunks[2]}
        m2 = {"shift": chunks[3], "scale": chunks[4], "gate": chunks[5]} if self.mult == 6 else None
        return m1, m2


def _input_dtype(linear: nn.Module) -> torch.dtype:
    """The dtype `linear` takes its input in, so that kernel J stores that (on
    the no-grad forward and under autograd alike):
    a dense linear's weight dtype, fp32 for a w8a8 one (kernel I quantizes
    the fp32 value, as JAX), bf16 for the int8 and int4 ones."""
    if isinstance(linear, Linear):
        return linear.weight.dtype
    return linear._x_dtype or torch.float32


def _modulate(x, mod, out_dtype: torch.dtype, fused: bool):
    """(1 + scale) * layer_norm(x) + shift as out_dtype: kernel J (J' its
    backward), or its plain version (calibration)."""
    fn = apply_layernorm_modulate if fused else layernorm_modulate_plain
    return fn(x, mod["shift"], mod["scale"], out_dtype)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, head_dim: int, qkv_bias: bool):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.norm = QKNorm(head_dim)


class DoubleBlock(nn.Module):
    """DoubleStreamBlock: separate img/txt streams, joint attention over
    concat(txt, img). Kernel J modulates each linear's input, kernel L
    writes both streams' q, k, v into one joint buffer (txt first), kernel M
    merges the heads and kernel K adds each gated residual (under autograd
    with J'-M' as their backward); in calibration their plain versions run."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h, mh = cfg.hidden_size, cfg.mlp_hidden_dim
        self.num_heads = cfg.num_heads
        self.img_mod = Modulation(h, True)
        self.txt_mod = Modulation(h, True)
        self.img_attn = SelfAttention(h, cfg.head_dim, cfg.qkv_bias)
        self.txt_attn = SelfAttention(h, cfg.head_dim, cfg.qkv_bias)
        self.img_mlp = nn.ModuleDict({"0": Linear(h, mh), "2": Linear(mh, h)})
        self.txt_mlp = nn.ModuleDict({"0": Linear(h, mh), "2": Linear(mh, h)})

    @staticmethod
    def _qkv(attn: SelfAttention, x, mod, lora: Lora, lora_scale, stats: dict | None, fused: bool):
        """The stream's qkv projection of its modulated input."""
        x_mod = _modulate(x, mod, _input_dtype(attn.qkv) if fused else torch.float32, fused)
        if stats is not None:
            stats["qkv"] = _absmax_in(x_mod)
        return attn.qkv(x_mod, lora.get("qkv"), lora_scale)

    @staticmethod
    def _mlp(mlp: nn.ModuleDict, x, mod, lora: Lora, lora_scale, stats: dict | None, fused: bool):
        x_mod = _modulate(x, mod, _input_dtype(mlp["0"]) if fused else torch.float32, fused)
        if stats is not None:
            stats["0"] = _absmax_in(x_mod)
        h = F.gelu(mlp["0"](x_mod, lora.get("0"), lora_scale), approximate="tanh")
        if stats is not None:
            stats["2"] = _absmax_in(h)
        return mlp["2"](h, lora.get("2"), lora_scale)

    def forward(self, img, txt, vec, pe, attn_mask, lora: Lora | None = None, lora_scale: float = 1.0,
                rope_layout: str = "half", seg: Callable | None = None, collect_stats: bool = False,
                attn_impl=None):
        l = lora or {}
        txt_len = txt.shape[1]
        if collect_stats and seg is not None:
            raise ValueError("collect_stats is a calibration (no-remat) mode")
        stats = {k: {} for k in ("img_attn", "txt_attn", "img_mlp", "txt_mlp")} if collect_stats else None
        fused = not collect_stats
        residual = apply_gated_residual if fused else gated_residual_plain

        def st(key: str) -> dict | None:
            return None if stats is None else stats[key]

        def pre(img, txt):
            silu_vec = F.silu(vec)
            img_mod1, img_mod2 = self.img_mod(silu_vec, l.get("img_mod", {}).get("lin"), lora_scale)
            txt_mod1, txt_mod2 = self.txt_mod(silu_vec, l.get("txt_mod", {}).get("lin"), lora_scale)
            img_qkv = self._qkv(self.img_attn, img, img_mod1, l.get("img_attn", {}), lora_scale, st("img_attn"),
                                fused)
            txt_qkv = self._qkv(self.txt_attn, txt, txt_mod1, l.get("txt_attn", {}), lora_scale, st("txt_attn"),
                                fused)
            streams = [(qkv, *attn.norm.scales()) for attn, qkv in ((self.txt_attn, txt_qkv), (self.img_attn, img_qkv))]
            if fused:  # both streams into one joint buffer, txt first
                q, k, v, _ = apply_qk_norm_split(streams, self.num_heads, img_qkv.shape[-1])
            else:
                parts = [qk_norm_split_plain(*stream, self.num_heads) for stream in streams]
                q, k, v = (torch.cat(ts, dim=2) for ts in zip(*parts))
            if seg is not None:  # rotated q, k are the attention's saved inputs
                q, k = rope_qk(q, k, pe, rope_layout)
            return q, k, v, (img_mod1, img_mod2, txt_mod1, txt_mod2)

        def post(img, txt, attn, mods):
            img_mod1, img_mod2, txt_mod1, txt_mod2 = mods
            txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]
            if stats is not None:
                stats["img_attn"]["proj"] = _absmax_in(img_attn)
                stats["txt_attn"]["proj"] = _absmax_in(txt_attn)
            li, lt = l.get("img_attn", {}), l.get("txt_attn", {})
            img = residual(img, img_mod1["gate"], self.img_attn.proj(img_attn, li.get("proj"), lora_scale))
            img = residual(img, img_mod2["gate"], self._mlp(self.img_mlp, img, img_mod2, l.get("img_mlp", {}),
                                                            lora_scale, st("img_mlp"), fused))
            txt = residual(txt, txt_mod1["gate"], self.txt_attn.proj(txt_attn, lt.get("proj"), lora_scale))
            txt = residual(txt, txt_mod2["gate"], self._mlp(self.txt_mlp, txt, txt_mod2, l.get("txt_mlp", {}),
                                                            lora_scale, st("txt_mlp"), fused))
            return img, txt

        if seg is not None:
            pre, post = seg(pre), seg(post)
        q, k, v, mods = pre(img, txt)
        attn = attention(q, k, v, None if seg is not None else pe, mask=attn_mask, rope_layout=rope_layout,
                         impl=attn_impl, fused=fused)
        out = post(img, txt, attn, mods)
        return (out, stats) if collect_stats else out


class SingleBlock(nn.Module):
    """SingleStreamBlock: fused parallel attention + MLP. Kernel J modulates
    linear1's input, kernel L splits and normalizes q, k, v from linear1's
    first 3 * hidden columns, kernel M writes linear2's whole input (the
    merged heads, then gelu of the rest of linear1's output) and kernel K
    adds the gated residual; under autograd J'-M' are their backward, and
    L' and M' write linear1's one gradient buffer (QKNormSplit); in
    calibration their plain versions run."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h, mh = cfg.hidden_size, cfg.mlp_hidden_dim
        self.hidden_size = h
        self.num_heads = cfg.num_heads
        self.linear1 = Linear(h, 3 * h + mh)
        self.linear2 = Linear(h + mh, h)
        self.norm = QKNorm(cfg.head_dim)
        self.modulation = Modulation(h, False)

    def forward(self, x, vec, pe, attn_mask, lora: Lora | None = None, lora_scale: float = 1.0,
                rope_layout: str = "half", seg: Callable | None = None, collect_stats: bool = False,
                attn_impl=None):
        l = lora or {}
        if collect_stats and seg is not None:
            raise ValueError("collect_stats is a calibration (no-remat) mode")
        stats: dict | None = {} if collect_stats else None
        fused = not collect_stats
        residual = apply_gated_residual if fused else gated_residual_plain

        def pre(x):
            mod, _ = self.modulation(F.silu(vec), l.get("modulation", {}).get("lin"), lora_scale)
            x_mod = _modulate(x, mod, x.dtype, fused)
            if stats is not None:
                stats["linear1"] = _absmax_in(x_mod)
            h = self.linear1(x_mod, l.get("linear1"), lora_scale)
            cols = 3 * self.hidden_size
            if fused:  # the gelu half comes back through QKNormSplit, which owns h's gradient
                q, k, v, mlp_h = apply_qk_norm_split([(h, *self.norm.scales())], self.num_heads, cols)
            else:
                q, k, v = qk_norm_split_plain(h[..., :cols], *self.norm.scales(), self.num_heads)
                mlp_h = h[..., cols:]
            if seg is not None:
                q, k = rope_qk(q, k, pe, rope_layout)
            return q, k, v, mlp_h, mod

        def post(x, cat, mod):
            """cat: linear2's whole input, the merged heads and gelu of the
            MLP half (kernel M or its plain version)."""
            if stats is not None:
                stats["linear2"] = _absmax_in(cat)
            out = self.linear2(cat, l.get("linear2"), lora_scale)
            return residual(x, mod["gate"], out)

        if seg is not None:
            pre, post = seg(pre), seg(post)
        q, k, v, mlp_h, mod = pre(x)
        cat = attention(q, k, v, None if seg is not None else pe, mask=attn_mask, rope_layout=rope_layout,
                        impl=attn_impl, gelu=mlp_h, fused=fused)
        out = post(x, cat, mod)
        return (out, stats) if collect_stats else out


class LastLayer(nn.Module):
    """adaLN (shift, scale) + linear; kernel J (J' its backward) outside
    calibration (collect_stats), as in the blocks."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h = cfg.hidden_size
        self.linear = Linear(h, cfg.out_channels)
        self.adaLN = Linear(h, 2 * h)

    def forward(self, x, vec, lora: Lora | None = None, lora_scale: float = 1.0, collect_stats: bool = False):
        l = lora or {}
        mod = self.adaLN(F.silu(vec), l.get("adaLN"), lora_scale).to(torch.float32)
        shift, scale = mod.chunk(2, dim=-1)
        fused = not collect_stats
        x = _modulate(x, {"shift": shift[:, None], "scale": scale[:, None]},
                      _input_dtype(self.linear) if fused else torch.float32, fused)
        return self.linear(x, l.get("linear"), lora_scale)
