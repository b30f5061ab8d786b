"""FLUX transformer layers (counterpart of visualcloze_tpu/models/layers.py).

Precision policy, as in the JAX package: matmuls in the parameter dtype,
LayerNorm / RMSNorm / RoPE / softmax in fp32, modulation arithmetic in fp32
cast to the stream dtype at the residual add. Module and parameter names
mirror the JAX parameter tree so that convert.py maps one onto the other.
The dense linear, the int8 weight-only one (`Int8Linear`, through kernel G),
the int4 weight-only one (`Int4DiTLinear`, through kernel G4) and the w8a8
one (`W8A8Linear`, through kernels I and H) are ported.

LoRA is unfolded, as in JAX: every forward takes an optional `lora` tree
(the entries of models/lora.py keyed like the module's own children) and
adds x @ A @ B (+ B's bias) times `lora_scale` to each linear. Blocks take
`seg`, a wrapper applied to their pre- and post-attention halves (the
two-segment remat of models/flux.py); RoPE then runs inside the first half.
With collect_stats, a block also returns the per-input-channel absmax of
each w8a8 linear's input (the SmoothQuant calibration of models/quant.py),
keyed as the block's modules: {"img_attn": {"qkv", "proj"}, "img_mlp":
{"0", "2"}, "txt_..."} and {"linear1", "linear2"}.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..config import FluxConfig
from ..ops.act_quant import act_quant_int8
from ..ops.attention import attention, rope_qk
from ..ops.int4_matmul import int4_matmul
from ..ops.int8_matmul import int8_matmul
from ..ops.w8a8_matmul import w8a8_matmul
from .lora import Lora


def _lora_delta(lora: Lora, x: torch.Tensor, scale: float) -> torch.Tensor:
    """x @ A @ B (+ B bias) * scale in x's dtype; B carries a bias in the
    reference (lora_bias=True)."""
    if "expert_a" in lora:
        raise NotImplementedError(
            "MoE-LoRA (mixture of LoRA experts) is not ported yet: ROADMAP item 5")
    y = torch.matmul(x, lora["a"].to(x.dtype))
    y = torch.matmul(y, lora["b"].to(x.dtype))
    if "b_bias" in lora:
        y = y + lora["b_bias"].to(y.dtype)
    if scale != 1.0:  # JAX rounds the scale to y's dtype first
        y = y * torch.tensor(scale, dtype=y.dtype, device=y.device)
    return y


def lora_delta_dtype(linear: nn.Module) -> torch.dtype:
    """The dtype `linear` computes its LoRA delta in, which _lora_delta casts
    the entry's factors to at every call: a dense Linear's weight dtype, bf16
    for the int8, int4 and w8a8 linears."""
    return linear.weight.dtype if isinstance(linear, Linear) else torch.bfloat16


class Linear(nn.Linear):
    """y = x W^T + b (+ LoRA delta) with x cast to the weight dtype first (JAX `linear`)."""

    def forward(self, x: torch.Tensor, lora: Lora | None = None, lora_scale: float = 1.0) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        y = F.linear(x, self.weight, self.bias)
        if lora is not None:
            y = y + _lora_delta(lora, x, lora_scale)
        return y


def linear_kind(entry) -> str:
    """"dense", "int8", "int4" or "w8a8" (an "a8" marker, with or without
    "a_sinv") for a JAX linear entry (a mapping of its leaves)."""
    if "w_int4" in entry:
        return "int4"
    if "a8" in entry:
        return "w8a8"
    return "int8" if "w_int8" in entry else "dense"


class Int8Linear(nn.Module):
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

    def forward(self, x: torch.Tensor, lora: Lora | None = None, lora_scale: float = 1.0) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        y = int8_matmul(x.contiguous(), self.w_int8, self.w_scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if lora is not None:
            y = y + _lora_delta(lora, x, lora_scale)
        return y


INT4_GROUP = 128


def int4_group(din: int, group: int = INT4_GROUP) -> int:
    """quantize_weight_int4's input group: halved until it divides din (and stays even)."""
    while din % group or group % 2:
        group //= 2
    if group < 2:
        raise ValueError(f"no even int4 group divides the input dim {din}")
    return group


class Int4DiTLinear(nn.Module):
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

    def forward(self, x: torch.Tensor, lora: Lora | None = None, lora_scale: float = 1.0) -> torch.Tensor:
        x = x.to(torch.bfloat16)
        y = int4_matmul(x.contiguous(), self.w_int4, self.w_scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if lora is not None:
            y = y + _lora_delta(lora, x, lora_scale)
        return y


class W8A8Linear(nn.Module):
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

    def forward(self, x: torch.Tensor, lora: Lora | None = None, lora_scale: float = 1.0) -> torch.Tensor:
        codes, x_scale = act_quant_int8(x.contiguous(), self.a_sinv)
        y = w8a8_matmul(codes, self.w_int8, x_scale, self.w_scale, self.bias)
        y = y.reshape(*x.shape[:-1], self.out_features)
        if lora is not None:
            y = y + _lora_delta(lora, x.to(torch.bfloat16), lora_scale)
        return y


def _absmax_in(t: torch.Tensor) -> torch.Tensor:
    """Per-input-channel absmax over every leading axis: (..., in) -> (in,)
    fp32 (the SmoothQuant calibration statistic, JAX `_absmax_in`)."""
    return t.to(torch.float32).abs().reshape(-1, t.shape[-1]).amax(dim=0)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm in fp32 (returns fp32)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """fp32 RMS norm, cast back before the learned scale."""
    x32 = x.to(torch.float32)
    rrms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * rrms).to(x.dtype) * scale.to(x.dtype)


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.q_scale = nn.Parameter(torch.ones(dim))
        self.k_scale = nn.Parameter(torch.ones(dim))

    def forward(self, q, k, v):
        return rms_norm(q, self.q_scale).to(v.dtype), rms_norm(k, self.k_scale).to(v.dtype)


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
    """adaLN modulation: silu -> linear -> (shift, scale, gate) chunks in fp32
    with a length-1 sequence axis."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.mult = 6 if double else 3
        self.lin = Linear(dim, self.mult * dim)

    def forward(self, vec, lora: Lora | None = None, lora_scale: float = 1.0):
        """lora: the entry of `lin`."""
        out = self.lin(F.silu(vec), lora, lora_scale).to(torch.float32)[:, None, :]
        chunks = out.chunk(self.mult, dim=-1)
        m1 = {"shift": chunks[0], "scale": chunks[1], "gate": chunks[2]}
        m2 = {"shift": chunks[3], "scale": chunks[4], "gate": chunks[5]} if self.mult == 6 else None
        return m1, m2


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, L, 3*H*D) -> three (B, H, L, D); feature order (k, h, d)."""
    b, l, f = qkv.shape
    d = f // (3 * num_heads)
    x = qkv.reshape(b, l, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _modulate(x, mod):
    return (1.0 + mod["scale"]) * layer_norm(x) + mod["shift"]


class SelfAttention(nn.Module):
    def __init__(self, dim: int, head_dim: int, qkv_bias: bool):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.norm = QKNorm(head_dim)


class DoubleBlock(nn.Module):
    """DoubleStreamBlock: separate img/txt streams, joint attention over
    concat(txt, img)."""

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

    def _qkv(self, attn: SelfAttention, x, mod, lora: Lora, lora_scale, stats: dict | None):
        x_mod = _modulate(x, mod)
        if stats is not None:
            stats["qkv"] = _absmax_in(x_mod)
        qkv = attn.qkv(x_mod, lora.get("qkv"), lora_scale)
        q, k, v = _split_heads(qkv, self.num_heads)
        q, k = attn.norm(q, k, v)
        return q, k, v

    @staticmethod
    def _mlp(mlp: nn.ModuleDict, x, mod, lora: Lora, lora_scale, stats: dict | None):
        x_mod = _modulate(x, mod)
        if stats is not None:
            stats["0"] = _absmax_in(x_mod)
        h = F.gelu(mlp["0"](x_mod, lora.get("0"), lora_scale), approximate="tanh")
        if stats is not None:
            stats["2"] = _absmax_in(h)
        return mlp["2"](h, lora.get("2"), lora_scale)

    def forward(self, img, txt, vec, pe, attn_mask, lora: Lora | None = None, lora_scale: float = 1.0,
                rope_layout: str = "half", seg: Callable | None = None, collect_stats: bool = False):
        l = lora or {}
        txt_len = txt.shape[1]
        if collect_stats and seg is not None:
            raise ValueError("collect_stats is a calibration (no-remat) mode")
        stats = {k: {} for k in ("img_attn", "txt_attn", "img_mlp", "txt_mlp")} if collect_stats else None

        def st(key: str) -> dict | None:
            return None if stats is None else stats[key]

        def pre(img, txt):
            img_mod1, img_mod2 = self.img_mod(vec, l.get("img_mod", {}).get("lin"), lora_scale)
            txt_mod1, txt_mod2 = self.txt_mod(vec, l.get("txt_mod", {}).get("lin"), lora_scale)
            img_q, img_k, img_v = self._qkv(self.img_attn, img, img_mod1, l.get("img_attn", {}), lora_scale,
                                            st("img_attn"))
            txt_q, txt_k, txt_v = self._qkv(self.txt_attn, txt, txt_mod1, l.get("txt_attn", {}), lora_scale,
                                            st("txt_attn"))
            q = torch.cat([txt_q, img_q], dim=2)
            k = torch.cat([txt_k, img_k], dim=2)
            v = torch.cat([txt_v, img_v], dim=2)
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
            img = img + (img_mod1["gate"] * self.img_attn.proj(img_attn, li.get("proj"), lora_scale).to(
                torch.float32)).to(img.dtype)
            img = img + (img_mod2["gate"] * self._mlp(self.img_mlp, img, img_mod2, l.get("img_mlp", {}),
                                                      lora_scale, st("img_mlp")).to(torch.float32)).to(img.dtype)
            txt = txt + (txt_mod1["gate"] * self.txt_attn.proj(txt_attn, lt.get("proj"), lora_scale).to(
                torch.float32)).to(txt.dtype)
            txt = txt + (txt_mod2["gate"] * self._mlp(self.txt_mlp, txt, txt_mod2, l.get("txt_mlp", {}),
                                                      lora_scale, st("txt_mlp")).to(torch.float32)).to(txt.dtype)
            return img, txt

        if seg is not None:
            pre, post = seg(pre), seg(post)
        q, k, v, mods = pre(img, txt)
        attn = attention(q, k, v, None if seg is not None else pe, mask=attn_mask, rope_layout=rope_layout)
        out = post(img, txt, attn, mods)
        return (out, stats) if collect_stats else out


class SingleBlock(nn.Module):
    """SingleStreamBlock: fused parallel attention + MLP."""

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
                rope_layout: str = "half", seg: Callable | None = None, collect_stats: bool = False):
        l = lora or {}
        if collect_stats and seg is not None:
            raise ValueError("collect_stats is a calibration (no-remat) mode")
        stats: dict | None = {} if collect_stats else None

        def pre(x):
            mod, _ = self.modulation(vec, l.get("modulation", {}).get("lin"), lora_scale)
            x_mod = _modulate(x, mod).to(x.dtype)
            if stats is not None:
                stats["linear1"] = _absmax_in(x_mod)
            h = self.linear1(x_mod, l.get("linear1"), lora_scale)
            q, k, v = _split_heads(h[..., : 3 * self.hidden_size], self.num_heads)
            q, k = self.norm(q, k, v)
            if seg is not None:
                q, k = rope_qk(q, k, pe, rope_layout)
            return q, k, v, h, mod

        def post(x, attn, h, mod):
            mlp_h = h[..., 3 * self.hidden_size :]
            cat = torch.cat([attn, F.gelu(mlp_h, approximate="tanh")], dim=-1)
            if stats is not None:
                stats["linear2"] = _absmax_in(cat)
            out = self.linear2(cat, l.get("linear2"), lora_scale)
            return x + (mod["gate"] * out.to(torch.float32)).to(x.dtype)

        if seg is not None:
            pre, post = seg(pre), seg(post)
        q, k, v, h, mod = pre(x)
        attn = attention(q, k, v, None if seg is not None else pe, mask=attn_mask, rope_layout=rope_layout)
        out = post(x, attn, h, mod)
        return (out, stats) if collect_stats else out


class LastLayer(nn.Module):
    """adaLN (shift, scale) + linear."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h = cfg.hidden_size
        self.linear = Linear(h, cfg.out_channels)
        self.adaLN = Linear(h, 2 * h)

    def forward(self, x, vec, lora: Lora | None = None, lora_scale: float = 1.0):
        l = lora or {}
        mod = self.adaLN(F.silu(vec), l.get("adaLN"), lora_scale).to(torch.float32)
        shift, scale = mod.chunk(2, dim=-1)
        x = (1.0 + scale[:, None]) * layer_norm(x) + shift[:, None]
        return self.linear(x, l.get("linear"), lora_scale)

