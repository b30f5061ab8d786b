"""Weight-only quantization of the port (counterpart of visualcloze_tpu/models/quant.py).

The port's own copy of what single-card int8 serving needs:
  - int8 linears with one fp32 scale per output channel, symmetric absmax
    (`quantize_linear_int8`); in the DiT they run through kernel G
    (layers.Int8Linear), in CLIP as JAX's `clip._linear` does (weight and
    scale each cast to x's dtype, then multiplied: `DequantInt8Linear`);
  - int4 T5 block linears, two codes per uint8 along the input dimension,
    one fp32 scale per (128-row input group, output channel)
    (`quantize_weight_int4`), dequantized to x's dtype at each call
    (`Int4Linear`, JAX `t5._w`);
  - the int4 DiT (`quantize_flux_int4`, JAX's): every linear a
    layers.Int4DiTLinear of the same codes and scales, through kernel G4;
  - int8 token tables with one scale per row (`quantize_embedding_int8`),
    dequantized after the gather (`embedding_lookup`, `Int8Embedding`).
  - w8a8 DiT linears (`quantize_flux_w8a8`, JAX's quantize_flux_w8a8 and
    mark_w8a8): the token-dim block linears (flux.A8_KEYS) as
    layers.W8A8Linear, int8 weights K-major and int8 activations quantized
    per token at each call (`act_quant_int8`, kernels I and H), the other
    linears Int8Linear through G;
  - SmoothQuant (`smooth_scales`, `quantize_flux_w8a8_smooth`,
    `calibrate_flux_a8`): per-input-channel scales s from calibration
    absmax statistics, folded into the weights before quantizing, 1 / s
    (a_sinv) applied to the activations inside kernel I.
Rounding is half-to-even in both frameworks (jnp.round, torch.round), so the
codes and scales match the JAX package's bit for bit (the smooth weights up
to the last ulp of s: the two frameworks' pow differ there).

The model-level functions take and return modules. `quantize_*` build a new
quantized module beside the source one, one leaf at a time (the fp32
temporaries never exceed one weight); `init_*` draw random codes straight on
the device from a torch.Generator (uniform over the code range, like JAX's
random bits), so peak memory equals resident memory. Their leaves are named
as the JAX trees' entries, so convert.py carries either tree into the other's
module.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPTextConfig, FluxConfig, T5Config
from ..ops.act_quant import act_quant_int8 as _act_quant_kernel
from ..ops.int4_matmul import dequant_int4_plain
from .clip import CLIPTextEncoder, LayerNorm
from .flux import Flux, a8_linears, build_flux
from .init import materialize, normal_, swap_modules
from .layers import INT4_GROUP, Int4DiTLinear, Int8Linear, W8A8Linear
from .layers import int4_group as _int4_group_for
from .lora import tree_items, tree_replace
from .t5 import T5Encoder


# ----------------------------- arithmetic -----------------------------


def quantize_linear_int8(p: Mapping) -> dict:
    """{"w" (..., in, out), "b"?} -> {"w_int8", "w_scale" (..., out) fp32,
    "b"?}; symmetric absmax per output channel."""
    w = p["w"].to(torch.float32)
    amax = torch.clamp_min(w.abs().amax(dim=-2, keepdim=True), 1e-8)
    scale = amax / torch.full_like(amax, 127.0)  # a tensor divisor: on CUDA a scalar one is a reciprocal multiply
    out = {"w_int8": torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8),
           "w_scale": scale[..., 0, :]}
    if "b" in p:
        out["b"] = p["b"]
    return out


def dequantize_linear(p: Mapping, dtype: torch.dtype = torch.float32) -> dict:
    out = {"w": (p["w_int8"].to(torch.float32) * p["w_scale"][..., None, :]).to(dtype)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def act_quant_int8(x: torch.Tensor, a_sinv: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric absmax int8 (JAX act_quant_int8, with the w8a8
    branch's a_sinv product): x (..., in) -> (codes (..., in) int8, scale
    (..., 1) fp32), through kernel I (its plain version for CPU tensors)."""
    codes, scale = _act_quant_kernel(x.contiguous(), a_sinv)
    return codes.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


def smooth_scales(a_stat: torch.Tensor, weight: torch.Tensor, alpha: float = 0.5, eps: float = 1e-5) -> torch.Tensor:
    """SmoothQuant equalization scales s (in,) from an activation absmax
    a_stat (in,) and an nn.Linear weight (out, in): s = a^alpha /
    wmax^(1 - alpha), wmax the absmax of each input column, clipped to
    [1e-3, 1e3] (JAX smooth_scales, whose w is (in, out))."""
    a = torch.clamp_min(a_stat.to(torch.float32), eps)
    wmax = torch.clamp_min(weight.to(torch.float32).abs().amax(dim=0), eps)
    return torch.clamp(a.pow(alpha) / wmax.pow(1.0 - alpha), 1e-3, 1e3)


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP) -> dict:
    """w (..., in, out) -> {"w_int4": (..., in/2, out) uint8 (row 2i in the low
    nibble, 2i+1 in the high), "w_scale": (..., in/group, out) fp32}."""
    *lead, din, dout = w.shape
    if din % 2:
        raise ValueError(f"int4 packing needs an even input dim, got weight shape {tuple(w.shape)}")
    group = _int4_group_for(din, group)
    wf = w.to(torch.float32).reshape(*lead, din // group, group, dout)
    amax = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True), 1e-8)
    scale = amax / torch.full_like(amax, 7.0)  # a tensor divisor: on CUDA a scalar one is a reciprocal multiply
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int8).reshape(*lead, din, dout)
    lo = q[..., 0::2, :].to(torch.uint8) & 0xF
    hi = q[..., 1::2, :].to(torch.uint8) & 0xF
    return {"w_int4": (hi << 4) | lo, "w_scale": scale[..., 0, :].reshape(*lead, din // group, dout)}


def dequant_weight_int4(entry: Mapping, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """{"w_int4", "w_scale"} -> (..., in, out) in `dtype` (fp32 products, one rounding)."""
    return dequant_int4_plain(entry["w_int4"], entry["w_scale"], dtype)


def quantize_embedding_int8(emb: torch.Tensor) -> dict:
    """(V, d) table -> {"w_int8": (V, d) int8, "w_scale": (V, 1) fp32}: one
    symmetric scale per row."""
    ef = emb.to(torch.float32)
    scale = torch.clamp_min(ef.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    return {"w_int8": torch.clamp(torch.round(ef / scale), -127, 127).to(torch.int8), "w_scale": scale}


def embedding_lookup(emb, input_ids: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Rows of a plain (V, d) table, or of a {"w_int8", "w_scale"} table
    dequantized after the gather (rows, then scales, each cast to `dtype`)."""
    if isinstance(emb, Mapping):
        return emb["w_int8"][input_ids].to(dtype) * emb["w_scale"][input_ids].to(dtype)
    return F.embedding(input_ids, emb)


# ----------------------------- quantized modules -----------------------------


class Int8Embedding(nn.Module):
    """An int8 token table: buffers w_int8 (V, d) int8, w_scale (V, 1) fp32."""

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.register_buffer("w_int8", torch.empty((vocab_size, dim), dtype=torch.int8))
        self.register_buffer("w_scale", torch.empty((vocab_size, 1), dtype=torch.float32))

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return embedding_lookup({"w_int8": self.w_int8, "w_scale": self.w_scale}, input_ids)


class Int4Linear(nn.Module):
    """A bias-free int4 linear (T5): buffers w_int4 (in/2, out) uint8 and
    w_scale (in/group, out) fp32; y = x @ dequant(w) in x's dtype."""

    def __init__(self, in_features: int, out_features: int, group: int = INT4_GROUP):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.group = _int4_group_for(in_features, group)
        self.register_buffer("w_int4", torch.empty((in_features // 2, out_features), dtype=torch.uint8))
        self.register_buffer("w_scale", torch.empty((in_features // self.group, out_features), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, dequant_weight_int4({"w_int4": self.w_int4, "w_scale": self.w_scale}, x.dtype))


class DequantInt8Linear(nn.Module):
    """CLIP's int8 linear (JAX `clip._linear`): y = x @ (w_int8.to(x.dtype) *
    w_scale.to(x.dtype)) + b, plain PyTorch (a different rounding from kernel
    G's, and one 77-token pass per query)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_int8", torch.empty((in_features, out_features), dtype=torch.int8))
        self.register_buffer("w_scale", torch.empty((out_features,), dtype=torch.float32))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w_int8.to(x.dtype) * self.w_scale.to(x.dtype)
        return torch.matmul(x, w) + self.bias.to(x.dtype)


QUANTIZED_MODULES = (Int8Linear, Int4DiTLinear, W8A8Linear, DequantInt8Linear, Int4Linear, Int8Embedding)


def build_t5_int4(cfg: T5Config, device, dtype, int8_embed: bool, group: int = INT4_GROUP) -> T5Encoder:
    """An uninitialized T5 whose block linears are Int4Linear (and, with
    int8_embed, whose token table is an Int8Embedding); the rest in `dtype`."""

    def ctor():
        t5 = swap_modules(T5Encoder(cfg), nn.Linear, lambda m: Int4Linear(m.in_features, m.out_features, group))
        if int8_embed:  # a module in the parameter's place
            del t5.embed
            t5.embed = Int8Embedding(cfg.vocab_size, cfg.d_model)
        return t5

    return materialize(ctor, device, dtype)


def build_clip_int8(cfg: CLIPTextConfig, device, dtype, int8_embed: bool = True) -> CLIPTextEncoder:
    """An uninitialized CLIP with DequantInt8Linear block linears and (with
    int8_embed, as quantize_clip_int8 makes it) an int8 token table."""

    def ctor():
        clip = swap_modules(CLIPTextEncoder(cfg), nn.Linear, lambda m: DequantInt8Linear(m.in_features, m.out_features))
        if int8_embed:
            del clip.token_embed
            clip.token_embed = Int8Embedding(cfg.vocab_size, cfg.hidden_size)
        return clip

    return materialize(ctor, device, dtype)


@torch.no_grad()
def _quantized_copy(dst: nn.Module, src: nn.Module, smooth: dict | None = None, alpha: float = 0.5) -> nn.Module:
    """Fill the quantized module `dst` from the dense `src` of the same tree:
    every parameter copied by name, every quantized leaf quantized from the
    source's weight (one leaf at a time); smooth: {linear name: calibration
    stat} for the W8A8Linears with an a_sinv buffer (SmoothQuant), with
    `alpha`."""
    src_params, src_mods = dict(src.named_parameters()), dict(src.named_modules())
    for name, p in dst.named_parameters():
        p.copy_(src_params[name])
    for name, m in dst.named_modules():
        if not isinstance(m, QUANTIZED_MODULES):
            continue
        if isinstance(m, Int8Embedding):
            q = quantize_embedding_int8(src_params[name])
        elif isinstance(m, (Int4Linear, Int4DiTLinear)):
            q = quantize_weight_int4(src_mods[name].weight.t(), m.group)
        elif isinstance(m, W8A8Linear):
            q = _quantize_w8a8(src_mods[name].weight, smooth[name] if m.a_sinv is not None else None, alpha)
        else:
            q = quantize_linear_int8({"w": src_mods[name].weight.t()})
        for key, val in q.items():
            getattr(m, key).copy_(val)
    return dst


def _quantize_w8a8(weight: torch.Tensor, stat: torch.Tensor | None, alpha: float = 0.5) -> dict:
    """An nn.Linear weight (out, in) -> W8A8Linear's buffers: the codes of
    quantize_linear_int8 transposed to (out, in); with a calibration stat,
    the weight times s per input channel first, and a_sinv = 1 / s."""
    if stat is None:
        q = quantize_linear_int8({"w": weight.t()})
        return {"w_int8": q["w_int8"].t(), "w_scale": q["w_scale"]}
    s = smooth_scales(stat.to(weight.device), weight, alpha)
    q = quantize_linear_int8({"w": (weight.to(torch.float32) * s).t()})
    return {"w_int8": q["w_int8"].t(), "w_scale": q["w_scale"], "a_sinv": 1.0 / s}


def _dtype_of(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def quantize_flux_int8(flux: Flux) -> Flux:
    """A new Flux on flux's device with every linear int8 (Int8Linear);
    biases and norm scales keep their dtype. The source is left as it is."""
    dev = next(flux.parameters()).device
    return _quantized_copy(build_flux(flux.cfg, dev, _dtype_of(flux), int8=True), flux)


def quantize_flux_int4(flux: Flux) -> Flux:
    """A new Flux on flux's device with every linear int4 (Int4DiTLinear,
    JAX quantize_flux_int4: packed codes, one fp32 scale per (INT4_GROUP
    input rows, output channel), the group shrunk to divide small input
    dims); biases and norm scales keep their dtype. The source is left as
    it is."""
    dev = next(flux.parameters()).device
    return _quantized_copy(build_flux(flux.cfg, dev, _dtype_of(flux), int4=True), flux)


def quantize_flux_w8a8(flux: Flux) -> Flux:
    """A new w8a8 Flux on flux's device (JAX quantize_flux_w8a8): the
    token-dim block linears W8A8Linear (kernels I and H), every other linear
    Int8Linear (G); the source is left as it is."""
    dev = next(flux.parameters()).device
    return _quantized_copy(build_flux(flux.cfg, dev, _dtype_of(flux), w8a8=True), flux)


def quantize_flux_w8a8_smooth(flux: Flux, stats, alpha: float = 0.5) -> Flux:
    """quantize_flux_w8a8 with SmoothQuant equalization (JAX
    quantize_flux_w8a8_smooth): each w8a8 linear gets its weight times
    s = smooth_scales(stat, w, alpha) per input channel before quantizing,
    and a_sinv = 1 / s. `stats` is the tree of calibrate_flux_a8 /
    Flux(collect_a8_stats=True), whose dotted paths are the linears' names;
    it must hold every w8a8 linear (a calibration pass does)."""
    dev = next(flux.parameters()).device
    dst = build_flux(flux.cfg, dev, _dtype_of(flux), w8a8=True, smooth=True)
    smooth = dict(tree_items(stats))
    missing = [n for n, m in dst.named_modules() if isinstance(m, W8A8Linear) and n not in smooth]
    if missing:
        raise ValueError(f"no calibration statistics for the w8a8 linears {missing[:4]}")
    return _quantized_copy(dst, flux, smooth, alpha)


@torch.no_grad()
def mark_w8a8(flux: Flux) -> Flux:
    """An int8 Flux (every linear Int8Linear) -> the w8a8 Flux of the same
    codes (JAX mark_w8a8 on a quantize_flux_int8 tree): each a8_linears
    position becomes a W8A8Linear holding the codes transposed to (out, in).
    The other modules are moved, not copied."""
    for parent, name, m in list(a8_linears(flux)):
        if not isinstance(m, Int8Linear):
            raise ValueError(f"mark_w8a8 takes an int8 Flux, got {type(m).__name__} at {name}")
        with torch.device("meta"):
            new = W8A8Linear(m.in_features, m.out_features, m.bias is not None)
        new.w_int8 = m.w_int8.t().contiguous()
        new.w_scale = m.w_scale
        new.bias = m.bias
        setattr(parent, name, new.requires_grad_(False).eval())
    return flux


def merge_a8_stats(agg, stats):
    """The elementwise max of two calibration-statistics trees (agg None: stats)."""
    if agg is None:
        return stats
    new = dict(tree_items(stats))
    return tree_replace(agg, {p: torch.maximum(t, new[p]) for p, t in tree_items(agg)})


@torch.no_grad()
def calibrate_flux_a8(flux: Flux, batches, **forward_kw):
    """The elementwise max, over `batches` (each a dict of Flux.forward
    keyword arguments), of the unquantized model's w8a8-input statistics
    (JAX calibrate_flux_a8); kept on the model's device."""
    agg = None
    for b in batches:
        agg = merge_a8_stats(agg, flux(**b, **forward_kw, collect_a8_stats=True)[1])
    if agg is None:
        raise ValueError("calibrate_flux_a8 needs at least one batch")
    return agg


def quantize_t5_int4(t5: T5Encoder, group: int = INT4_GROUP, quantize_embed: bool = False) -> T5Encoder:
    """A new T5 with int4 block linears (and an int8 token table with
    quantize_embed); norms and the relative bias keep their dtype."""
    dev = next(t5.parameters()).device
    return _quantized_copy(build_t5_int4(t5.cfg, dev, _dtype_of(t5), quantize_embed, group), t5)


def quantize_clip_int8(clip: CLIPTextEncoder) -> CLIPTextEncoder:
    """A new CLIP with int8 block linears and an int8 token table."""
    dev = next(clip.parameters()).device
    return _quantized_copy(build_clip_int8(clip.cfg, dev, _dtype_of(clip)), clip)


@torch.no_grad()
def init_flux_int8(cfg: FluxConfig, device, generator: torch.Generator, seed_scale: float = 0.02) -> Flux:
    """Random int8 Flux built on the device (JAX init_flux_int8): codes
    uniform over [-128, 127], w_scale = seed_scale * d_in^-0.5 / 127, zero
    bf16 biases, unit q/k norm scales."""
    flux = build_flux(cfg, device, torch.bfloat16, int8=True)
    for m in flux.modules():
        if isinstance(m, Int8Linear):
            m.w_int8.random_(-128, 128, generator=generator)
            m.w_scale.fill_(seed_scale * m.in_features ** -0.5 / 127.0)
            if m.bias is not None:
                m.bias.zero_()
    for name, p in flux.named_parameters():
        if name.endswith(("q_scale", "k_scale")):
            p.fill_(1.0)
    return flux


def _random_int8_embedding(m: Int8Embedding, std: float, generator: torch.Generator) -> None:
    m.w_int8.random_(-128, 128, generator=generator)
    m.w_scale.fill_(std / 127.0)


@torch.no_grad()
def init_t5_int4(cfg: T5Config, device, generator: torch.Generator, quantize_embed: bool = True) -> T5Encoder:
    """Random int4 T5 built on the device (JAX init_t5_int4): packed codes
    uniform over all bytes, w_scale = std / 7 (std d_model^-0.5, or fan-in^-0.5
    for o and wo), an int8 token table of std 1 (or a bf16 N(0, 1) one),
    a bf16 N(0, 0.1) relative bias and unit norms."""
    t5 = build_t5_int4(cfg, device, torch.bfloat16, quantize_embed)
    d, kd, f = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    for blk in t5.blocks:
        for lin, std in ((blk.attn.q, d ** -0.5), (blk.attn.k, d ** -0.5), (blk.attn.v, d ** -0.5),
                         (blk.attn.o, kd ** -0.5), (blk.ffn.wi_0, d ** -0.5), (blk.ffn.wi_1, d ** -0.5),
                         (blk.ffn.wo, f ** -0.5)):
            lin.w_int4.random_(0, 256, generator=generator)
            lin.w_scale.fill_(std / 7.0)
        blk.attn.ln.fill_(1.0)
        blk.ffn.ln.fill_(1.0)
    if quantize_embed:
        _random_int8_embedding(t5.embed, 1.0, generator)
    else:
        normal_(t5.embed, 1.0, generator)
    normal_(t5.relative_attention_bias, 0.1, generator)
    t5.final_ln.fill_(1.0)
    return t5


@torch.no_grad()
def init_clip_int8(cfg: CLIPTextConfig, device, generator: torch.Generator) -> CLIPTextEncoder:
    """Random int8 CLIP built on the device (JAX init_clip_int8): codes
    uniform over [-128, 127], w_scale = d_in^-0.5 / 127, zero biases, an int8
    token table of std 0.02, a bf16 N(0, 0.01) position table, unit norms."""
    clip = build_clip_int8(cfg, device, torch.bfloat16)
    for m in clip.modules():
        if isinstance(m, DequantInt8Linear):
            m.w_int8.random_(-128, 128, generator=generator)
            m.w_scale.fill_(m.in_features ** -0.5 / 127.0)
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
    _random_int8_embedding(clip.token_embed, 0.02, generator)
    normal_(clip.pos_embed, 0.01, generator)
    return clip
