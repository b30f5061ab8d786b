"""FLUX transformer layers (counterpart of visualcloze_tpu/models/layers.py).

Precision policy, as in the JAX package: matmuls in the parameter dtype,
LayerNorm / RMSNorm / RoPE / softmax in fp32, modulation arithmetic in fp32
cast to the stream dtype at the residual add. Module and parameter names
mirror the JAX parameter tree so that convert.py maps one onto the other.
Only the dense (bf16/fp32) linear is ported; the int8/int4/w8a8 branches
and runtime LoRA wait for later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import FluxConfig
from ..ops.attention import attention


class Linear(nn.Linear):
    """y = x W^T + b with x cast to the weight dtype first (JAX `linear`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


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

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Modulation(nn.Module):
    """adaLN modulation: silu -> linear -> (shift, scale, gate) chunks in fp32
    with a length-1 sequence axis."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.mult = 6 if double else 3
        self.lin = Linear(dim, self.mult * dim)

    def forward(self, vec):
        out = self.lin(F.silu(vec)).to(torch.float32)[:, None, :]
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

    def _qkv(self, attn: SelfAttention, x, mod):
        q, k, v = _split_heads(attn.qkv(_modulate(x, mod)), self.num_heads)
        q, k = attn.norm(q, k, v)
        return q, k, v

    @staticmethod
    def _mlp(mlp: nn.ModuleDict, x, mod):
        h = F.gelu(mlp["0"](_modulate(x, mod)), approximate="tanh")
        return mlp["2"](h)

    def forward(self, img, txt, vec, pe, attn_mask):
        txt_len = txt.shape[1]
        img_mod1, img_mod2 = self.img_mod(vec)
        txt_mod1, txt_mod2 = self.txt_mod(vec)
        img_q, img_k, img_v = self._qkv(self.img_attn, img, img_mod1)
        txt_q, txt_k, txt_v = self._qkv(self.txt_attn, txt, txt_mod1)
        q = torch.cat([txt_q, img_q], dim=2)
        k = torch.cat([txt_k, img_k], dim=2)
        v = torch.cat([txt_v, img_v], dim=2)
        attn = attention(q, k, v, pe, mask=attn_mask)
        txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

        img = img + (img_mod1["gate"] * self.img_attn.proj(img_attn).to(torch.float32)).to(img.dtype)
        img = img + (img_mod2["gate"] * self._mlp(self.img_mlp, img, img_mod2).to(torch.float32)).to(img.dtype)
        txt = txt + (txt_mod1["gate"] * self.txt_attn.proj(txt_attn).to(torch.float32)).to(txt.dtype)
        txt = txt + (txt_mod2["gate"] * self._mlp(self.txt_mlp, txt, txt_mod2).to(torch.float32)).to(txt.dtype)
        return img, txt


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

    def forward(self, x, vec, pe, attn_mask):
        mod, _ = self.modulation(vec)
        x_mod = _modulate(x, mod).to(x.dtype)
        h = self.linear1(x_mod)
        q, k, v = _split_heads(h[..., : 3 * self.hidden_size], self.num_heads)
        q, k = self.norm(q, k, v)
        attn = attention(q, k, v, pe, mask=attn_mask)
        mlp_h = h[..., 3 * self.hidden_size :]
        out = self.linear2(torch.cat([attn, F.gelu(mlp_h, approximate="tanh")], dim=-1))
        return x + (mod["gate"] * out.to(torch.float32)).to(x.dtype)


class LastLayer(nn.Module):
    """adaLN (shift, scale) + linear."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        h = cfg.hidden_size
        self.linear = Linear(h, cfg.out_channels)
        self.adaLN = Linear(h, 2 * h)

    def forward(self, x, vec):
        shift, scale = self.adaLN(F.silu(vec)).to(torch.float32).chunk(2, dim=-1)
        x = (1.0 + scale[:, None]) * layer_norm(x) + shift[:, None]
        return self.linear(x)

